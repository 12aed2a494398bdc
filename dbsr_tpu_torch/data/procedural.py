"""Procedural source imagery on the device: the dead-leaves image model and
the pool of uint8 source crops that synthetic training draws from, and the
image dataset that val-set generation draws from (port of
``dbsr_tpu/data/procedural.py:49-151,306-448``, dead-leaves mix only).

Per image: a 4-colour palette and background; ``num_leaves`` anti-aliased
ellipses painted in order (power-law radii, palette colours with jitter and
a shading gradient); a multi-octave noise texture; a global illumination
ramp; a random 5-tap Gaussian blur; clip to [0, 1]. Images are rendered as
a batch on the device. The random draws (``dead_leaves_draws``) are
separate from the rendering (``dead_leaves_from_draws``), so a test can
feed the JAX package's own draws; likewise the pool's crop draws
(``draw_crops``) from ``crops_from_draws``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from dbsr_tpu_torch.ops.camera import normal, uniform
from dbsr_tpu_torch.ops.interp import resize_bilinear

OCTAVE_BASES = (7, 14, 28, 56, 112)
# the dead-leaves model's constants (the JAX package's defaults, which no
# caller there changes)
PALETTE_SIZE = 4
SIGMA_RANGE = (0.2, 1.1)
RMIN, RMAX_FRAC = 4.0, 0.45
COLOR_JITTER, GRAD_AMP, TEXTURE_AMP, ILLUM_AMP = 0.12, 0.35, 0.10, 0.15


def octave_noise(coarse: Sequence[torch.Tensor], hw: Tuple[int, int],
                 decay: float = 0.55) -> torch.Tensor:
    """Multi-octave noise in [0, 1] ``[n, H, W, C]`` from the coarse uniform
    fields of each octave (``[n, base, base, C]``), bilinearly upsampled and
    summed with amplitudes ``decay**octave``, normalised."""
    img = torch.zeros((coarse[0].shape[0],) + tuple(hw)
                      + (coarse[0].shape[-1],), device=coarse[0].device)
    amp, total = 1.0, 0.0
    for c in coarse:
        img = img + amp * resize_bilinear(c, hw)
        total += amp
        amp *= decay
    return img / total


def gaussian_blur(img: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap Gaussian blur of ``[n, H, W, C]`` with per-image
    ``sigma`` ``[n]``, zero ``SAME`` padding, as explicit shifted sums."""
    x = torch.arange(-2, 3, dtype=torch.float32, device=img.device)
    g = torch.exp(-0.5 * (x / sigma[:, None]) ** 2)
    g = g / g.sum(dim=-1, keepdim=True)                      # [n, 5]
    H, W = img.shape[1], img.shape[2]
    for axis, size in ((1, H), (2, W)):
        pad = [0, 0] * (img.ndim - 1 - axis) + [2, 2]
        xp = torch.nn.functional.pad(img, pad)
        shape = (-1,) + (1,) * (img.ndim - 1)
        out = None
        for k in range(5):
            term = g[:, k].reshape(shape) * xp.narrow(axis, k, size)
            out = term if out is None else out + term
        img = out
    return img


def dead_leaves_draws(generator: torch.Generator, n: int,
                      num_leaves: int = 300) -> Dict[str, object]:
    """The random values of ``n`` dead-leaves images, on the generator's
    device."""
    return {
        "palette": uniform(generator, (n, PALETTE_SIZE, 3), 0.05, 0.95),
        "bg_normal": normal(generator, (n, 3)),
        "leaf_u": uniform(generator, (n, num_leaves, 8)),
        "leaf_color_normal": normal(generator, (n, num_leaves, 3)),
        "leaf_grad": normal(generator, (n, num_leaves, 2)),
        "octaves": [uniform(generator, (n, b, b, 3)) for b in OCTAVE_BASES],
        "illum_dir": normal(generator, (n, 2)),
        "illum_u": uniform(generator, (n,)),
        "sigma": uniform(generator, (n,), *SIGMA_RANGE),
    }


def dead_leaves_from_draws(draws: Dict[str, object],
                           hw: Tuple[int, int]) -> torch.Tensor:
    """Render ``[n, H, W, 3]`` float32 images in [0, 1] from their draws."""
    H, W = hw
    palette = draws["palette"]
    n, palette_size = palette.shape[:2]
    dev = palette.device
    bg = (palette[:, 0] + COLOR_JITTER * draws["bg_normal"]).clamp(0.0, 1.0)
    img = bg[:, None, None, :].expand(n, H, W, 3)

    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    rmax = RMAX_FRAC * min(H, W)
    ratio2 = (RMIN / rmax) ** 2
    rows = torch.arange(n, device=dev)

    def col(v):  # per-image scalar [n] -> [n, 1, 1]
        return v[:, None, None]

    for i in range(draws["leaf_u"].shape[1]):
        u = draws["leaf_u"][:, i]
        r = RMIN * torch.rsqrt(1.0 - u[:, 0] * (1.0 - ratio2))
        cx = u[:, 1] * (W - 1)
        cy = u[:, 2] * (H - 1)
        theta = u[:, 3] * (2.0 * math.pi)
        a = torch.exp((u[:, 4] - 0.5) * 0.81)
        pj = (u[:, 5] * palette_size).to(torch.int64)
        color = (palette[rows, pj] + COLOR_JITTER
                 * draws["leaf_color_normal"][:, i]).clamp(0.0, 1.0)
        gx, gy = draws["leaf_grad"][:, i, 0], draws["leaf_grad"][:, i, 1]

        ct, st = col(torch.cos(theta)), col(torch.sin(theta))
        dx = xs - col(cx)
        dy = ys - col(cy)
        xr = (ct * dx + st * dy) * col(a)
        yr = (-st * dx + ct * dy) / col(a)
        d = torch.sqrt(xr * xr + yr * yr + 1e-8)
        cover = (0.5 + (col(r) - d)).clamp(0.0, 1.0)
        shade = 1.0 + GRAD_AMP * (col(gx) * xr + col(gy) * yr) / col(r)
        c = color[:, None, None, :] * shade[..., None]
        img = img * (1.0 - cover[..., None]) + c * cover[..., None]

    img = img + TEXTURE_AMP * (octave_noise(draws["octaves"], hw) - 0.5)

    gdir = draws["illum_dir"]
    gdir = gdir / torch.sqrt((gdir * gdir).sum(dim=-1, keepdim=True) + 1e-8)
    amp = ILLUM_AMP * draws["illum_u"]
    ramp = (col(gdir[:, 0]) * (xs / W - 0.5) + col(gdir[:, 1]) * (ys / H - 0.5))
    img = img * (1.0 + col(amp)[..., None] * ramp[..., None])

    img = gaussian_blur(img, draws["sigma"])
    return img.clamp(0.0, 1.0)


def concat_draws(parts: Sequence[Dict[str, object]]) -> Dict[str, object]:
    """Draws of several image batches joined into one batch."""
    out = {k: torch.cat([p[k] for p in parts]) for k in parts[0]
           if k != "octaves"}
    out["octaves"] = [torch.cat(o) for o in zip(*(p["octaves"]
                                                  for p in parts))]
    return out


def dead_leaves_image(generator: torch.Generator, n: int,
                      hw: Tuple[int, int],
                      num_leaves: int = 300) -> torch.Tensor:
    """``n`` procedural source images ``[n, H, W, 3]`` on the generator's
    device."""
    return dead_leaves_from_draws(
        dead_leaves_draws(generator, n, num_leaves=num_leaves), hw)


def _stream_seed(*parts: int) -> int:
    """A deterministic 63-bit seed from integers (an odd-multiplier mix,
    the port's counterpart of folding a JAX key)."""
    h = 0x9E3779B97F4A7C15
    for p in parts:
        h = ((h ^ (int(p) & 0xFFFFFFFFFFFFFFFF)) * 0xBF58476D1CE4E5B9
             + 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return h & 0x7FFFFFFFFFFFFFFF


def make_generator(device, *parts: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``parts``."""
    g = torch.Generator(device=device)
    g.manual_seed(_stream_seed(*parts))
    return g


class ProceduralImagePool:
    """Device-resident pool of uint8 dead-leaves source crops
    ``[pool_size, H, W, 3]``, regenerated per round (epoch); image ``i``
    of round ``r`` is drawn from ``(seed, r, i)``."""

    def __init__(self, pool_size: int, hw: Tuple[int, int], seed: int = 0,
                 chunk: int = 32, device="cuda", num_leaves: int = 300):
        self.pool_size = pool_size
        self.hw = tuple(hw)
        self.seed = seed
        self.chunk = chunk
        self.device = torch.device(device)
        self.num_leaves = num_leaves
        self._round = None
        self.pool: Optional[torch.Tensor] = None

    def refresh(self, round_idx: int) -> torch.Tensor:
        """(Re)generate the pool for ``round_idx``; idempotent per round.
        Chunked to bound the rendering's memory."""
        if self._round == round_idx and self.pool is not None:
            return self.pool
        pool = torch.empty((self.pool_size,) + self.hw + (3,),
                           dtype=torch.uint8, device=self.device)
        for lo in range(0, self.pool_size, self.chunk):
            # image i draws from its own (seed, round, i) stream, so the
            # pool does not depend on the chunking
            draws = concat_draws([dead_leaves_draws(
                make_generator(self.device, self.seed, round_idx, i), 1,
                num_leaves=self.num_leaves)
                for i in range(lo, min(lo + self.chunk, self.pool_size))])
            img = dead_leaves_from_draws(draws, self.hw)
            pool[lo:lo + img.shape[0]] = (img * 255.0 + 0.5).to(torch.uint8)
        self.pool = pool
        self._round = round_idx
        return pool


class ProceduralPoolBatcher:
    """Loader of a ``ProceduralImagePool``: ``next_batch()`` returns the
    pool itself, refreshed every ``num_batches`` calls (once per epoch);
    the per-step crop draw and synthesis run in ``make_pool_prepare_fn``."""

    def __init__(self, pool: ProceduralImagePool, batch_size: int,
                 num_batches: int):
        self.pool = pool
        self.batch_size = batch_size
        self.num_batches = num_batches
        self._calls = 0

    def __len__(self):
        return self.num_batches

    def next_batch(self) -> torch.Tensor:
        epoch_round = self._calls // self.num_batches
        self._calls += 1
        return self.pool.refresh(epoch_round)


def draw_crops(generator: torch.Generator, batch_size: int,
               pool_size: int) -> Dict[str, torch.Tensor]:
    """Pool indices ``[B]`` and horizontal-flip flags ``[B]``."""
    dev = generator.device
    return {"idx": torch.randint(0, pool_size, (batch_size,),
                                 generator=generator, device=dev),
            "flip": torch.rand((batch_size,), generator=generator,
                               device=dev) < 0.5}


def crops_from_draws(pool: torch.Tensor,
                     draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """uint8 pool rows -> float32 crops in [0, 1], flipped along W where
    drawn."""
    crops = pool[draws["idx"]].float() / 255.0
    flip = draws["flip"][:, None, None, None]
    return torch.where(flip, torch.flip(crops, dims=[2]), crops)


def make_pool_prepare_fn(cfg, batch_size: int) -> Callable:
    """``prepare(generator, pool) -> batch``: ``batch_size`` random pool
    crops (uint8 -> f32/255), a random horizontal flip, then burst synthesis
    (``synthesize_batch`` with ``cfg``)."""
    from dbsr_tpu_torch.data.synthetic import synthesize_batch

    def prepare(generator, pool):
        draws = draw_crops(generator, batch_size, pool.shape[0])
        return synthesize_batch(generator, crops_from_draws(pool, draws), cfg)

    return prepare



class ProceduralImages:
    """Dataset of dead-leaves source images with the ``get_image`` contract
    of an image folder, for val-set generation: image ``idx`` is image
    ``idx`` of round 0 of a :class:`ProceduralImagePool` (its own
    ``(seed, 0, idx)`` stream, rendered on ``device`` in chunks at first
    use), returned as uint8 ``[H, W, 3]`` numpy."""

    def __init__(self, num_images: int, hw: Tuple[int, int] = (448, 448),
                 seed: int = 0, device="cuda", num_leaves: int = 300):
        self.pool = ProceduralImagePool(num_images, hw, seed=seed,
                                        device=device, num_leaves=num_leaves)

    def get_num_images(self) -> int:
        return self.pool.pool_size

    def __len__(self):
        return self.pool.pool_size

    def get_image(self, idx: int):
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        return self.pool.refresh(0)[idx].cpu().numpy(), {}
