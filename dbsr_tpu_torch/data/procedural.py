"""Procedural source imagery on the device: the dead-leaves image model, the
four generators of the mixed corpus, the pool of uint8 source crops that
synthetic training draws from, and the image dataset that val-set
generation draws from (port of ``dbsr_tpu/data/procedural.py``).

Per image: a 4-colour palette and background; ``num_leaves`` anti-aliased
ellipses painted in order (power-law radii, palette colours with jitter and
a shading gradient; ``ops.dead_leaves`` paints them, from the leaf table
``dead_leaves_table`` computes); a multi-octave noise texture; a global illumination
ramp; a random 5-tap Gaussian blur; clip to [0, 1]. Images are rendered as
a batch on the device. The random draws (``dead_leaves_draws``) are
separate from the rendering (``dead_leaves_from_draws``), so a test can
feed the JAX package's own draws; likewise the pool's crop draws
(``draw_crops``) from ``crops_from_draws``.

The mixed corpus (``mix='mixed'``) adds hard edges (rotated bars and
strokes), near-Nyquist gratings, smooth gradient fields and full-band noise
texture in the ``MIXED_RECIPE`` proportions, one generator per chunk of the
pool (``_mix_plan``, the JAX package's numpy plan). Their transcendental
functions (``_f32``) are evaluated in float64 and rounded once to float32,
the same value on every device, so the card's rendering stays within a
few float32 roundings of the CPU's.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dbsr_tpu_torch.ops.camera import normal, uniform
from dbsr_tpu_torch.ops.dead_leaves import dead_leaves_composite
from dbsr_tpu_torch.ops.interp import resize_bilinear

OCTAVE_BASES = (7, 14, 28, 56, 112)
# the dead-leaves model's constants (the JAX package's defaults, which no
# caller there changes)
PALETTE_SIZE = 4
SIGMA_RANGE = (0.2, 1.1)
RMIN, RMAX_FRAC = 4.0, 0.45
COLOR_JITTER, TEXTURE_AMP, ILLUM_AMP = 0.12, 0.10, 0.15
# the mixed corpus' generators (the JAX package's defaults)
NUM_SHAPES, EDGES_SIGMA = 120, (0.15, 0.7)
NUM_COMPONENTS, GRATINGS_SIGMA = 3, (0.15, 0.5)
GRADIENT_BASES, GRADIENT_DECAY = (2, 3, 5), 0.7
NOISE_BASES, NOISE_DECAY, NOISE_SIGMA = (7, 14, 28, 56, 112, 224), 0.65, \
    (0.2, 0.9)


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


def dead_leaves_table(draws: Dict[str, object], hw: Tuple[int, int]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backgrounds ``[n, 3]`` and the leaf table ``[n, L, 11]``
    (columns ``ops.dead_leaves.LEAF_PARAMS``) of dead-leaves images from
    their draws: every leaf's parameters in one pass, by the elementwise
    expressions of the JAX package's leaf loop."""
    H, W = hw
    palette = draws["palette"]
    n, palette_size = palette.shape[:2]
    bg = (palette[:, 0] + COLOR_JITTER * draws["bg_normal"]).clamp(0.0, 1.0)
    rmax = RMAX_FRAC * min(H, W)
    ratio2 = (RMIN / rmax) ** 2
    u = draws["leaf_u"]
    r = RMIN * torch.rsqrt(1.0 - u[..., 0] * (1.0 - ratio2))
    cx = u[..., 1] * (W - 1)
    cy = u[..., 2] * (H - 1)
    theta = u[..., 3] * (2.0 * math.pi)
    a = torch.exp((u[..., 4] - 0.5) * 0.81)
    pj = (u[..., 5] * palette_size).to(torch.int64)
    rows = torch.arange(n, device=palette.device)[:, None]
    color = (palette[rows, pj] + COLOR_JITTER
             * draws["leaf_color_normal"]).clamp(0.0, 1.0)
    table = torch.cat([torch.stack([r, cx, cy, torch.cos(theta),
                                    torch.sin(theta), a], dim=-1),
                       color, draws["leaf_grad"]], dim=-1)
    return bg, table


def dead_leaves_from_draws(draws: Dict[str, object],
                           hw: Tuple[int, int]) -> torch.Tensor:
    """Render ``[n, H, W, 3]`` float32 images in [0, 1] from their draws."""
    H, W = hw
    img = dead_leaves_composite(*dead_leaves_table(draws, hw), hw)
    ys, xs = _grid(hw, img.device)

    def col(v):  # per-image scalar [n] -> [n, 1, 1]
        return v[:, None, None]

    img = img + TEXTURE_AMP * (octave_noise(draws["octaves"], hw) - 0.5)

    gdir = draws["illum_dir"]
    gdir = gdir / torch.sqrt((gdir * gdir).sum(dim=-1, keepdim=True) + 1e-8)
    amp = ILLUM_AMP * draws["illum_u"]
    ramp = (col(gdir[:, 0]) * (xs / W - 0.5) + col(gdir[:, 1]) * (ys / H - 0.5))
    img = img * (1.0 + col(amp)[..., None] * ramp[..., None])

    img = gaussian_blur(img, draws["sigma"])
    return img.clamp(0.0, 1.0)


def concat_draws(parts: Sequence[Dict[str, object]]) -> Dict[str, object]:
    """Draws of several image batches joined into one batch (list-valued
    draws, the octave fields, joined per entry)."""
    return {k: [torch.cat(o) for o in zip(*(p[k] for p in parts))]
            if isinstance(v, list) else torch.cat([p[k] for p in parts])
            for k, v in parts[0].items()}


def _f32(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of float32 ``x`` in float64, rounded once to float32: the same
    bits on every device (float32 sin, cos, exp and pow differ in the last
    place between the CPU's and the card's libraries)."""
    return fn(x.double()).float()


def _log32(v: float) -> float:
    """``log(float32(v))`` rounded to float32, as XLA folds ``jnp.log`` of a
    Python number."""
    return float(np.float32(np.log(np.float64(np.float32(v)))))


def _grid(hw: Tuple[int, int], device):
    H, W = hw
    return (torch.arange(H, dtype=torch.float32, device=device)[:, None],
            torch.arange(W, dtype=torch.float32, device=device)[None, :])


def _col(v: torch.Tensor) -> torch.Tensor:
    """Per-image ``[n, ...]`` -> ``[n, 1, 1, ...]`` against ``[H, W]``."""
    return v.reshape(v.shape[:1] + (1, 1) + v.shape[1:])


def _unit_dir(d: torch.Tensor) -> torch.Tensor:
    return d / torch.sqrt((d * d).sum(dim=-1, keepdim=True) + 1e-8)


def hard_edges_draws(generator: torch.Generator, n: int,
                     num_shapes: int = NUM_SHAPES) -> Dict[str, object]:
    """The random values of ``n`` hard-edges images."""
    return {"bg": uniform(generator, (n, 3)),
            "shape_u": uniform(generator, (n, num_shapes, 9)),
            "shape_color": uniform(generator, (n, num_shapes, 3)),
            "sigma": uniform(generator, (n,), *EDGES_SIGMA)}


def hard_edges_from_draws(draws: Dict[str, object],
                          hw: Tuple[int, int]) -> torch.Tensor:
    """High-contrast rotated rectangles, bars and thin strokes painted in
    order on a uniform background (half-extents log-uniform from 1 px to
    W/6 and from 0.7 px to H/24; half the shapes' colours pushed to the
    rails), then a random blur: ``[n, H, W, 3]`` in [0, 1]
    (``dbsr_tpu/data/procedural.py:154``)."""
    H, W = hw
    bg = draws["bg"]
    n = bg.shape[0]
    img = _col(bg).expand(n, H, W, 3)
    ys, xs = _grid(hw, bg.device)
    log_hx, log_hy0, log_hy = _log32(W / 6.0), _log32(0.7), _log32(H / 24.0)
    for i in range(draws["shape_u"].shape[1]):
        u = draws["shape_u"][:, i]
        cx = _col(u[:, 0] * (W - 1))
        cy = _col(u[:, 1] * (H - 1))
        theta = u[:, 2] * math.pi
        hx = _col(_f32(torch.exp, 0.0 + u[:, 3] * log_hx))
        hy = _col(_f32(torch.exp, log_hy0 + u[:, 4] * log_hy))
        color = draws["shape_color"][:, i]
        color = torch.where(u[:, 5:6] < 0.5, (color > 0.5).float(), color)
        ct, st = _col(_f32(torch.cos, theta)), _col(_f32(torch.sin, theta))
        dx = xs - cx
        dy = ys - cy
        xr = ct * dx + st * dy
        yr = -st * dx + ct * dy
        cover = ((0.5 + (hx - xr.abs())).clamp(0.0, 1.0)
                 * (0.5 + (hy - yr.abs())).clamp(0.0, 1.0))[..., None]
        img = img * (1.0 - cover) + _col(color) * cover
    img = gaussian_blur(img, draws["sigma"])
    return img.clamp(0.0, 1.0)


def gratings_draws(generator: torch.Generator, n: int,
                   num_components: int = NUM_COMPONENTS) -> Dict[str, object]:
    """The random values of ``n`` gratings images."""
    return {"dc": uniform(generator, (n, 3), 0.25, 0.75),
            "comp_u": uniform(generator, (n, num_components, 6)),
            "comp_color": uniform(generator, (n, num_components, 3), -1.0,
                                  1.0),
            "sigma": uniform(generator, (n,), *GRATINGS_SIGMA)}


def gratings_from_draws(draws: Dict[str, object],
                        hw: Tuple[int, int]) -> torch.Tensor:
    """Oriented sinusoidal gratings (frequencies log-uniform in [1/64, 0.45]
    cycles/px, up to near Nyquist) under Gaussian envelopes on a grey
    level, then a random blur: ``[n, H, W, 3]`` in [0, 1]
    (``dbsr_tpu/data/procedural.py:199``)."""
    H, W = hw
    dc = draws["dc"]
    n = dc.shape[0]
    img = _col(dc).expand(n, H, W, 3)
    ys, xs = _grid(hw, dc.device)
    log_lo = _log32(1.0 / 64.0)
    log_span = float(np.float32(_log32(0.45) - log_lo))
    for i in range(draws["comp_u"].shape[1]):
        u = draws["comp_u"][:, i]
        theta = u[:, 0] * math.pi
        freq = _f32(torch.exp, log_lo + u[:, 1] * log_span)
        phase = _col(u[:, 2] * (2.0 * math.pi))
        amp = _col(0.08 + 0.22 * u[:, 3])
        ct, st = _col(_f32(torch.cos, theta)), _col(_f32(torch.sin, theta))
        wave = _f32(torch.sin, _col(2.0 * math.pi * freq)
                    * (ct * xs + st * ys) + phase)
        ex = (xs - _col(u[:, 4] * (W - 1))) / (0.45 * W)
        ey = (ys - _col(u[:, 5] * (H - 1))) / (0.45 * H)
        env = _f32(torch.exp, -(ex * ex + ey * ey))
        img = img + amp[..., None] * (wave * env)[..., None] \
            * _col(draws["comp_color"][:, i])
    img = gaussian_blur(img, draws["sigma"])
    return img.clamp(0.0, 1.0)


def smooth_gradients_draws(generator: torch.Generator,
                           n: int) -> Dict[str, object]:
    """The random values of ``n`` smooth-gradient images."""
    return {"octaves": [uniform(generator, (n, b, b, 3))
                        for b in GRADIENT_BASES],
            "illum_dir": normal(generator, (n, 2)),
            "gamma_u": uniform(generator, (n, 3), -0.5, 0.5)}


def smooth_gradients_from_draws(draws: Dict[str, object],
                                hw: Tuple[int, int]) -> torch.Tensor:
    """Very low-frequency content: coarse octave noise (bases 2, 3, 5),
    an illumination ramp and a random per-channel gamma: ``[n, H, W, 3]``
    in [0, 1] (``dbsr_tpu/data/procedural.py:237``)."""
    H, W = hw
    img = octave_noise(draws["octaves"], hw, decay=GRADIENT_DECAY)
    ys, xs = _grid(hw, img.device)
    gdir = _unit_dir(draws["illum_dir"])
    ramp = (_col(gdir[:, 0]) * (xs / W - 0.5)
            + _col(gdir[:, 1]) * (ys / H - 0.5))
    img = img * (1.0 + 0.4 * ramp[..., None])
    gamma = _col(_f32(torch.exp, draws["gamma_u"]))
    return _f32(lambda x: x ** gamma.double(),
                img.clamp(0.0, 1.0)).clamp(0.0, 1.0)


def noise_texture_draws(generator: torch.Generator,
                        n: int) -> Dict[str, object]:
    """The random values of ``n`` noise-texture images."""
    return {"octaves": [uniform(generator, (n, b, b, 3))
                        for b in NOISE_BASES],
            "contrast": uniform(generator, (n,), 0.6, 1.6),
            "sigma": uniform(generator, (n,), *NOISE_SIGMA)}


def noise_texture_from_draws(draws: Dict[str, object],
                             hw: Tuple[int, int]) -> torch.Tensor:
    """Full-band multi-octave texture (bases 7 to 224) at a random
    contrast, then a random blur: ``[n, H, W, 3]`` in [0, 1]
    (``dbsr_tpu/data/procedural.py:256``)."""
    img = octave_noise(draws["octaves"], hw, decay=NOISE_DECAY)
    img = 0.5 + (img - 0.5) * _col(draws["contrast"])[..., None]
    img = gaussian_blur(img, draws["sigma"])
    return img.clamp(0.0, 1.0)


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


# Mixed-corpus recipe: generator -> share of the pool (dead leaves the
# backbone; the rest add straight step edges, aliasing-band gratings, smooth
# fields and full-band texture)
MIXED_RECIPE = (
    ("dead_leaves", 0.45),
    ("edges", 0.20),
    ("gratings", 0.15),
    ("noise", 0.10),
    ("gradients", 0.10),
)

# name -> (draws(generator, n), from_draws(draws, hw))
GENERATORS = {
    "dead_leaves": (dead_leaves_draws, dead_leaves_from_draws),
    "edges": (hard_edges_draws, hard_edges_from_draws),
    "gratings": (gratings_draws, gratings_from_draws),
    "noise": (noise_texture_draws, noise_texture_from_draws),
    "gradients": (smooth_gradients_draws, smooth_gradients_from_draws),
}


def _mix_plan(n_chunks: int, seed: int, recipe=MIXED_RECIPE):
    """Deterministic per-chunk generator assignment matching the recipe
    proportions (shuffled so pool position carries no type information)."""
    names = []
    for name, frac in recipe:
        names += [name] * max(1, round(frac * n_chunks))
    names = names[:n_chunks]
    while len(names) < n_chunks:
        names.append(recipe[0][0])
    rng = np.random.RandomState(seed ^ 0x5EED)
    rng.shuffle(names)
    return names


class ProceduralImagePool:
    """Device-resident pool of uint8 procedural source crops
    ``[pool_size, H, W, 3]``, regenerated per round (epoch); image ``i``
    of round ``r`` is drawn from ``(seed, r, i)``. ``mix='mixed'`` renders
    chunk ``c`` of round ``r`` with generator ``_mix_plan(n_chunks, seed +
    r)[c]``; any other ``mix`` is dead leaves throughout."""

    def __init__(self, pool_size: int, hw: Tuple[int, int], seed: int = 0,
                 chunk: int = 32, device="cuda", num_leaves: int = 300,
                 mix: str = "deadleaves"):
        self.pool_size = pool_size
        self.hw = tuple(hw)
        self.seed = seed
        self.chunk = chunk
        self.device = torch.device(device)
        self.num_leaves = num_leaves
        self.mix = mix
        self._round = None
        self.pool: Optional[torch.Tensor] = None

    def fold_in_process(self, process_index: int) -> None:
        """Decorrelate the pools of data-parallel nodes: the JAX package's
        seed arithmetic (``CropBatcher.fold_in_process``'s contract)."""
        self.seed = self.seed * 1000003 + 7919 * (process_index + 1)
        self._round = None

    def plan(self, round_idx: int):
        """The generator of each chunk of round ``round_idx``."""
        n_chunks = -(-self.pool_size // self.chunk)
        if self.mix == "mixed":
            return _mix_plan(n_chunks, self.seed + round_idx)
        return ["dead_leaves"] * n_chunks

    def refresh(self, round_idx: int) -> torch.Tensor:
        """(Re)generate the pool for ``round_idx``; idempotent per round.
        Chunked to bound the rendering's memory."""
        if self._round == round_idx and self.pool is not None:
            return self.pool
        pool = torch.empty((self.pool_size,) + self.hw + (3,),
                           dtype=torch.uint8, device=self.device)
        for c, name in enumerate(self.plan(round_idx)):
            lo = c * self.chunk
            draw, render = GENERATORS[name]
            kw = {"num_leaves": self.num_leaves} \
                if name == "dead_leaves" else {}
            # image i draws from its own (seed, round, i) stream, so the
            # dead-leaves pool does not depend on the chunking
            draws = concat_draws([draw(
                make_generator(self.device, self.seed, round_idx, i), 1,
                **kw) for i in range(lo, min(lo + self.chunk,
                                             self.pool_size))])
            img = render(draws, self.hw)
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

    def fold_in_process(self, process_index: int) -> None:
        self.pool.fold_in_process(process_index)

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
    (``synthesize_batch`` with ``cfg``). Under data parallelism every rank
    draws the crops and the synthesis of the whole ``batch_size`` and makes
    its rows only (``multihost.local_rows``)."""
    from dbsr_tpu_torch.data.synthetic import (rgb2rawburst_from_draws,
                                               sample_draws)
    from dbsr_tpu_torch.parallel.multihost import local_rows

    def prepare(generator, pool):
        crops = draw_crops(generator, batch_size, pool.shape[0])
        draws = sample_draws(generator, batch_size, cfg)
        crops, draws = local_rows((crops, draws), batch_size)
        return rgb2rawburst_from_draws(crops_from_draws(pool, crops), draws,
                                       cfg)

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
