"""Dead-leaves source imagery on the device, the pool of uint8 source crops
that synthetic training draws from, and the seeded generators (a frozen
copy of the port's ``data/procedural.py``, dead leaves only).

Per image: a 4-colour palette and background; ``num_leaves`` anti-aliased
ellipses painted in order (power-law radii, palette colours with jitter and
a shading gradient); a multi-octave noise texture; a global illumination
ramp; a random 5-tap Gaussian blur; clip to [0, 1].
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

from benchmark.reference.camera import normal, uniform
from benchmark.reference.interp import resize_bilinear

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
    """Draws of several image batches joined into one batch (list-valued
    draws, the octave fields, joined per entry)."""
    return {k: [torch.cat(o) for o in zip(*(p[k] for p in parts))]
            if isinstance(v, list) else torch.cat([p[k] for p in parts])
            for k, v in parts[0].items()}


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


def render_pool(pool_size: int, hw: Tuple[int, int], seed: int,
                round_idx: int, device, chunk: int = 32,
                num_leaves: int = 300) -> torch.Tensor:
    """The uint8 dead-leaves pool ``[pool_size, H, W, 3]`` of round
    ``round_idx`` (an epoch): image ``i`` drawn from its own ``(seed,
    round_idx, i)`` stream, rendered ``chunk`` images at a time."""
    pool = torch.empty((pool_size,) + tuple(hw) + (3,), dtype=torch.uint8,
                       device=device)
    for lo in range(0, pool_size, chunk):
        draws = concat_draws([dead_leaves_draws(
            make_generator(device, seed, round_idx, i), 1,
            num_leaves=num_leaves)
            for i in range(lo, min(lo + chunk, pool_size))])
        img = dead_leaves_from_draws(draws, hw)
        pool[lo:lo + img.shape[0]] = (img * 255.0 + 0.5).to(torch.uint8)
    return pool


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
