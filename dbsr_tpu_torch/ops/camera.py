"""Camera-pipeline ops (port of ``dbsr_tpu/ops/camera.py:62-233``): the
inverse ISP and noise model of burst synthesis, and ``demosaic_naive``.

Images are channels-last ``[..., H, W, C]``. Per-sample parameters
(CCMs ``[..., 3, 3]``, gains and noise levels ``[...]``) broadcast over the
image's leading dims. Each random sampler is split into a *draw* (the
values ``jax.random`` returns in the JAX package, drawn here from an
explicit ``torch.Generator`` on the tensors' device) and an *apply*
(``..._from_draws``), so a test can feed the JAX package's own draws.
Colour math is elementwise float32 (no matmul, hence no TF32 on the card).
"""

from __future__ import annotations

import math

import torch

# Four fixed XYZ -> camera CCMs (reference data/camera_pipeline.py:30-41).
XYZ2CAMS = (
    ((1.0234, -0.2969, -0.2266), (-0.5625, 1.6328, -0.0469),
     (-0.0703, 0.2188, 0.6406)),
    ((0.4913, -0.0541, -0.0202), (-0.613, 1.3513, 0.2906),
     (-0.1564, 0.2151, 0.7183)),
    ((0.838, -0.263, -0.0639), (-0.2887, 1.0725, 0.2496),
     (-0.0627, 0.1427, 0.5438)),
    ((0.6596, -0.2079, -0.0562), (-0.4782, 1.3016, 0.1933),
     (-0.097, 0.1581, 0.5181)),
)
# sRGB -> XYZ (D65)
RGB2XYZ = ((0.4124564, 0.3575761, 0.1804375),
           (0.2126729, 0.7151522, 0.0721750),
           (0.0193339, 0.1191920, 0.9503041))

LOG_MIN_SHOT_NOISE = math.log(0.0001)
LOG_MAX_SHOT_NOISE = math.log(0.012)


def uniform(generator: torch.Generator, shape, low: float = 0.0,
            high: float = 1.0) -> torch.Tensor:
    """U[low, high) float32 on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (high - low) + low


def normal(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device)


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[..., 3, 3] @ [..., 3, 3]`` in float32, elementwise (never a TF32
    product on the card), as the chain of fused multiply-adds that XLA's
    float32 dot runs on the CPU: each product is exact in float64 and each
    partial sum is rounded once to float32."""
    a64, b64 = a.double(), b.double()
    out = (a64[..., :, 0, None] * b64[..., None, 0, :]).float()
    for k in (1, 2):
        out = (a64[..., :, k, None] * b64[..., None, k, :]
               + out.double()).float()
    return out


def _sum_seq(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along ``dim`` left to right (a fixed order on every device)."""
    parts = x.unbind(dim)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def ccm_from_weights(weights: torch.Tensor) -> torch.Tensor:
    """RGB -> camera CCM ``[..., 3, 3]`` from the convex-combination weights
    ``[..., 4]`` of the four XYZ -> camera bases; rows sum to 1."""
    bases = torch.tensor(XYZ2CAMS, dtype=torch.float32, device=weights.device)
    w = weights[..., :, None, None]
    xyz2cam = _sum_seq(bases * w, -3) / _sum_seq(weights, -1)[..., None, None]
    rgb2xyz = torch.tensor(RGB2XYZ, dtype=torch.float32,
                           device=weights.device)
    rgb2cam = matmul3(xyz2cam, rgb2xyz)
    return rgb2cam / rgb2cam.sum(dim=-1, keepdim=True)


def random_ccm(generator: torch.Generator, n: int) -> torch.Tensor:
    """``n`` random CCMs (weights ~ U[0, 1)^4)."""
    return ccm_from_weights(uniform(generator, (n, 4)))


def gains_from_draws(gain_normal: torch.Tensor, red_gain: torch.Tensor,
                     blue_gain: torch.Tensor):
    """``(rgb_gain, red_gain, blue_gain)`` with ``rgb_gain = 1 / (0.8 + 0.1 *
    gain_normal)``."""
    return 1.0 / (gain_normal * 0.1 + 0.8), red_gain, blue_gain


def random_gains(generator: torch.Generator, n: int):
    """rgb ~ 1/N(0.8, 0.1), red ~ U[1.9, 2.4), blue ~ U[1.5, 1.9)."""
    return gains_from_draws(normal(generator, (n,)),
                            uniform(generator, (n,), 1.9, 2.4),
                            uniform(generator, (n,), 1.5, 1.9))


def invert_smoothstep(image: torch.Tensor) -> torch.Tensor:
    """Exact inverse of the smoothstep tone curve 3x^2 - 2x^3."""
    image = image.clamp(0.0, 1.0)
    return 0.5 - torch.sin(torch.asin(1.0 - 2.0 * image) / 3.0)


def gamma_expansion(image: torch.Tensor) -> torch.Tensor:
    """Gamma -> linear (2.2), clamped near zero."""
    return image.clamp(min=1e-8) ** 2.2


def apply_ccm(image: torch.Tensor, ccm: torch.Tensor) -> torch.Tensor:
    """Apply ``[..., 3, 3]`` colour matrices to ``[..., H, W, 3]`` images,
    ``out_i = sum_j ccm_ij * image_j``, elementwise in float32."""
    c = ccm[..., None, None, :, :]
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    return torch.stack([c[..., i, 0] * r + c[..., i, 1] * g + c[..., i, 2] * b
                        for i in range(3)], dim=-1)


def safe_invert_gains(image: torch.Tensor, rgb_gain, red_gain,
                      blue_gain) -> torch.Tensor:
    """Invert the gains of an RGB image with highlight protection: pixels
    whose mean is above 0.9 keep a gain that blends towards 1."""
    red = torch.as_tensor(red_gain, dtype=image.dtype, device=image.device)
    blue = torch.as_tensor(blue_gain, dtype=image.dtype, device=image.device)
    rgb = torch.as_tensor(rgb_gain, dtype=image.dtype, device=image.device)
    gains = torch.stack([1.0 / red, torch.ones_like(red), 1.0 / blue],
                        dim=-1) / rgb[..., None]
    gains = gains[..., None, None, :]
    gray = image.mean(dim=-1, keepdim=True)
    inflection = 0.9
    mask = ((gray - inflection).clamp(min=0.0) / (1.0 - inflection)) ** 2.0
    safe_gains = torch.maximum(mask + (1.0 - mask) * gains, gains)
    return image * safe_gains


def mosaic(image: torch.Tensor) -> torch.Tensor:
    """RGGB Bayer planes: ``[..., H, W, 3]`` -> ``[..., H/2, W/2, 4]``
    (R, Gr, Gb, B)."""
    return torch.stack([image[..., 0::2, 0::2, 0], image[..., 0::2, 1::2, 1],
                        image[..., 1::2, 0::2, 1], image[..., 1::2, 1::2, 2]],
                       dim=-1)


def noise_levels_from_draws(log_shot: torch.Tensor,
                            read_normal: torch.Tensor):
    """``(shot, read)`` of the log-log noise model:
    ``log(read) = 2.18 log(shot) + 1.20 + 0.26 * read_normal``."""
    shot = torch.exp(log_shot)
    read = torch.exp(2.18 * log_shot + 1.20 + read_normal * 0.26)
    return shot, read


def random_noise_levels(generator: torch.Generator, n: int):
    """log(shot) ~ U[log 1e-4, log 0.012); read from the log-log model."""
    return noise_levels_from_draws(
        uniform(generator, (n,), LOG_MIN_SHOT_NOISE, LOG_MAX_SHOT_NOISE),
        normal(generator, (n,)))


def add_noise(image: torch.Tensor, shot_noise, read_noise,
              noise: torch.Tensor) -> torch.Tensor:
    """Heteroscedastic shot + read noise, variance ``image * shot + read``,
    from the standard-normal field ``noise`` (``image``'s shape). The noise
    levels are per sample (leading dims of ``image``) or scalars."""
    shot = torch.as_tensor(shot_noise, dtype=image.dtype, device=image.device)
    read = torch.as_tensor(read_noise, dtype=image.dtype, device=image.device)
    extra = image.ndim - shot.ndim
    shot = shot.reshape(shot.shape + (1,) * extra)
    read = read.reshape(read.shape + (1,) * extra)
    variance = image * shot + read
    return image + noise * torch.sqrt(variance)


def demosaic_naive(packed: torch.Tensor) -> torch.Tensor:
    """Cheap pseudo-RGB from packed RGGB ``[..., 4]``: (R, (G1+G2)/2, B) at
    the packed (half) resolution, as the encoder feeds the flow network."""
    return torch.stack(
        [packed[..., 0], 0.5 * (packed[..., 1] + packed[..., 2]),
         packed[..., 3]], dim=-1)
