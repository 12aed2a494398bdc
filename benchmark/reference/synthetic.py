"""On-device synthetic RAW burst generation (port of
``dbsr_tpu/data/synthetic.py``).

An sRGB crop ``[B, H+2b, W+2b, 3]`` becomes, on the crop's device: the
inverse ISP (random CCM and gains, inverse smoothstep and gamma), per-frame
random affines (frame 0 only the centring shift), the LR frames (border
crop, x``d`` downsample), the RGGB mosaic and shot/read noise, plus the
dense flow of each frame to the base frame and the border-cropped linear
ground truth.

The random draws (``sample_draws``) are separate from their application
(``rgb2rawburst_from_draws``), so a test can feed the JAX package's own
draws. All resampling goes through ``ops/resample.py:affine_resample``
(the CUDA kernel on the card), for any affine:

* fused (``cfg.fused_resample``): one resample at ``d`` straight onto the
  LR grid, with exact flow from the composed affine;
* strict: the full-resolution warp (``d=1``), border crop and a bilinear
  x1/``d`` resize, with the flow resized the same way -- the reference's
  two-stage chain.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from benchmark.reference import augment, camera
from benchmark.reference.interp import (apply_affine_to_points, invert_2x3,
                                       resize_bilinear)
from benchmark.reference.plain import affine_resample, base_grid, fine_grid


class BurstConfig(NamedTuple):
    """Static configuration of the burst generator (the JAX package's
    fields and properties)."""
    burst_size: int = 8
    crop_sz: Tuple[int, int] = (384, 384)
    downsample_factor: int = 4
    border_crop: int = 24
    max_translation: float = 24.0
    max_rotation: float = 1.0
    max_shear: float = 0.0
    max_scale: float = 0.0
    max_ar_factor: float = 0.0
    random_ccm: bool = True
    random_gains: bool = True
    smoothstep: bool = True
    gamma: bool = True
    add_noise: bool = True
    fused_resample: bool = False

    @property
    def pre_crop_sz(self) -> Tuple[int, int]:
        """HR crop size fed to the generator (crop + 2*border_crop)."""
        return (self.crop_sz[0] + 2 * self.border_crop,
                self.crop_sz[1] + 2 * self.border_crop)

    @property
    def burst_hw(self) -> Tuple[int, int]:
        """Packed-RAW burst frame size."""
        return (self.crop_sz[0] // self.downsample_factor // 2,
                self.crop_sz[1] // self.downsample_factor // 2)

    def transform_params(self) -> dict:
        return {"max_translation": self.max_translation,
                "max_rotation": self.max_rotation,
                "max_shear": self.max_shear,
                "max_scale": self.max_scale,
                "max_ar_factor": self.max_ar_factor}


def sample_draws(generator: torch.Generator, batch: int,
                 cfg: BurstConfig) -> Dict[str, torch.Tensor]:
    """Every random value one batch of ``batch`` bursts needs, on the
    generator's device: CCM weights, gains, the non-reference frames'
    transform draws, noise levels and the standard-normal noise field."""
    N = cfg.burst_size
    draws = {
        "ccm_weights": camera.uniform(generator, (batch, 4)),
        "gain_normal": camera.normal(generator, (batch,)),
        "red_gain": camera.uniform(generator, (batch,), 1.9, 2.4),
        "blue_gain": camera.uniform(generator, (batch,), 1.5, 1.9),
        "log_shot": camera.uniform(generator, (batch,),
                                   camera.LOG_MIN_SHOT_NOISE,
                                   camera.LOG_MAX_SHOT_NOISE),
        "read_normal": camera.normal(generator, (batch,)),
        "noise": camera.normal(generator, (batch, N) + cfg.burst_hw + (4,)),
    }
    draws.update(augment.draw_transforms(generator, (batch, N - 1),
                                         cfg.transform_params()))
    return draws


def invert_isp(images: torch.Tensor, draws: Dict[str, torch.Tensor],
               cfg: BurstConfig):
    """sRGB ``[B, H, W, 3]`` -> linear sensor space, and the ISP meta."""
    B = images.shape[0]
    if cfg.random_ccm:
        rgb2cam = camera.ccm_from_weights(draws["ccm_weights"])
    else:
        rgb2cam = torch.eye(3, device=images.device).expand(B, 3, 3)
    if cfg.random_gains:
        rgb_gain, red_gain, blue_gain = camera.gains_from_draws(
            draws["gain_normal"], draws["red_gain"], draws["blue_gain"])
    else:
        rgb_gain = red_gain = blue_gain = torch.ones(B, device=images.device)
    image = images
    if cfg.smoothstep:
        image = camera.invert_smoothstep(image)
    if cfg.gamma:
        image = camera.gamma_expansion(image)
    image = camera.apply_ccm(image, rgb2cam)
    image = camera.safe_invert_gains(image, rgb_gain, red_gain, blue_gain)
    image = image.clamp(0.0, 1.0)
    meta = {"rgb2cam": rgb2cam, "cam2rgb": torch.linalg.inv_ex(rgb2cam).inverse,
            "rgb_gain": rgb_gain, "red_gain": red_gain,
            "blue_gain": blue_gain, "smoothstep": cfg.smoothstep,
            "gamma": cfg.gamma}
    return image, meta


def burst_transforms(draws: Dict[str, torch.Tensor], hw: Tuple[int, int],
                     cfg: BurstConfig) -> torch.Tensor:
    """``[B, N, 2, 3]`` frame affines: the reference frame first."""
    oth = augment.transforms_from_draws(draws, hw, cfg.downsample_factor,
                                        cfg.transform_params())
    ref = augment.reference_transform(oth.shape[:1] + (1,), hw,
                                      cfg.downsample_factor, oth.device)
    return torch.cat([ref, oth], dim=1)


def single2lrburst(images: torch.Tensor, tmats: torch.Tensor,
                   cfg: BurstConfig):
    """Linear HR images ``[B, H, W, 3]`` and frame affines ``[B, N, 2, 3]``
    -> (LR RGB bursts ``[B, N, h, w, 3]``, flow to the base frame
    ``[B, N, h, w, 2]``), with ``lr_0(p) ~= lr_i(p - flow_i(p))``."""
    H, W = images.shape[1], images.shape[2]
    b = cfg.border_crop
    d = cfg.downsample_factor
    out_hw = ((H - 2 * b) // d, (W - 2 * b) // d)
    invs = invert_2x3(tmats).contiguous()
    if cfg.fused_resample:
        lr = affine_resample(images, invs, out_hw, d, b)
        pos_inv = apply_affine_to_points(
            invs, fine_grid(out_hw, d, b, images.device)) / d
    else:
        warped = affine_resample(images, invs, (H, W), 1, 0)
        pos_inv = apply_affine_to_points(invs,
                                         base_grid(H, W, images.device))
        if b > 0:
            warped = warped[:, :, b:-b, b:-b, :]
            pos_inv = pos_inv[:, :, b:-b, b:-b, :]
        lr = resize_bilinear(warped, out_hw)
        pos_inv = resize_bilinear(pos_inv, out_hw) / d
    return lr, pos_inv - pos_inv[:, :1]


def rgb2rawburst_from_draws(images: torch.Tensor,
                            draws: Dict[str, torch.Tensor],
                            cfg: BurstConfig) -> Dict[str, torch.Tensor]:
    """sRGB HR crops ``[B, H+2b, W+2b, 3]`` -> the training sample dict:
    ``burst`` ``[B, N, h/2, w/2, 4]`` (noisy packed RGGB, clipped),
    ``frame_gt`` ``[B, H, W, 3]`` (linear RGB), ``burst_rgb``
    ``[B, N, h, w, 3]`` (clean LR), ``flow`` ``[B, N, h, w, 2]`` and
    ``meta``."""
    linear, meta = invert_isp(images, draws, cfg)
    tmats = burst_transforms(draws, linear.shape[1:3], cfg)
    burst_rgb, flow = single2lrburst(linear, tmats, cfg)
    burst = camera.mosaic(burst_rgb)
    if cfg.add_noise:
        shot, read = camera.noise_levels_from_draws(draws["log_shot"],
                                                    draws["read_normal"])
        burst = camera.add_noise(burst, shot, read, draws["noise"])
    else:
        shot = read = torch.zeros(images.shape[0], device=images.device)
    burst = burst.clamp(0.0, 1.0)
    b = cfg.border_crop
    frame_gt = linear[:, b:-b, b:-b, :] if b > 0 else linear
    meta = dict(meta, shot_noise_level=shot, read_noise_level=read)
    return {"burst": burst, "frame_gt": frame_gt, "burst_rgb": burst_rgb,
            "flow": flow, "meta": meta}


def synthesize_batch(generator: torch.Generator, hr_crops: torch.Tensor,
                     cfg: BurstConfig) -> Dict[str, torch.Tensor]:
    """Batch synthesis on ``hr_crops``' device: ``[B, H+2b, W+2b, 3]`` ->
    the batched sample dict of :func:`rgb2rawburst_from_draws`."""
    return rgb2rawburst_from_draws(
        hr_crops, sample_draws(generator, hr_crops.shape[0], cfg), cfg)


def rgb2rawburst(generator: torch.Generator, image: torch.Tensor,
                 cfg: BurstConfig) -> Dict[str, torch.Tensor]:
    """One sRGB crop ``[H+2b, W+2b, 3]`` -> one sample (no batch dim)."""
    out = synthesize_batch(generator, image[None], cfg)
    meta = {k: v[0] if torch.is_tensor(v) else v
            for k, v in out.pop("meta").items()}
    return dict({k: v[0] for k, v in out.items()}, meta=meta)
