"""Affine transforms of burst frames (port of ``dbsr_tpu/ops/augment.py``).

``get_tmat`` builds the 2x3 affine ``scale @ rot_about_center @ shear @
translation`` (cv2.getRotationMatrix2D convention: CCW ``theta`` degrees
about ``(w/2, h/2)``), batched over leading dims, composed elementwise in
float32. ``sample_burst_transform`` is split into a draw
(``draw_transforms``: translation, theta, shear, log-aspect and log-scale,
the values ``jax.random`` returns in the JAX package) and an apply
(``transforms_from_draws``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from dbsr_tpu_torch.ops.camera import matmul3, uniform


def _mat(rows) -> torch.Tensor:
    """3x3 matrices from nine ``[...]`` tensors given row by row."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def get_tmat(image_shape: Tuple[int, int], translation: torch.Tensor,
             theta_deg: torch.Tensor, shear: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """``[..., 2, 3]`` affine from ``translation`` ``[..., 2]``, ``theta_deg``
    ``[...]``, ``shear`` ``[..., 2]`` and ``scale`` ``[..., 2]``."""
    im_h, im_w = image_shape
    tx, ty = translation[..., 0], translation[..., 1]
    theta = theta_deg * (math.pi / 180.0)
    sx, sy = shear[..., 0], shear[..., 1]
    k0, k1 = scale[..., 0], scale[..., 1]
    one = torch.ones_like(tx)
    zero = torch.zeros_like(tx)

    t_trans = _mat(((one, zero, tx), (zero, one, ty), (zero, zero, one)))
    a = torch.cos(theta)
    b = torch.sin(theta)
    cx, cy = im_w * 0.5, im_h * 0.5
    t_rot = _mat(((a, b, (1 - a) * cx - b * cy),
                  (-b, a, b * cx + (1 - a) * cy),
                  (zero, zero, one)))
    t_shear = _mat(((one, sx, -sx * 0.5 * im_w),
                    (sy, one, -sy * 0.5 * im_h),
                    (zero, zero, one)))
    t_scale = _mat(((k0, zero, zero), (zero, k1, zero), (zero, zero, one)))
    t = matmul3(t_scale, matmul3(t_rot, matmul3(t_shear, t_trans)))
    return t[..., :2, :]


def draw_transforms(generator: torch.Generator, shape: Tuple[int, ...],
                    params: dict) -> Dict[str, torch.Tensor]:
    """The random draws of ``shape`` non-reference frames: translation
    ``[*shape, 2]`` ~ U[-T, T), theta ``[*shape]`` ~ U[-R, R) degrees,
    shear ``[*shape, 2]`` ~ U[-S, S), log-aspect ~ U[-A, A) and log-scale
    ~ U[-K, K) (``params``' ``max_*``, default 0)."""
    shape = tuple(shape)
    max_t = float(params.get("max_translation", 0.0))
    max_r = float(params.get("max_rotation", 0.0))
    max_s = float(params.get("max_shear", 0.0))
    max_ar = float(params.get("max_ar_factor", 0.0))
    max_sc = float(params.get("max_scale", 0.0))
    return {
        "translation": uniform(generator, shape + (2,), -max_t, max_t),
        "theta": uniform(generator, shape, -max_r, max_r),
        "shear": uniform(generator, shape + (2,), -max_s, max_s),
        "log_ar": uniform(generator, shape, -max_ar, max_ar),
        "log_scale": uniform(generator, shape, -max_sc, max_sc),
    }


def transforms_from_draws(draws: Dict[str, torch.Tensor],
                          image_shape: Tuple[int, int],
                          downsample_factor: float,
                          params: dict) -> torch.Tensor:
    """``[*shape, 2, 3]`` affines of non-reference frames from their draws.
    A translation bound <= 0.01 px means no random translation: the frames
    then get the centring shift ``d/2 - 0.5`` as the reference does."""
    t = draws["translation"]
    if float(params.get("max_translation", 0.0)) <= 0.01:
        t = torch.full_like(t, downsample_factor / 2.0 - 0.5)
    ar = torch.exp(draws["log_ar"])
    sc = torch.exp(draws["log_scale"])
    return get_tmat(image_shape, t, draws["theta"], draws["shear"],
                    torch.stack([sc, sc * ar], dim=-1))


def reference_transform(shape: Tuple[int, ...], image_shape: Tuple[int, int],
                        downsample_factor: float, device=None) -> torch.Tensor:
    """``[*shape, 2, 3]`` affines of the reference frame: only the
    half-pixel centring shift ``d/2 - 0.5``."""
    shape = tuple(shape)
    shift = downsample_factor / 2.0 - 0.5
    zero = torch.zeros(shape, device=device)
    return get_tmat(image_shape, torch.full(shape + (2,), shift,
                                            device=device),
                    zero, torch.zeros(shape + (2,), device=device),
                    torch.ones(shape + (2,), device=device))


def sample_burst_transform(generator: torch.Generator, n: int,
                           image_shape: Tuple[int, int],
                           downsample_factor: float, params: dict,
                           is_reference: bool) -> torch.Tensor:
    """``[n, 2, 3]`` frame affines: the reference frame's centring shift,
    or random translation / rotation / shear / scale for the others."""
    if is_reference:
        return reference_transform((n,), image_shape, downsample_factor,
                                   generator.device)
    return transforms_from_draws(draw_transforms(generator, (n,), params),
                                 image_shape, downsample_factor, params)
