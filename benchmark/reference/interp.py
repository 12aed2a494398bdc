"""Resampling ops: ``resize_bilinear``, the PWC-style ``backwarp`` with its
analytic validity mask, and the affine helpers of burst synthesis (a frozen
copy of the port's ``ops/interp.py``, its warp the plain one)."""

from __future__ import annotations

from typing import Tuple

import torch

from benchmark.reference.plain import base_grid, warp_feat


def _gather_axis_linear(x: torch.Tensor, coords: torch.Tensor,
                        axis: int) -> torch.Tensor:
    """Linear interpolation along ``axis`` at float ``coords``, edge clamp."""
    n = x.shape[axis]
    i0f = torch.floor(coords)
    w = coords - i0f
    i0 = i0f.long()
    x0 = torch.index_select(x, axis, i0.clamp(0, n - 1))
    x1 = torch.index_select(x, axis, (i0 + 1).clamp(0, n - 1))
    shape = [1] * x.ndim
    shape[axis] = coords.shape[0]
    w = w.reshape(shape)
    return x0 * (1.0 - w) + x1 * w


def resize_bilinear(im: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Separable bilinear resize of ``[..., H, W, C]`` to ``out_hw``:
    half-pixel centres (``src = (dst + 0.5) * in/out - 0.5``), no
    antialiasing, edge clamp -- torch ``F.interpolate(bilinear,
    align_corners=False)`` semantics, in the JAX package's arithmetic."""
    h_axis, w_axis = im.ndim - 3, im.ndim - 2
    for axis, out in ((h_axis, out_hw[0]), (w_axis, out_hw[1])):
        scale = im.shape[axis] / out
        dst = torch.arange(out, dtype=torch.float32, device=im.device)
        im = _gather_axis_linear(im, (dst + 0.5) * scale - 0.5, axis)
    return im


def _axis_ones(c: torch.Tensor, n: int) -> torch.Tensor:
    """Sum of the in-bounds bilinear tap weights along one axis, in f32."""
    c = c.float()
    i0 = torch.floor(c)
    frac = c - i0
    w0 = (1.0 - frac) * ((i0 >= 0.0) & (i0 <= n - 1.0)).float()
    w1 = frac * ((i0 >= -1.0) & (i0 <= n - 2.0)).float()
    return w0 + w1


def backwarp(im: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """PWC-Net-style backwarp of ``[B, H, W, C]`` by ``flow``
    ``[B, H, W, 2]``: the effective displacement is ``flow * S/(S-1)`` per
    axis (the reference normalizes by (S-1)/2 and denormalizes with
    align_corners=False), and pixels whose warped-ones value is not above
    0.999 are zeroed. Warped ones is computed analytically in f32, as the
    product of the per-axis in-bounds tap-weight sums."""
    H, W = im.shape[-3], im.shape[-2]
    fx = flow[..., 0].float() * (W / (W - 1.0))
    fy = flow[..., 1].float() * (H / (H - 1.0))
    f = torch.stack([fx, fy], dim=-1)
    out = warp_feat(im.contiguous(), f.contiguous())
    coords = base_grid(H, W, im.device) + f
    ones = _axis_ones(coords[..., 0], W) * _axis_ones(coords[..., 1], H)
    return out * (ones > 0.999).to(im.dtype)[..., None]


def invert_2x3(tmat: torch.Tensor) -> torch.Tensor:
    """Invert affine ``[..., 2, 3]`` matrices (append [0, 0, 1], invert,
    crop), as the JAX package does with ``jnp.linalg.inv``."""
    bottom = torch.tensor([0.0, 0.0, 1.0], dtype=tmat.dtype,
                          device=tmat.device).expand(tmat.shape[:-2] + (1, 3))
    full = torch.cat([tmat, bottom], dim=-2)
    # inv_ex: no host sync to check the (never singular) factorisation
    return torch.linalg.inv_ex(full).inverse[..., :2, :]


def apply_affine_to_points(tmat: torch.Tensor,
                           points: torch.Tensor) -> torch.Tensor:
    """Apply ``[..., 2, 3]`` affines to ``[h, w, 2]`` (x, y) points ->
    ``[..., h, w, 2]``. Elementwise in float32, never a matmul: image-scale
    coordinates must not pass through a reduced-precision product (the
    TPU's DEFAULT-precision MXU truncated them to bf16; on the card a TF32
    matmul would do the same)."""
    t = tmat[..., None, None, :, :]
    x = points[..., 0]
    y = points[..., 1]
    out_x = t[..., 0, 0] * x + t[..., 0, 1] * y + t[..., 0, 2]
    out_y = t[..., 1, 0] * x + t[..., 1, 1] * y + t[..., 1, 2]
    return torch.stack([out_x, out_y], dim=-1)
