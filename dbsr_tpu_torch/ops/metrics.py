"""Image-quality metrics and pixel losses (port of
``dbsr_tpu/ops/metrics.py:33-225``): channels-last ``[..., H, W, C]``
images, pred first, with ``boundary_ignore`` cropping and optional validity
masks with the element-ratio correction.

SSIM's window sums are a depthwise ``F.conv2d`` with TF32 off (the JAX
package computes them at ``Precision.HIGHEST``), so the protocol's math is
float32 on the card too.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from dbsr_tpu_torch.ops.filtering import gauss_1d
from dbsr_tpu_torch.serving import float32_math


def _crop_boundary(x: Optional[torch.Tensor], b: Optional[int]):
    if x is None or not b:
        return x
    return x[..., b:-b, b:-b, :]


def _masked_mean(err: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``sum(err * valid) / (sum(valid) * numel(err) / numel(valid))``."""
    valid = valid.to(err.dtype)
    elem_ratio = err.numel() / valid.numel()
    return (err * valid.expand_as(err)).sum() / (valid.sum() * elem_ratio
                                                 + 1e-12)


def pixel_error(pred: torch.Tensor, gt: torch.Tensor, metric: str = "l1",
                boundary_ignore: Optional[int] = None,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean pixel error, ``'l1'``, ``'l2'``, ``'l2_sqrt'`` (the per-pixel
    L2 norm over channels) or ``'charbonnier'``; with a broadcastable
    ``valid`` mask (e.g. ``[..., H, W, 1]``) the element-ratio-corrected
    masked mean. For ``l2_sqrt`` the mask's channel axis is dropped."""
    diff = _crop_boundary(pred, boundary_ignore) \
        - _crop_boundary(gt, boundary_ignore)
    valid = _crop_boundary(valid, boundary_ignore)
    if metric == "l1":
        err = diff.abs()
    elif metric == "l2":
        err = diff ** 2
    elif metric == "l2_sqrt":
        err = torch.sqrt((diff ** 2).sum(dim=-1))
        if valid is not None and valid.ndim == err.ndim + 1:
            valid = valid[..., 0]
    elif metric == "charbonnier":
        err = torch.sqrt(diff ** 2 + 1e-3 ** 2)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    if valid is None:
        return err.mean()
    return _masked_mean(err, valid)


def psnr(pred: torch.Tensor, gt: torch.Tensor,
         boundary_ignore: Optional[int] = None, max_value: float = 1.0,
         valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PSNR per sample of ``[B, H, W, C]`` (or one ``[H, W, C]``), averaged
    over the finite ones (0 when none is finite)."""
    if pred.ndim == 3:
        pred, gt = pred[None], gt[None]
        valid = None if valid is None else valid[None]
    diff = _crop_boundary(pred, boundary_ignore) \
        - _crop_boundary(gt, boundary_ignore)
    err = diff ** 2
    if valid is None:
        mse = err.flatten(1).mean(dim=1)
    else:
        valid = _crop_boundary(valid, boundary_ignore).to(err.dtype)
        elem_ratio = err[0].numel() / valid[0].numel()
        mse = (err * valid.expand_as(err)).flatten(1).sum(dim=1) \
            / (valid.flatten(1).sum(dim=1) * elem_ratio + 1e-12)
    vals = 20 * math.log10(max_value) - 10.0 * torch.log10(mse)
    finite = torch.isfinite(vals)
    n = finite.sum()
    total = torch.where(finite, vals, torch.zeros_like(vals)).sum()
    return torch.where(n > 0, total / n.clamp(min=1), torch.zeros_like(total))


def _ssim_window(window_size: int, sigma: float = 1.5,
                 device=None) -> torch.Tensor:
    g = gauss_1d(window_size, sigma, center=float(window_size // 2)
                 - (window_size - 1) / 2)[0]
    g = g / g.sum()
    return (g[:, None] * g[None, :]).to(device)


def _depthwise_valid_conv(x: torch.Tensor, kernel2d: torch.Tensor):
    """VALID depthwise conv of NCHW ``x`` with one 2-D kernel, float32 (TF32
    off)."""
    C = x.shape[1]
    weight = kernel2d.to(x.dtype).expand(C, 1, *kernel2d.shape)
    with float32_math():
        return F.conv2d(x, weight, groups=C)


def _ssim_maps(pred: torch.Tensor, gt: torch.Tensor, window_size: int,
               val_range: Optional[float]):
    """The SSIM map and the contrast-sensitivity map ``v1 / v2``, both NCHW
    ``[B, C, H-10, W-10]``, of ``[B, H, W, C]`` images."""
    L = 1.0 if val_range is None else val_range  # images here are in [0, 1]
    real_size = min(window_size, pred.shape[-3], pred.shape[-2])
    window = _ssim_window(real_size, device=pred.device)
    x = pred.permute(0, 3, 1, 2)
    y = gt.permute(0, 3, 1, 2)

    mu1 = _depthwise_valid_conv(x, window)
    mu2 = _depthwise_valid_conv(y, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _depthwise_valid_conv(x * x, window) - mu1_sq
    sigma2_sq = _depthwise_valid_conv(y * y, window) - mu2_sq
    sigma12 = _depthwise_valid_conv(x * y, window) - mu1_mu2

    C1 = (0.01 * L) ** 2
    C2 = (0.03 * L) ** 2
    v1 = 2.0 * sigma12 + C2
    v2 = sigma1_sq + sigma2_sq + C2
    ssim_map = ((2 * mu1_mu2 + C1) * v1) / ((mu1_sq + mu2_sq + C1) * v2)
    return ssim_map, v1 / v2


def ssim(pred: torch.Tensor, gt: torch.Tensor, window_size: int = 11,
         val_range: Optional[float] = None, spatial_out: bool = False,
         full: bool = False):
    """Windowed SSIM (VALID padding, Gaussian 11x11 window, sigma 1.5) of
    ``[B, H, W, C]`` (or one ``[H, W, C]``): the scalar mean, or the map
    ``[B, H-10, W-10, C]`` with ``spatial_out``; ``full`` also returns the
    mean contrast sensitivity (for MS-SSIM)."""
    if pred.ndim == 3:
        pred, gt = pred[None], gt[None]
    ssim_map, cs_map = _ssim_maps(pred, gt, window_size, val_range)
    ret = ssim_map.permute(0, 2, 3, 1) if spatial_out else ssim_map.mean()
    if full:
        return ret, cs_map.mean()
    return ret


def ssim_metric(pred: torch.Tensor, gt: torch.Tensor,
                boundary_ignore: Optional[int] = None,
                valid: Optional[torch.Tensor] = None,
                use_for_loss: bool = False) -> torch.Tensor:
    """The eval protocol's SSIM: boundary crop, the SSIM map, its mean (with
    ``valid``, the masked mean, the mask cropped a further 5 px for the
    window); ``1 - ssim`` when used as a loss."""
    pred = _crop_boundary(pred, boundary_ignore)
    gt = _crop_boundary(gt, boundary_ignore)
    valid = _crop_boundary(valid, boundary_ignore)
    loss = ssim(pred, gt, spatial_out=True)
    if valid is not None:
        loss = _masked_mean(loss, valid[..., 5:-5, 5:-5, :])
    else:
        loss = loss.mean()
    return 1.0 - loss if use_for_loss else loss


MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def msssim(pred: torch.Tensor, gt: torch.Tensor, window_size: int = 11,
           val_range: Optional[float] = None) -> torch.Tensor:
    """5-level MS-SSIM with the standard weights, a 2x2 VALID average pool
    between levels."""
    if pred.ndim == 3:
        pred, gt = pred[None], gt[None]
    mssim, mcs = [], []
    for level in range(len(MSSSIM_WEIGHTS)):
        if level:
            pred, gt = _avg_pool_2x2(pred), _avg_pool_2x2(gt)
        sim, cs = ssim(pred, gt, window_size=window_size, val_range=val_range,
                       full=True)
        mssim.append(sim)
        mcs.append(cs)
    w = torch.tensor(MSSSIM_WEIGHTS, device=pred.device)
    pow1 = torch.stack(mcs) ** w
    pow2 = torch.stack(mssim) ** w
    return torch.prod(pow1[:-1]) * pow2[-1]


def _avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 VALID average pool of ``[B, H, W, C]``."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
