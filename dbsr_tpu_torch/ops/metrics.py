"""Pixel losses and PSNR (port of ``dbsr_tpu/ops/metrics.py:33-109``,
without the ``valid`` mask): channels-last ``[..., H, W, C]`` images, pred
first, with ``boundary_ignore`` cropping."""

from __future__ import annotations

import math
from typing import Optional

import torch


def _crop_boundary(x: torch.Tensor, b: Optional[int]) -> torch.Tensor:
    if not b:
        return x
    return x[..., b:-b, b:-b, :]


def pixel_error(pred: torch.Tensor, gt: torch.Tensor, metric: str = "l1",
                boundary_ignore: Optional[int] = None) -> torch.Tensor:
    """Mean pixel error, ``'l1'`` or ``'l2'``."""
    diff = _crop_boundary(pred, boundary_ignore) \
        - _crop_boundary(gt, boundary_ignore)
    if metric == "l1":
        return diff.abs().mean()
    if metric == "l2":
        return (diff ** 2).mean()
    raise ValueError(f"metric {metric!r} is not ported (l1, l2)")


def psnr(pred: torch.Tensor, gt: torch.Tensor,
         boundary_ignore: Optional[int] = None,
         max_value: float = 1.0) -> torch.Tensor:
    """PSNR per sample of ``[B, H, W, C]`` (or one ``[H, W, C]``), averaged
    over the finite ones (0 when none is finite)."""
    if pred.ndim == 3:
        pred, gt = pred[None], gt[None]
    diff = _crop_boundary(pred, boundary_ignore) \
        - _crop_boundary(gt, boundary_ignore)
    mse = (diff ** 2).flatten(1).mean(dim=1)
    vals = 20 * math.log10(max_value) - 10.0 * torch.log10(mse)
    finite = torch.isfinite(vals)
    n = finite.sum()
    total = torch.where(finite, vals, torch.zeros_like(vals)).sum()
    return torch.where(n > 0, total / n.clamp(min=1), torch.zeros_like(total))
