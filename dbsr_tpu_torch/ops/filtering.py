"""Gaussian kernels (port of ``dbsr_tpu/ops/filtering.py``: ``gauss_1d``,
``gauss_2d``), computed in float32 as the JAX package computes them."""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch


def gauss_1d(sz: int, sigma: float, center, end_pad: int = 0,
             density: bool = False) -> torch.Tensor:
    """1-D Gaussian sampled at ``[-(sz-1)/2, ..., (sz+1)/2 + end_pad - 1]``;
    ``center`` scalar or ``[n]`` -> ``[n, sz + end_pad]``."""
    center = torch.atleast_1d(torch.as_tensor(center, dtype=torch.float32))
    k = torch.arange(-(sz - 1) / 2, (sz + 1) / 2 + end_pad,
                     dtype=torch.float32)
    g = torch.exp(-1.0 / (2 * sigma ** 2) * (k[None, :] - center[:, None]) ** 2)
    if density:
        g = g / (math.sqrt(2 * math.pi) * sigma)
    return g


def gauss_2d(sz: Union[int, Tuple[int, int]], sigma, center=(0.0, 0.0),
             end_pad: Tuple[int, int] = (0, 0),
             density: bool = False) -> torch.Tensor:
    """2-D Gaussian ``[n, H, W]``, the outer product of two 1-D Gaussians."""
    if isinstance(sigma, (float, int)):
        sigma = (sigma, sigma)
    if isinstance(sz, int):
        sz = (sz, sz)
    center = torch.atleast_2d(torch.as_tensor(center, dtype=torch.float32))
    gy = gauss_1d(sz[0], sigma[0], center[:, 0], end_pad[0], density)
    gx = gauss_1d(sz[1], sigma[1], center[:, 1], end_pad[1], density)
    return gy[:, None, :] * gx[:, :, None]
