"""Gaussian kernels and filtering (port of ``dbsr_tpu/ops/filtering.py``:
``gauss_1d``, ``gauss_2d``, ``get_gaussian_kernel``, ``apply_kernel``),
computed in float32 as the JAX package computes them."""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch
import torch.nn.functional as F


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


def get_gaussian_kernel(sd: float, ksz: int = None
                        ) -> Tuple[torch.Tensor, int]:
    """Normalised 2-D Gaussian kernel ``[ksz, ksz]``; ``ksz`` defaults to
    ``4 * sd + 1`` (the JAX package's ``get_gaussian_kernel``)."""
    if ksz is None:
        ksz = int(4 * sd + 1)
    if ksz % 2 != 1:
        raise ValueError(f"get_gaussian_kernel: ksz={ksz} is not odd")
    k = gauss_2d(ksz, sd, (0.0, 0.0), density=True)[0]
    return k / k.sum(), ksz


def apply_kernel(im: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise convolution of ``[..., H, W, C]`` with one ``[kh, kw]``
    kernel for every channel, reflect padding, float32 with TF32 off (the
    JAX package convolves at ``Precision.HIGHEST``)."""
    from dbsr_tpu_torch.serving import float32_math

    kh, kw = kernel.shape
    lead = im.shape[:-3]
    H, W, C = im.shape[-3:]
    x = im.reshape((-1, H, W, C)).permute(0, 3, 1, 2)
    x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2), mode="reflect")
    weight = kernel.to(device=im.device, dtype=im.dtype).expand(C, 1, kh, kw)
    with float32_math():
        out = F.conv2d(x, weight, groups=C)
    return out.permute(0, 2, 3, 1).reshape(lead + (H, W, C))
