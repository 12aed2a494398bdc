"""Affine bilinear burst resampling (port of
``dbsr_tpu/ops/resample_pallas.py``).

Output pixel (r, x) of frame n of image b samples ``images[b]`` at
``invs[b, n] @ ((x+.5)d-.5+border, (r+.5)d-.5+border, 1)`` with zeros
padding: one call draws every LR frame of a batch of bursts from its
source image (``data/synthetic.py``: fused path at ``d=4`` with the border
crop, strict path at ``d=1``, border 0).

``affine_resample`` launches ``kernels/csrc/resample.cu`` for CUDA tensors
and runs ``affine_resample_plain`` (the gather form, ``_xla_oracle`` of the
JAX package) for CPU tensors. Both compute exact float32 for any affine;
the TPU kernel's bf16 DEFAULT-precision band matmul is not carried over.
``affine_resample.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dbsr_tpu_torch import kernels
from dbsr_tpu_torch.ops.interp import apply_affine_to_points
from dbsr_tpu_torch.ops.warp import base_grid, sample_bilinear
from dbsr_tpu_torch.utils.profiling import annotate


def fine_grid(out_hw: Tuple[int, int], d: int, border: int,
              device=None) -> torch.Tensor:
    """Source-grid positions ``(q + 0.5) d - 0.5 + border`` of the output
    pixels ``q`` ``[OH, OW, 2]`` ((x, y) order)."""
    return (base_grid(*out_hw, device=device) + 0.5) * d - 0.5 + border


def affine_resample_plain(images: torch.Tensor, invs: torch.Tensor,
                          out_hw: Tuple[int, int], d: int,
                          border: int) -> torch.Tensor:
    """Plain version: ``images`` ``[B, H, W, C]``, ``invs`` ``[B, N, 2, 3]``
    -> ``[B, N, OH, OW, C]``, the gather ``sample_bilinear`` at the
    composed-affine coordinates."""
    B, N = invs.shape[:2]
    OH, OW = out_hw
    coords = apply_affine_to_points(
        invs, fine_grid(out_hw, d, border, images.device))
    out = sample_bilinear(images, coords.reshape(B, N * OH, OW, 2))
    return out.reshape(B, N, OH, OW, images.shape[-1])


def affine_resample(images: torch.Tensor, invs: torch.Tensor,
                    out_hw: Tuple[int, int], d: int,
                    border: int) -> torch.Tensor:
    """Resample every frame of a batch of bursts: the CUDA kernel for CUDA
    tensors (float32, contiguous, C <= 4), the plain version for CPU
    tensors."""
    with annotate("op.affine_resample"):
        if images.ndim != 4 or invs.ndim != 4 \
                or invs.shape[0] != images.shape[0] \
                or invs.shape[2:] != (2, 3):
            raise ValueError(f"affine_resample: images {tuple(images.shape)} "
                             f"and invs {tuple(invs.shape)} are not "
                             "[B,H,W,C], [B,N,2,3]")
        if images.device.type == "cpu" and invs.device.type == "cpu":
            return affine_resample_plain(images, invs, out_hw, d, border)
        kernels.require_cuda("affine_resample", images, invs)
        B, H, W, C = images.shape
        if C > 4:
            raise ValueError(
                f"affine_resample: kernel takes C <= 4, got C={C}")
        N = invs.shape[1]
        OH, OW = out_hw
        out = images.new_empty((B, N, OH, OW, C))
        kernels.launch("resample", "dbsr_resample_f32", (images, invs, out),
                       (B, N, H, W, C, OH, OW, int(d), int(border)))
        affine_resample.launches += 1
        return out


affine_resample.launches = 0
