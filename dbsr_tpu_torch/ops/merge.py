"""Frame-softmax weighted sum (port of ``dbsr_tpu/ops/merge_pallas.py``
forward): ``[B, N, h, w, C] x2 -> [B, h, w, C]``,
``sum_n softmax_n(logits) * feat_n`` with the softmax in float32.

``fused_softmax_merge`` launches the CUDA kernel ``kernels/csrc/merge.cu``
(one pass over each input, online softmax) for a CUDA tensor and runs
``fused_softmax_merge_plain`` for a CPU tensor.
``fused_softmax_merge.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from dbsr_tpu_torch import kernels


def fused_softmax_merge_plain(feat: torch.Tensor,
                              logits: torch.Tensor) -> torch.Tensor:
    """Plain version: softmax over the frame axis, weighted sum of frames."""
    w = torch.softmax(logits.float(), dim=1)
    return (feat.float() * w).sum(dim=1).to(feat.dtype)


def fused_softmax_merge(feat: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One-pass frame-softmax weighted sum: the CUDA kernel for CUDA tensors
    (float32, contiguous, C % 4 == 0), :func:`fused_softmax_merge_plain`
    for CPU tensors."""
    if feat.ndim != 5 or logits.shape != feat.shape:
        raise ValueError(f"fused_softmax_merge: feat {tuple(feat.shape)} and "
                         f"logits {tuple(logits.shape)} are not equal "
                         "[B,N,h,w,C]")
    if feat.device.type == "cpu" and logits.device.type == "cpu":
        return fused_softmax_merge_plain(feat, logits)
    kernels.require_cuda_f32("fused_softmax_merge", feat, logits)
    B, N, H, W, C = feat.shape
    if C % 4 or N == 0:
        raise ValueError(f"fused_softmax_merge: kernel takes C % 4 == 0 and "
                         f"N > 0, got N={N}, C={C}")
    out = feat.new_empty((B, H, W, C))
    kernels.launch("merge", "dbsr_merge_f32", (feat, logits, out),
                   (B, N, H * W, C))
    fused_softmax_merge.launches += 1
    return out


fused_softmax_merge.launches = 0
