"""Frame-softmax weighted sum and its gradient (port of
``dbsr_tpu/ops/merge_pallas.py``): ``[B, N, h, w, C] x2 -> [B, h, w, C]``,
``sum_n softmax_n(logits) * feat_n`` with the softmax in float32.

``fused_softmax_merge`` is a ``torch.autograd.Function``. For CUDA tensors
its forward launches ``kernels/csrc/merge.cu`` (one pass over each input,
online softmax) and its backward ``kernels/csrc/merge_bwd.cu``
(``merge_backward``: the weights recomputed from the saved inputs,
``dfeat_n = w_n g``, ``dlogits_n = w_n g (feat_n - fused)``). For CPU
tensors the same ``Function`` runs ``fused_softmax_merge_plain`` and
``fused_softmax_merge_backward_plain``. ``fused_softmax_merge.launches``
and ``merge_backward.launches`` count kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dbsr_tpu_torch import kernels


def fused_softmax_merge_plain(feat: torch.Tensor,
                              logits: torch.Tensor) -> torch.Tensor:
    """Plain version: softmax over the frame axis, weighted sum of frames."""
    w = torch.softmax(logits.float(), dim=1)
    return (feat.float() * w).sum(dim=1).to(feat.dtype)


def fused_softmax_merge_backward_plain(feat: torch.Tensor,
                                       logits: torch.Tensor, g: torch.Tensor
                                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain backward, ``(d_feat, d_logits)`` for the output gradient ``g``
    ``[B, h, w, C]`` (mirrors ``merge_pallas._merge_bwd_kernel``)."""
    l = logits.float()
    f = feat.float()
    e = torch.exp(l - l.amax(dim=1, keepdim=True))
    w = e / e.sum(dim=1, keepdim=True)
    fused = (w * f).sum(dim=1)
    wg = w * g.float()[:, None]
    return (wg.to(feat.dtype),
            (wg * (f - fused[:, None])).to(logits.dtype))


def _check(op: str, feat: torch.Tensor, logits: torch.Tensor) -> None:
    if feat.ndim != 5 or logits.shape != feat.shape:
        raise ValueError(f"{op}: feat {tuple(feat.shape)} and logits "
                         f"{tuple(logits.shape)} are not equal [B,N,h,w,C]")


def _sizes(op: str, *tensors: torch.Tensor) -> Tuple[int, int, int, int]:
    kernels.require_cuda_f32(op, *tensors)
    B, N, H, W, C = tensors[0].shape
    if C % 4 or N == 0:
        raise ValueError(f"{op}: kernel takes C % 4 == 0 and N > 0, got "
                         f"N={N}, C={C}")
    return B, N, H * W, C


def merge_forward(feat: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """The forward alone, no autograd: the kernel for CUDA tensors
    (float32, contiguous, C % 4 == 0), the plain version for CPU ones."""
    _check("fused_softmax_merge", feat, logits)
    if feat.device.type == "cpu" and logits.device.type == "cpu":
        return fused_softmax_merge_plain(feat, logits)
    B, N, P, C = _sizes("fused_softmax_merge", feat, logits)
    out = feat.new_empty((B,) + feat.shape[2:])
    kernels.launch("merge", "dbsr_merge_f32", (feat, logits, out),
                   (B, N, P, C))
    fused_softmax_merge.launches += 1
    return out


def merge_backward(feat: torch.Tensor, logits: torch.Tensor,
                   g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(d_feat, d_logits)``: the kernel for CUDA tensors, the plain
    version for CPU ones."""
    _check("merge_backward", feat, logits)
    if g.shape != feat.shape[:1] + feat.shape[2:]:
        raise ValueError(f"merge_backward: g {tuple(g.shape)} vs feat "
                         f"{tuple(feat.shape)}")
    if all(t.device.type == "cpu" for t in (feat, logits, g)):
        return fused_softmax_merge_backward_plain(feat, logits, g)
    B, N, P, C = _sizes("merge_backward", feat, logits, g)
    dfeat = torch.empty_like(feat)
    dlogits = torch.empty_like(logits)
    kernels.launch("merge_bwd", "dbsr_merge_bwd_f32",
                   (feat, logits, g, dfeat, dlogits), (B, N, P, C))
    merge_backward.launches += 1
    return dfeat, dlogits


class _Merge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, logits):
        ctx.save_for_backward(feat, logits)
        return merge_forward(feat, logits)

    @staticmethod
    def backward(ctx, g):
        feat, logits = ctx.saved_tensors
        dfeat, dlogits = merge_backward(feat, logits, g.contiguous())
        return (dfeat if ctx.needs_input_grad[0] else None,
                dlogits if ctx.needs_input_grad[1] else None)


def fused_softmax_merge(feat: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One-pass frame-softmax weighted sum, differentiable in both inputs:
    the CUDA kernels for CUDA tensors (float32, contiguous, C % 4 == 0),
    the plain versions for CPU tensors."""
    return _Merge.apply(feat, logits)


fused_softmax_merge.launches = 0
merge_backward.launches = 0
