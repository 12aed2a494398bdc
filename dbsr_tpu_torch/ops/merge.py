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

The forward and the backward take float32 or bfloat16 (feat, logits and
the gradients of one type); in bfloat16 the max, the exps and the sums are
float32 and each output is rounded once, as in the TPU kernels.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dbsr_tpu_torch import kernels
from dbsr_tpu_torch.utils.profiling import annotate


def fused_softmax_merge_plain(feat: torch.Tensor,
                              logits: torch.Tensor) -> torch.Tensor:
    """Plain version: softmax over the frame axis, weighted sum of frames.
    Below float32 (bfloat16), in the steps of the TPU kernel's body
    (``merge_pallas._merge_kernel``), float32: the logits' max over the
    frames, then frame by frame ``s += exp(l - m)`` and ``a += exp(l - m) *
    f`` (each product and sum rounded on its own), and ``a / s`` rounded
    once, the steps and order of the bf16 kernel."""
    if feat.dtype in (torch.float32, torch.float64):
        w = torch.softmax(logits.float(), dim=1)
        return (feat.float() * w).sum(dim=1).to(feat.dtype)
    l = logits.float()
    f = feat.float()
    m = l.amax(dim=1)
    s = a = None
    for n in range(l.shape[1]):
        e = torch.exp(l[:, n] - m)
        t = e * f[:, n]
        s = e if s is None else s + e
        a = t if a is None else a + t
    return (a / s).to(feat.dtype)


def fused_softmax_merge_backward_plain(feat: torch.Tensor,
                                       logits: torch.Tensor, g: torch.Tensor
                                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain backward, ``(d_feat, d_logits)`` for the output gradient ``g``
    ``[B, h, w, C]``, in float32 in the steps of the TPU kernel's body
    (``merge_pallas._merge_bwd_kernel``), the sums over the frames taken
    frame by frame, the order of the bf16 kernel: the max ``m``, ``s = sum
    exp(l - m)``, ``w = exp(l - m) / s``, ``fused = sum w f``, then ``w g``
    and ``w g (f - fused)``, each rounded once to the inputs' type."""
    l = logits.float()
    f = feat.float()
    e = torch.exp(l - l.amax(dim=1, keepdim=True))
    s = e[:, 0]
    for n in range(1, e.shape[1]):
        s = s + e[:, n]
    w = e / s[:, None]
    fused = w[:, 0] * f[:, 0]
    for n in range(1, e.shape[1]):
        fused = fused + w[:, n] * f[:, n]
    wg = w * g.float()[:, None]
    return (wg.to(feat.dtype),
            (wg * (f - fused[:, None])).to(logits.dtype))


def _check(op: str, feat: torch.Tensor, logits: torch.Tensor) -> None:
    if feat.ndim != 5 or logits.shape != feat.shape:
        raise ValueError(f"{op}: feat {tuple(feat.shape)} and logits "
                         f"{tuple(logits.shape)} are not equal [B,N,h,w,C]")


def _sizes(op: str, *tensors: torch.Tensor,
           dtypes=()) -> Tuple[int, int, int, int]:
    kernels.require_cuda(op, *tensors, dtypes=dtypes)
    B, N, H, W, C = tensors[0].shape
    if C % 4 or N == 0:
        raise ValueError(f"{op}: kernel takes C % 4 == 0 and N > 0, got "
                         f"N={N}, C={C}")
    return B, N, H * W, C


def merge_forward(feat: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """The forward alone, no autograd: the kernel for CUDA tensors
    (float32 or bfloat16, contiguous, C % 4 == 0), the plain version for CPU
    ones."""
    with annotate("op.merge_forward"):
        _check("fused_softmax_merge", feat, logits)
        if feat.device.type == "cpu" and logits.device.type == "cpu":
            return fused_softmax_merge_plain(feat, logits)
        fn = kernels.entry("fused_softmax_merge", "dbsr_merge", feat.dtype)
        B, N, P, C = _sizes("fused_softmax_merge", feat, logits,
                            dtypes=(feat.dtype,) * 2)
        out = feat.new_empty((B,) + feat.shape[2:])
        kernels.launch("merge", fn, (feat, logits, out), (B, N, P, C))
        fused_softmax_merge.launches += 1
        return out


def merge_backward(feat: torch.Tensor, logits: torch.Tensor,
                   g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(d_feat, d_logits)``: the kernel for CUDA tensors, the plain
    version for CPU ones."""
    with annotate("op.merge_backward"):
        _check("merge_backward", feat, logits)
        if g.shape != feat.shape[:1] + feat.shape[2:]:
            raise ValueError(f"merge_backward: g {tuple(g.shape)} vs feat "
                             f"{tuple(feat.shape)}")
        if all(t.device.type == "cpu" for t in (feat, logits, g)):
            return fused_softmax_merge_backward_plain(feat, logits, g)
        fn = kernels.entry("merge_backward", "dbsr_merge_bwd", feat.dtype)
        B, N, P, C = _sizes("merge_backward", feat, logits, g,
                            dtypes=(feat.dtype,) * 3)
        dfeat = torch.empty_like(feat)
        dlogits = torch.empty_like(logits)
        kernels.launch("merge_bwd", fn,
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
    the CUDA kernels for CUDA tensors (float32 or bfloat16, contiguous,
    C % 4 == 0), the plain versions for CPU tensors."""
    return _Merge.apply(feat, logits)


fused_softmax_merge.launches = 0
merge_backward.launches = 0
