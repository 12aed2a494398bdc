"""Bilinear backward warp of channels-last features and its gradient (port
of ``dbsr_tpu/ops/warp_pallas.py`` and the gather ``warp`` /
``sample_bilinear`` of ``dbsr_tpu/ops/interp.py``).

``warp_feat`` is a ``torch.autograd.Function``. For CUDA tensors its
forward launches ``kernels/csrc/warp.cu`` and its backward the two kernels
of ``kernels/csrc/warp_bwd.cu``: ``warp_dfeat`` (the transposed 4-tap
operator applied to the output gradient, a deterministic gather over a
per-call CSR of the transposed taps) when the features need a gradient,
and ``warp_dflow`` (the floor-tap derivative of the taps against the
features) only when the flow needs one. For CPU
tensors the same ``Function`` runs the plain versions
(``warp_feat_plain``, ``warp_feat_backward_plain``). Each kernel wrapper
counts its launches in ``.launches``.

The forward and both backward kernels take float32 or bfloat16 features
and gradients (the flow float32); in bfloat16 they follow the TPU
kernels' arithmetic (each tap weight, or each derivative weight of
d_flow, rounded to bf16, products and sums in float32, one rounding of
each bf16 output; d_flow's output is float32, the flow's type).
"""

from __future__ import annotations

from typing import Tuple

import torch

from dbsr_tpu_torch import kernels
from dbsr_tpu_torch.utils.profiling import annotate


def base_grid(h: int, w: int, device=None) -> torch.Tensor:
    """Integer-pixel identity sampling grid ``[h, w, 2]`` in (x, y) order."""
    ys = torch.arange(h, dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def _taps(coords: torch.Tensor, H: int, W: int):
    """Floor-tap geometry of ``warp_pallas._tap_weights``: for each of the
    taps (00, 01, 10, 11), the flat source index (clamped), the weight and
    its derivatives along x and y, the last three 0 where the tap is out
    of range."""
    x = coords[..., 0].float()
    y = coords[..., 1].float()
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    out = []
    for dy, dx, w, dwdx, dwdy in (
            (0, 0, (1 - wy) * (1 - wx), -(1 - wy), -(1 - wx)),
            (0, 1, (1 - wy) * wx, (1 - wy), -wx),
            (1, 0, wy * (1 - wx), -wy, (1 - wx)),
            (1, 1, wy * wx, wy, wx)):
        yi = y0 + dy
        xi = x0 + dx
        valid = ((yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)).to(w.dtype)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
        out.append((idx, w * valid, dwdx * valid, dwdy * valid))
    return out


def _gather(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``flat`` ``[B, P, C]`` at ``idx`` ``[B, ...]`` -> ``[B, ..., C]``."""
    B, C = flat.shape[0], flat.shape[-1]
    val = torch.gather(flat, 1, idx.reshape(B, -1, 1).expand(-1, -1, C))
    return val.reshape(idx.shape + (C,))


def sample_bilinear(im: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of ``[B, H, W, C]`` at pixel ``coords``
    ``[B, h, w, 2]`` ((x, y), pixel centres at integers); out-of-range
    corner taps contribute 0. The four terms are summed in tap order
    (00, 01, 10, 11), the order the CUDA kernels use. Below float32 (a
    bfloat16 ``im``) each weight is rounded to ``im``'s type, the products
    and their sum are float32 and the output is rounded once, as the TPU
    kernel's bf16 matmul does."""
    B, H, W, C = im.shape
    acc = torch.promote_types(im.dtype, torch.float32)
    flat = im.reshape(B, H * W, C)
    out = None
    for idx, w, _, _ in _taps(coords, H, W):
        term = _gather(flat, idx).to(acc) * w[..., None].to(im.dtype).to(acc)
        out = term if out is None else out + term
    return out.to(im.dtype)


def warp_feat_plain(feat: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: output pixel p samples ``feat``
    ``[B, H, W, C]`` at ``p + flow[p]`` (``flow`` ``[B, H, W, 2]``, (x, y)
    pixels), zeros padding."""
    H, W = feat.shape[1], feat.shape[2]
    coords = base_grid(H, W, feat.device) + flow.float()
    return sample_bilinear(feat, coords)


def warp_dfeat_plain(flow: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``_dfeat_kernel``: the transposed 4-tap operator applied to ``g``
    ``[B, H, W, C]``, as a scatter-add of ``w_tap * g`` into the taps.
    Below float32 (a bfloat16 ``g``), as the TPU kernel's bf16 matmul and
    the CUDA kernel's gather: each tap weight rounded to bf16, every input
    pixel's terms summed in float32 in ascending source order (the order
    of the kernel's CSR), and the sum rounded once
    (:func:`_dfeat_ordered`)."""
    if g.dtype not in (torch.float32, torch.float64):
        return _dfeat_ordered(flow, g)
    B, H, W, C = g.shape
    coords = base_grid(H, W, g.device) + flow.float()
    offset = (torch.arange(B, device=g.device) * (H * W)).reshape(B, 1, 1)
    gf = g.reshape(B * H * W, C)
    out = torch.zeros_like(gf)
    for idx, w, _, _ in _taps(coords, H, W):
        out.index_add_(0, (idx + offset).reshape(-1),
                       gf * w.reshape(-1, 1).to(g.dtype))
    return out.reshape(B, H, W, C)


def _dfeat_ordered(flow: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """d_feat with each target's terms added in ascending source order, the
    same bits on every device: the (target, source) pairs of the nonzero
    taps sorted, then one ``index_add_`` per rank within a target's bucket,
    which touches each target at most once, so no two adds race."""
    B, H, W, C = g.shape
    P = H * W
    coords = base_grid(H, W, g.device) + flow.float()
    frame = (torch.arange(B, device=g.device) * P).reshape(B, 1, 1)
    src = (frame + torch.arange(P, device=g.device).reshape(1, H, W)
           ).reshape(-1)
    tgt, srcs, wts = [], [], []
    for idx, w, _, _ in _taps(coords, H, W):
        keep = (w != 0).reshape(-1)
        tgt.append((idx + frame).reshape(-1)[keep])
        srcs.append(src[keep])
        wts.append(w.reshape(-1)[keep])
    tgt, srcs, wts = torch.cat(tgt), torch.cat(srcs), torch.cat(wts)
    order = torch.argsort(tgt * (B * P) + srcs)
    tgt, srcs, wts = tgt[order], srcs[order], wts[order]
    counts = torch.bincount(tgt, minlength=B * P)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(tgt.numel(), device=g.device) - start[tgt]
    gf = g.reshape(B * P, C).float()
    wq = wts.to(g.dtype).float()  # the weights as bf16 operands hold them
    out = torch.zeros((B * P, C), dtype=torch.float32, device=g.device)
    for r in range(int(counts.max()) if tgt.numel() else 0):
        sel = rank == r
        out.index_add_(0, tgt[sel], gf[srcs[sel]] * wq[sel, None])
    return out.to(g.dtype).reshape(B, H, W, C)


def warp_dflow_plain(feat: torch.Tensor, flow: torch.Tensor,
                     g: torch.Tensor) -> torch.Tensor:
    """``_dflow_kernel``: per output pixel, ``sum_c g[p, c] *
    sum_tap dw_tap/d(x, y) * feat[tap, c]`` with the floor-tap one-sided
    derivative (``feat[i+1] - feat[i]`` at an integer coordinate), the
    taps' terms summed in tap order in float32. Below float32 (a bfloat16
    ``feat``) each derivative weight is rounded to ``feat``'s type first,
    as the TPU kernel's bf16 matmul rounds its operator."""
    B, H, W, C = feat.shape
    coords = base_grid(H, W, feat.device) + flow.float()
    flat = feat.reshape(B, H * W, C)
    fx = fy = None
    for idx, _, dwdx, dwdy in _taps(coords, H, W):
        val = _gather(flat, idx).float()
        if feat.dtype not in (torch.float32, torch.float64):
            dwdx, dwdy = (d.to(feat.dtype).float() for d in (dwdx, dwdy))
        tx, ty = val * dwdx[..., None], val * dwdy[..., None]
        fx = tx if fx is None else fx + tx
        fy = ty if fy is None else fy + ty
    gf = g.float()
    return torch.stack([(fx * gf).sum(-1), (fy * gf).sum(-1)],
                       dim=-1).to(flow.dtype)


def warp_feat_backward_plain(feat: torch.Tensor, flow: torch.Tensor,
                             g: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain backward of the warp, ``(d_feat, d_flow)`` for the output
    gradient ``g`` (mirrors ``warp_pallas._warp_bwd_pallas``)."""
    return warp_dfeat_plain(flow, g), warp_dflow_plain(feat, flow, g)


def _check(op: str, feat: torch.Tensor, flow: torch.Tensor) -> None:
    if feat.ndim != 4 or flow.shape != feat.shape[:3] + (2,):
        raise ValueError(f"{op}: feat {tuple(feat.shape)} and flow "
                         f"{tuple(flow.shape)} are not [B,H,W,C], [B,H,W,2]")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _launch_checks(op: str, *tensors: torch.Tensor,
                   dtypes=()) -> Tuple[int, ...]:
    kernels.require_cuda(op, *tensors, dtypes=dtypes)
    return tuple(tensors[0].shape)


def warp_forward(feat: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The forward alone, no autograd: the kernel for CUDA tensors
    (float32 or bfloat16 features, float32 flow, contiguous, any C: 16-byte
    accesses where the channels fill them, one channel an access
    otherwise), the plain version for CPU ones."""
    with annotate("op.warp_forward"):
        _check("warp_feat", feat, flow)
        if _on_cpu(feat, flow):
            return warp_feat_plain(feat, flow)
        fn = kernels.entry("warp_feat", "dbsr_warp", feat.dtype)
        B, H, W, C = _launch_checks("warp_feat", feat, flow,
                                    dtypes=(feat.dtype, torch.float32))
        out = torch.empty_like(feat)
        kernels.launch("warp", fn, (feat, flow, out), (B, H, W, C))
        warp_feat.launches += 1
        return out


def _dfeat_scratch_words(frames: int, P: int) -> int:
    """int32 words of the d_feat kernel's CSR (``warp_bwd.cu:csr_words``):
    per frame the targets' counts [P] and bucket starts [P + 1], rounded up
    to 16 bytes, then 4 P entries of (source, weight) pairs."""
    return (frames * (2 * P + 1) + 3) // 4 * 4 + frames * 8 * P


def warp_dfeat(flow: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """d_feat of the warp for the output gradient ``g`` ``[B, H, W, C]``:
    the kernel (float32 or bfloat16 ``g``, float32 flow; a gather over the
    transposed taps, bit-identical from call to call; any C, one channel
    an access where the channels do not fill 16 bytes) for CUDA tensors,
    the plain version for CPU ones."""
    with annotate("op.warp_dfeat"):
        _check("warp_dfeat", g, flow)
        if _on_cpu(flow, g):
            return warp_dfeat_plain(flow, g)
        fn = kernels.entry("warp_dfeat", "dbsr_warp_dfeat", g.dtype)
        B, H, W, C = _launch_checks("warp_dfeat", g, flow,
                                    dtypes=(g.dtype, torch.float32))
        out = torch.empty_like(g)
        words = _dfeat_scratch_words(B, H * W)
        scratch = torch.empty(words, dtype=torch.int32, device=g.device)
        kernels.launch("warp_bwd", fn, (flow, g, out, scratch),
                       (B, H, W, C, words))
        warp_dfeat.launches += 1
        return out


def warp_dflow(feat: torch.Tensor, flow: torch.Tensor,
               g: torch.Tensor) -> torch.Tensor:
    """d_flow of the warp ``[B, H, W, 2]``, float32: the kernel (float32 or
    bfloat16 ``feat`` and ``g``, float32 flow; several pixels a warp at
    small C, any C) for CUDA tensors, the plain version for CPU ones."""
    with annotate("op.warp_dflow"):
        _check("warp_dflow", feat, flow)
        if g.shape != feat.shape:
            raise ValueError(f"warp_dflow: g {tuple(g.shape)} vs feat "
                             f"{tuple(feat.shape)}")
        if _on_cpu(feat, flow, g):
            return warp_dflow_plain(feat, flow, g)
        fn = kernels.entry("warp_dflow", "dbsr_warp_dflow", feat.dtype)
        B, H, W, C = _launch_checks("warp_dflow", feat, g, flow,
                                    dtypes=(feat.dtype, feat.dtype,
                                            torch.float32))
        out = torch.empty_like(flow)
        kernels.launch("warp_bwd", fn, (feat, flow, g, out), (B, H, W, C))
        warp_dflow.launches += 1
        return out


class _Warp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, flow):
        # only d_flow reads feat: under a frozen flow it is not kept alive
        ctx.save_for_backward(feat if ctx.needs_input_grad[1] else None, flow)
        return warp_forward(feat, flow)

    @staticmethod
    def backward(ctx, g):
        feat, flow = ctx.saved_tensors
        g = g.contiguous()
        dfeat = warp_dfeat(flow, g) if ctx.needs_input_grad[0] else None
        dflow = (warp_dflow(feat, flow, g) if ctx.needs_input_grad[1]
                 else None)
        return dfeat, dflow


def warp_feat(feat: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp ``feat`` ``[B, H, W, C]`` by ``flow`` ``[B, H, W, 2]``,
    differentiable in both: the CUDA kernels for CUDA tensors (float32 or
    bfloat16 features, float32 flow, contiguous, any C), the plain
    versions for CPU tensors."""
    return _Warp.apply(feat, flow)


warp_feat.launches = 0
warp_dfeat.launches = 0
warp_dflow.launches = 0
