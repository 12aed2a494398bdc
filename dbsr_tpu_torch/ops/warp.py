"""Bilinear backward warp of channels-last features and its gradient (port
of ``dbsr_tpu/ops/warp_pallas.py`` and the gather ``warp`` /
``sample_bilinear`` of ``dbsr_tpu/ops/interp.py``).

``warp_feat`` is a ``torch.autograd.Function``. For CUDA tensors its
forward launches ``kernels/csrc/warp.cu`` and its backward the two kernels
of ``kernels/csrc/warp_bwd.cu``: ``warp_dfeat`` (the transposed 4-tap
operator applied to the output gradient, a scatter with atomics) when the
features need a gradient, and ``warp_dflow`` (the floor-tap derivative of
the taps against the features) only when the flow needs one. For CPU
tensors the same ``Function`` runs the plain versions
(``warp_feat_plain``, ``warp_feat_backward_plain``). Each kernel wrapper
counts its launches in ``.launches``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dbsr_tpu_torch import kernels


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
    (00, 01, 10, 11), the order the CUDA kernels use."""
    B, H, W, C = im.shape
    flat = im.reshape(B, H * W, C)
    out = None
    for idx, w, _, _ in _taps(coords, H, W):
        term = _gather(flat, idx) * w[..., None].to(im.dtype)
        out = term if out is None else out + term
    return out


def warp_feat_plain(feat: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: output pixel p samples ``feat``
    ``[B, H, W, C]`` at ``p + flow[p]`` (``flow`` ``[B, H, W, 2]``, (x, y)
    pixels), zeros padding."""
    H, W = feat.shape[1], feat.shape[2]
    coords = base_grid(H, W, feat.device) + flow.float()
    return sample_bilinear(feat, coords)


def warp_dfeat_plain(flow: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``_dfeat_kernel``: the transposed 4-tap operator applied to ``g``
    ``[B, H, W, C]``, as a scatter-add of ``w_tap * g`` into the taps."""
    B, H, W, C = g.shape
    coords = base_grid(H, W, g.device) + flow.float()
    offset = (torch.arange(B, device=g.device) * (H * W)).reshape(B, 1, 1)
    gf = g.reshape(B * H * W, C)
    out = torch.zeros_like(gf)
    for idx, w, _, _ in _taps(coords, H, W):
        out.index_add_(0, (idx + offset).reshape(-1),
                       gf * w.reshape(-1, 1).to(g.dtype))
    return out.reshape(B, H, W, C)


def warp_dflow_plain(feat: torch.Tensor, flow: torch.Tensor,
                     g: torch.Tensor) -> torch.Tensor:
    """``_dflow_kernel``: per output pixel, ``sum_c g[p, c] *
    sum_tap dw_tap/d(x, y) * feat[tap, c]`` with the floor-tap one-sided
    derivative (``feat[i+1] - feat[i]`` at an integer coordinate)."""
    B, H, W, C = feat.shape
    coords = base_grid(H, W, feat.device) + flow.float()
    flat = feat.reshape(B, H * W, C)
    fx = fy = None
    for idx, _, dwdx, dwdy in _taps(coords, H, W):
        val = _gather(flat, idx).float()
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


def _launch_checks(op: str, *tensors: torch.Tensor) -> Tuple[int, ...]:
    kernels.require_cuda_f32(op, *tensors)
    B, H, W, C = tensors[0].shape
    if C % 4:
        raise ValueError(f"{op}: kernel takes C % 4 == 0, got C={C}")
    return B, H, W, C


def warp_forward(feat: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The forward alone, no autograd: the kernel for CUDA tensors
    (float32, contiguous, C % 4 == 0), the plain version for CPU ones."""
    _check("warp_feat", feat, flow)
    if _on_cpu(feat, flow):
        return warp_feat_plain(feat, flow)
    B, H, W, C = _launch_checks("warp_feat", feat, flow)
    out = torch.empty_like(feat)
    kernels.launch("warp", "dbsr_warp_f32", (feat, flow, out), (B, H, W, C))
    warp_feat.launches += 1
    return out


def warp_dfeat(flow: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """d_feat of the warp for the output gradient ``g`` ``[B, H, W, C]``:
    the kernel (scatter with atomics into a zeroed output) for CUDA
    tensors, the plain scatter-add for CPU ones."""
    _check("warp_dfeat", g, flow)
    if _on_cpu(flow, g):
        return warp_dfeat_plain(flow, g)
    B, H, W, C = _launch_checks("warp_dfeat", g, flow)
    out = torch.zeros_like(g)
    kernels.launch("warp_bwd", "dbsr_warp_dfeat_f32", (flow, g, out),
                   (B, H, W, C))
    warp_dfeat.launches += 1
    return out


def warp_dflow(feat: torch.Tensor, flow: torch.Tensor,
               g: torch.Tensor) -> torch.Tensor:
    """d_flow of the warp ``[B, H, W, 2]``: the kernel (one warp per output
    pixel) for CUDA tensors, the plain version for CPU ones."""
    _check("warp_dflow", feat, flow)
    if g.shape != feat.shape:
        raise ValueError(f"warp_dflow: g {tuple(g.shape)} vs feat "
                         f"{tuple(feat.shape)}")
    if _on_cpu(feat, flow, g):
        return warp_dflow_plain(feat, flow, g)
    B, H, W, C = _launch_checks("warp_dflow", feat, g, flow)
    out = torch.empty_like(flow)
    kernels.launch("warp_bwd", "dbsr_warp_dflow_f32", (feat, flow, g, out),
                   (B, H, W, C))
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
    differentiable in both: the CUDA kernels for CUDA tensors (float32,
    contiguous, C % 4 == 0), the plain versions for CPU tensors."""
    return _Warp.apply(feat, flow)


warp_feat.launches = 0
warp_dfeat.launches = 0
warp_dflow.launches = 0
