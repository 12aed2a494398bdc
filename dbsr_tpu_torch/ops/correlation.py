"""81-channel +-4 local cost volume and its gradient (port of
``dbsr_tpu/ops/correlation.py``):

    out[b, y, x, (dy+4)*9 + (dx+4)] = mean_c first[b, y, x, c]
                                             * second[b, y+dy, x+dx, c]

with zero padding outside ``second``. ``cost_volume`` is a
``torch.autograd.Function``. For CUDA tensors (any plane size, any C >= 1)
its forward launches ``kernels/csrc/correlation.cu`` and its backward the
kernel of ``kernels/csrc/correlation_bwd.cu`` (one body, two entries), each
entry only when its input needs a gradient: ``correlation_dfirst`` and
``correlation_dsecond``. For CPU
tensors the same ``Function`` runs the plain versions (``correlation_plain``,
``correlation_dfirst_plain``, ``correlation_dsecond_plain``;
``correlation_dsecond_shifted_plain`` is d_second in the kernel's form, from
the gradient shifted per pixel, ``shift_gradient``). The inputs are
kept for the backward only when a gradient is needed, so nothing is saved
under ``no_grad``. Each kernel wrapper counts its launches in ``.launches``.

The forward and both backward kernels take float32 or bfloat16 (the
inputs, the gradient and the outputs of one type); in bfloat16 they follow
the TPU kernels' arithmetic: the sums and the 1/C in float32, one rounding
of the output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dbsr_tpu_torch import kernels
from dbsr_tpu_torch.utils.profiling import annotate

MAX_DISP = 4
NUM_OFFSETS = (2 * MAX_DISP + 1) ** 2  # 81


def _offsets():
    for dy in range(-MAX_DISP, MAX_DISP + 1):
        for dx in range(-MAX_DISP, MAX_DISP + 1):
            yield dy, dx


def _pad_plane(x: torch.Tensor) -> torch.Tensor:
    p = MAX_DISP
    return F.pad(x, (0, 0, p, p, p, p))


def correlation_plain(first: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """Shifted-window cost volume, 81 shifted products and a channel mean:
    ``[B, H, W, C] x2 -> [B, H, W, 81]``. Below float32 (bfloat16, the TPU
    kernel's arithmetic): the products, exact in float32, summed channel by
    channel in order, divided by C and rounded once, which is what the CUDA
    kernel's ``fmaf`` chain computes, bit for bit."""
    B, H, W, C = first.shape
    p = MAX_DISP
    second_p = _pad_plane(second)
    if first.dtype not in (torch.float32, torch.float64):
        f = first.float()
        shifted = torch.stack(
            [second_p[:, dy + p:dy + p + H, dx + p:dx + p + W, :]
             for dy, dx in _offsets()], dim=-2)  # [B, H, W, 81, C]
        acc = torch.zeros((B, H, W, NUM_OFFSETS), dtype=torch.float32,
                          device=first.device)
        for c in range(C):
            acc = acc + f[..., c:c + 1] * shifted[..., c].float()
        # a tensor divisor: PyTorch multiplies by the reciprocal of a
        # scalar one on the card, which is not the division
        return (acc / acc.new_full((1,), C)).to(first.dtype)
    outs = []
    for dy, dx in _offsets():
        shifted = second_p[:, dy + p:dy + p + H, dx + p:dx + p + W, :]
        outs.append((first * shifted).mean(dim=-1))
    return torch.stack(outs, dim=-1)


def correlation_dfirst_plain(second: torch.Tensor,
                             g: torch.Tensor) -> torch.Tensor:
    """``_corr_dfirst_kernel``: ``d_first[y, x, c] = (1/C) sum_o g[y, x, o] *
    second[y+dy_o, x+dx_o, c]``, 81 shifted slices of the padded ``second``
    accumulated in float32, the ``1/C`` applied once after the sum."""
    B, H, W, C = second.shape
    p = MAX_DISP
    sp = _pad_plane(second.float())
    gf = g.float()
    df = torch.zeros((B, H, W, C), dtype=torch.float32, device=second.device)
    for o, (dy, dx) in enumerate(_offsets()):
        df = df + gf[..., o:o + 1] * sp[:, p + dy:p + dy + H,
                                        p + dx:p + dx + W, :]
    return (df * (1.0 / C)).to(second.dtype)


def correlation_dsecond_plain(first: torch.Tensor,
                              g: torch.Tensor) -> torch.Tensor:
    """``_corr_dsecond_kernel``: ``d_second[v, w, c] = (1/C) sum_o
    g[v-dy_o, w-dx_o, o] * first[v-dy_o, w-dx_o, c]``, reading the padded
    ``first`` and ``g`` so that a term whose read position falls outside the
    plane is zero."""
    B, H, W, C = first.shape
    p = MAX_DISP
    fp = _pad_plane(first.float())
    gp = _pad_plane(g.float())
    ds = torch.zeros((B, H, W, C), dtype=torch.float32, device=first.device)
    for o, (dy, dx) in enumerate(_offsets()):
        ys, xs = slice(p - dy, p - dy + H), slice(p - dx, p - dx + W)
        ds = ds + gp[:, ys, xs, o:o + 1] * fp[:, ys, xs, :]
    return (ds * (1.0 / C)).to(first.dtype)


def shift_gradient(g: torch.Tensor) -> torch.Tensor:
    """``G'[v, w, o] = g[v-dy_o, w-dx_o, o]``, zero where that read falls
    outside the plane: ``g`` moved per displacement onto the pixel whose
    d_second term it feeds (what ``correlation_bwd.cu`` stages for
    d_second)."""
    B, H, W, _ = g.shape
    p = MAX_DISP
    gp = _pad_plane(g.float())
    return torch.stack([gp[:, p - dy:p - dy + H, p - dx:p - dx + W, o]
                        for o, (dy, dx) in enumerate(_offsets())], dim=-1)


def correlation_dsecond_shifted_plain(first: torch.Tensor,
                                      g: torch.Tensor) -> torch.Tensor:
    """d_second in the form ``correlation_bwd.cu`` computes it: ``(1/C)
    sum_o G'[v, w, o] * first[v-dy_o, w-dx_o, c]`` with ``G' =
    shift_gradient(g)``, d_first's sum with the operand's displacement
    mirrored. The CPU model of the kernel; the wrappers do not call it."""
    B, H, W, C = first.shape
    p = MAX_DISP
    fp = _pad_plane(first.float())
    gs = shift_gradient(g)
    ds = torch.zeros((B, H, W, C), dtype=torch.float32, device=first.device)
    for o, (dy, dx) in enumerate(_offsets()):
        ds = ds + gs[..., o:o + 1] * fp[:, p - dy:p - dy + H,
                                        p - dx:p - dx + W, :]
    return (ds * (1.0 / C)).to(first.dtype)


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_pair(op: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 4 or b.shape != a.shape:
        raise ValueError(f"{op}: first {tuple(a.shape)} and second "
                         f"{tuple(b.shape)} are not equal [B,H,W,C]")


def _check_grad(op: str, operand: torch.Tensor, g: torch.Tensor) -> None:
    if operand.ndim != 4 or g.shape != operand.shape[:3] + (NUM_OFFSETS,):
        raise ValueError(f"{op}: operand {tuple(operand.shape)} and g "
                         f"{tuple(g.shape)} are not [B,H,W,C], [B,H,W,81]")


def _launch_checks(op: str, *tensors: torch.Tensor, dtypes=()):
    kernels.require_cuda(op, *tensors, dtypes=dtypes)
    B, H, W, C = tensors[0].shape
    if C < 1:
        raise ValueError(f"{op}: kernel takes C >= 1, got C={C}")
    return B, H, W, C


def correlation_forward(first: torch.Tensor,
                        second: torch.Tensor) -> torch.Tensor:
    """The forward alone, no autograd: the kernel for CUDA tensors (float32
    or bfloat16, contiguous), :func:`correlation_plain` for CPU ones."""
    with annotate("op.correlation_forward"):
        _check_pair("cost_volume", first, second)
        if _on_cpu(first, second):
            return correlation_plain(first, second)
        fn = kernels.entry("cost_volume", "dbsr_correlation", first.dtype)
        B, H, W, C = _launch_checks("cost_volume", first, second,
                                    dtypes=(first.dtype,) * 2)
        out = first.new_empty((B, H, W, NUM_OFFSETS))
        kernels.launch("correlation", fn, (first, second, out), (B, H, W, C))
        cost_volume.launches += 1
        return out


def correlation_dfirst(second: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """d_first of the cost volume for the output gradient ``g``
    ``[B, H, W, 81]``: the kernel for CUDA tensors, the plain version for CPU
    ones."""
    with annotate("op.correlation_dfirst"):
        _check_grad("correlation_dfirst", second, g)
        if _on_cpu(second, g):
            return correlation_dfirst_plain(second, g)
        fn = kernels.entry("correlation_dfirst", "dbsr_correlation_dfirst",
                           second.dtype)
        B, H, W, C = _launch_checks("correlation_dfirst", second, g,
                                    dtypes=(second.dtype,) * 2)
        out = torch.empty_like(second)
        kernels.launch("correlation_bwd", fn, (second, g, out), (B, H, W, C))
        correlation_dfirst.launches += 1
        return out


def correlation_dsecond(first: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """d_second of the cost volume for the output gradient ``g``: the kernel
    for CUDA tensors, the plain version for CPU ones."""
    with annotate("op.correlation_dsecond"):
        _check_grad("correlation_dsecond", first, g)
        if _on_cpu(first, g):
            return correlation_dsecond_plain(first, g)
        fn = kernels.entry("correlation_dsecond", "dbsr_correlation_dsecond",
                           first.dtype)
        B, H, W, C = _launch_checks("correlation_dsecond", first, g,
                                    dtypes=(first.dtype,) * 2)
        out = torch.empty_like(first)
        kernels.launch("correlation_bwd", fn, (first, g, out), (B, H, W, C))
        correlation_dsecond.launches += 1
        return out


class _Correlation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, first, second):
        # d_first reads second and d_second reads first: each is kept only
        # for the gradient that will read it
        need_first, need_second = ctx.needs_input_grad
        ctx.save_for_backward(first if need_second else None,
                              second if need_first else None)
        return correlation_forward(first, second)

    @staticmethod
    def backward(ctx, g):
        first, second = ctx.saved_tensors
        g = g.contiguous()
        dfirst = (correlation_dfirst(second, g) if ctx.needs_input_grad[0]
                  else None)
        dsecond = (correlation_dsecond(first, g) if ctx.needs_input_grad[1]
                   else None)
        return dfirst, dsecond


def cost_volume(first: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """81-channel local cost volume of ``[B, H, W, C]`` features,
    differentiable in both: the CUDA kernels for CUDA tensors (float32 or
    bfloat16, any C >= 1), the plain versions for CPU tensors. A non-contiguous input
    (a broadcast target pyramid, a masked backwarp) is copied first."""
    return _Correlation.apply(first.contiguous(), second.contiguous())


cost_volume.launches = 0
correlation_dfirst.launches = 0
correlation_dsecond.launches = 0
