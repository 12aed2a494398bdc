"""Exact fine-resolution 3x3 SAME conv on the phase-major space-to-depth-2
("s2d") layout (port of ``dbsr_tpu/ops/conv_s2d_pallas.py``).

``x`` ``[B, H2, W2, 4C]`` holds the fine ``[B, 2*H2, 2*W2, C]`` tensor with
fine pixel ``(2Y+qy, 2X+qx)``, channel ``c`` at channel ``(qy*2+qx)*C + c``
of coarse pixel ``(Y, X)``; the output ``[B, H2, W2, 4O]`` has the same
layout. Weights are the port's fine ``[O, C, 3, 3]`` (OIHW); the layout is
compute-only.

* :func:`conv3x3_s2d_plain` is the JAX package's fine-patch formulation
  (``_conv3x3_block_impl``): each coarse pixel's fine 4x4 window as a
  ``[16C]`` patch row (pieces in ``_SLOT`` order) times :func:`block_weight`
  ``[16C, 4O]``.
* :func:`conv3x3_s2d` is differentiable (``Conv3x3S2D``). For CUDA tensors
  (float32, or bfloat16: the TPU kernel's bf16 matmul, the weight rounded
  to bf16, float32 accumulation, one rounding of the output) its forward
  launches ``kernels/csrc/conv_s2d.cu``, which skips the block weight's
  zero slots, and its d_input launches the same kernel, in the output
  gradient's type, with ``weight.flip(2, 3).transpose(0, 1)``. d_kernel is
  :func:`conv3x3_s2d_dweight`: for bfloat16 CUDA operands
  ``kernels/csrc/conv_s2d_dweight.cu`` (bf16 tensor-core products, exact
  in float32, float32 sums, read straight from the s2d layout; the JAX
  package computes the term with XLA at the same precision); for float32
  CUDA operands PyTorch's float32 conv weight gradient of the
  fine-resolution conv on the unfolded ``x`` and output gradient, TF32 off.
  For CPU tensors the same ``Function`` runs the plain versions. It keeps
  ``x`` only when the weight needs a gradient and the weight only when
  ``x`` does, and is bypassed when no gradient is needed. The conv
  kernel's launches (forward and d_input) are counted in
  ``conv3x3_s2d.launches``, the weight gradient's in
  ``conv3x3_s2d_dweight.launches``.
* :func:`conv3x3_s2d_auto` dispatches: a CUDA tensor takes
  :func:`conv3x3_s2d` unless ``DBSR_FINE_PATCH_S2D=0`` (read per call); a
  CPU tensor keeps the JAX package's dispatch, :func:`conv3x3_s2d` only
  with ``DBSR_FINE_PATCH_S2D=1``; ``force`` wins over both. The other
  branch is the structured-dense conv, one ``F.conv2d`` with
  ``s2d_conv_kernel`` weights (``models/layers.py``).
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import torch
import torch.nn.functional as F

from dbsr_tpu_torch import kernels
from dbsr_tpu_torch.utils.profiling import annotate

FINE_PATCH_ENV = "DBSR_FINE_PATCH_S2D"
_OC_BLOCK = 32  # output channels per kernel block: the weight's O padding

# (row/col offset into the 1-coarse-pixel-padded array, fine phase) for fine
# tap index t in 0..3: fine coord = 2*Y + t - 1
_PIECE = ((0, 1), (1, 0), (1, 1), (2, 0))


def _slot_table():
    """Patch slot of each piece ``(ty, tx)``: slot ``s`` with ``s % 4`` equal
    to the piece's input phase (the JAX package's lane-aligned order)."""
    free = {q: [s for s in range(16) if s % 4 == q] for q in range(4)}
    slots = []
    for ty in range(4):
        for tx in range(4):
            q = _PIECE[ty][1] * 2 + _PIECE[tx][1]
            slots.append(free[q].pop(0))
    return tuple(slots)


_SLOT = _slot_table()
_PIECE_OF_SLOT = tuple(_SLOT.index(s) for s in range(16))


def _tap_selection(device, dtype) -> torch.Tensor:
    """``sel[t, p, u]`` ``[4, 2, 3]``: 1 where patch tap ``t`` of output
    phase ``p`` is the fine tap ``u = t - p`` (in 0..2), else 0."""
    t = torch.arange(4, device=device).view(4, 1, 1)
    p = torch.arange(2, device=device).view(1, 2, 1)
    u = torch.arange(3, device=device).view(1, 1, 3)
    return (u == t - p).to(dtype)


def block_weight(weight: torch.Tensor) -> torch.Tensor:
    """The fine-patch weight matrix ``[16C, 4O]`` of an OIHW ``[O, C, 3, 3]``
    weight, equal to the JAX package's ``block_weight`` of the same HWIO
    kernel: row ``_SLOT[ty*4+tx]*C + c``, column ``(py*2+px)*O + o`` holds
    ``weight[o, c, ty-py, tx-px]`` where both taps lie in 0..2, else 0.
    Built by a 0/1 selection times the weight and a sum with at most one
    non-zero term, so every entry is exactly the weight's."""
    O, C = weight.shape[:2]
    sel = _tap_selection(weight.device, weight.dtype)
    # [ty, tx, c, py, px, o]
    #     = sum_{u, v} sel[ty, py, u] sel[tx, px, v] w[o, c, u, v]
    s2 = (sel.view(4, 1, 1, 2, 1, 1, 3, 1)
          * sel.view(1, 4, 1, 1, 2, 1, 1, 3))
    wt = weight.permute(1, 0, 2, 3).reshape(1, 1, C, 1, 1, O, 3, 3)
    wm = (s2 * wt).sum((-2, -1)).reshape(16, C, 4 * O)
    return torch.stack([wm[t] for t in _PIECE_OF_SLOT]).reshape(16 * C, 4 * O)


def _check(op: str, x: torch.Tensor, weight: torch.Tensor):
    if (x.ndim != 4 or x.shape[-1] % 4 or weight.ndim != 4
            or tuple(weight.shape[1:]) != (x.shape[-1] // 4, 3, 3)):
        raise ValueError(f"{op}: x {tuple(x.shape)} and weight "
                         f"{tuple(weight.shape)} are not [B,H2,W2,4C], "
                         "[O,C,3,3]")
    return x.shape[:3] + (x.shape[-1] // 4, weight.shape[0])


def _patch_rows(x: torch.Tensor, C: int) -> torch.Tensor:
    """Each coarse pixel's fine 4x4 window of ``x`` ``[B, H2, W2, 4C]``,
    padded by one coarse pixel, as a ``[B, H2, W2, 16C]`` patch row: the 16
    fine-aligned ``[.., C]`` pieces in ``_SLOT`` order."""
    H2, W2 = x.shape[1:3]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    pieces = [None] * 16
    for ty in range(4):
        off_y, py = _PIECE[ty]
        for tx in range(4):
            off_x, px = _PIECE[tx]
            q = py * 2 + px
            pieces[_SLOT[ty * 4 + tx]] = xp[
                :, off_y:off_y + H2, off_x:off_x + W2, q * C:(q + 1) * C]
    return torch.cat(pieces, dim=-1)


def conv3x3_s2d_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The fine 3x3 SAME conv of ``x`` ``[B, H2, W2, 4C]`` (phase-major s2d)
    with ``weight`` ``[O, C, 3, 3]`` -> ``[B, H2, W2, 4O]``, as
    ``_conv3x3_block_impl``: pad one coarse pixel, the 16 fine-aligned
    ``[.., C]`` pieces as ``[16C]`` patch rows in ``_SLOT`` order, times
    :func:`block_weight`. Plain tensor ops, differentiable. For a bfloat16
    ``x``: the same in float32 on ``x`` and the weight rounded to bf16,
    rounded once to bf16 (float32 matmuls on the card run without TF32
    unless asked)."""
    C = _check("conv3x3_s2d_plain", x, weight)[3]
    if x.dtype == torch.bfloat16:
        return conv3x3_s2d_plain(x.float(),
                                 weight.to(x.dtype).float()).to(x.dtype)
    return _patch_rows(x, C) @ block_weight(weight).to(x.dtype)


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def bf16_fragments(weight: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's weights: ``weight`` ``[O, C, 3, 3]`` rounded to
    bf16, zero-padded to C % 16 == 0 and O % 32 == 0, in the MMA fragments'
    order ``[C/16, O/32, tap, n8, g, t, j]``: output channel ``ob*32 + n8*8
    + g``, input channel ``s*16 + 4t + j`` (``conv_s2d.cu``)."""
    O, C = weight.shape[:2]
    cp, op = -(-C // 16) * 16, -(-O // _OC_BLOCK) * _OC_BLOCK
    w = F.pad(weight.to(torch.bfloat16), (0, 0, 0, 0, 0, cp - C, 0, op - O))
    w = w.reshape(op // _OC_BLOCK, 4, 8, cp // 16, 4, 4, 9)
    return w.permute(3, 0, 6, 1, 2, 4, 5).contiguous()


def conv3x3_s2d_forward(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The conv alone, no autograd: the kernel for CUDA tensors (float32 or
    bfloat16 ``x``, contiguous; the weight float32, rounded to bf16 for a
    bf16 ``x``), :func:`conv3x3_s2d_plain` for CPU ones."""
    with annotate("op.conv3x3_s2d_forward"):
        B, H2, W2, C, O = _check("conv3x3_s2d", x, weight)
        if _on_cpu(x, weight):
            return conv3x3_s2d_plain(x, weight)
        fn = kernels.entry("conv3x3_s2d", "dbsr_conv_s2d", x.dtype)
        if x.dtype == torch.bfloat16:
            wk = bf16_fragments(weight)
        else:
            # [C, 9, Op]: the kernel reads 8 consecutive output channels
            # per load
            op = -(-O // _OC_BLOCK) * _OC_BLOCK
            wk = F.pad(weight.permute(1, 2, 3, 0).reshape(C, 9, O),
                       (0, op - O)).contiguous()
        kernels.require_cuda("conv3x3_s2d", x, wk, dtypes=(x.dtype,) * 2)
        out = x.new_empty((B, H2, W2, 4 * O))
        kernels.launch("conv_s2d", fn, (x, wk, out), (B, H2, W2, C, O))
        conv3x3_s2d.launches += 1
        return out


def rotate_weight(weight: torch.Tensor) -> torch.Tensor:
    """The weight of d_input: a SAME 3x3 conv's input gradient is the SAME
    conv of the output gradient with the spatially flipped, in/out-swapped
    kernel."""
    return weight.flip(2, 3).transpose(0, 1)


def _check_dweight(x: torch.Tensor, g: torch.Tensor, weight_shape):
    O, C = tuple(weight_shape)[:2]
    if (x.ndim != 4 or g.ndim != 4 or x.shape[:3] != g.shape[:3]
            or tuple(weight_shape) != (O, C, 3, 3) or x.shape[-1] != 4 * C
            or g.shape[-1] != 4 * O):
        raise ValueError(f"conv3x3_s2d_dweight: x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)} and weight {tuple(weight_shape)} "
                         "are not [B,H2,W2,4C], [B,H2,W2,4O], [O,C,3,3]")
    return O, C


def conv3x3_s2d_dweight_plain(x: torch.Tensor, g: torch.Tensor,
                              weight_shape) -> torch.Tensor:
    """The weight gradient ``[O, C, 3, 3]`` of :func:`conv3x3_s2d_plain` at
    ``x`` ``[B, H2, W2, 4C]`` for the output gradient ``g`` ``[B, H2, W2,
    4O]``, in the forward's fine-patch form: the ``[16C]`` patch rows (pieces
    in ``_SLOT`` order) transposed times ``g``, the gradient of the block
    weight, folded back by the adjoint of :func:`block_weight` (each tap
    summed over the (slot, phase) pairs that hold it). Float32 for bf16
    operands (their products are exact there), else their own type."""
    O, C = _check_dweight(x, g, weight_shape)
    dtype = torch.promote_types(x.dtype, g.dtype)
    if dtype == torch.bfloat16:
        dtype = torch.float32
    rows = _patch_rows(x.to(dtype), C).reshape(-1, 16 * C)
    dwm = (rows.t() @ g.to(dtype).reshape(-1, 4 * O)).reshape(16, C, 2, 2, O)
    # in piece order: [ty, tx, c, py, px, o]
    dwm = torch.stack([dwm[s] for s in _SLOT]).reshape(4, 4, C, 2, 2, O)
    sel = _tap_selection(x.device, dtype)
    return torch.einsum("aiu,bjv,abcijo->ocuv", sel, sel, dwm)


@functools.lru_cache(maxsize=256)
def _dweight_scratch_floats(B: int, H2: int, W2: int, C: int, O: int,
                            sms: int) -> int:
    """Floats of the weight gradient kernel's partials on a card of ``sms``
    multiprocessors, as its C source sizes them (its grid is decided there
    alone)."""
    fn = kernels.library("conv_s2d_dweight") \
        .dbsr_conv_s2d_dweight_scratch_floats
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_longlong
    return fn(B, H2, W2, C, O, sms)


def conv3x3_s2d_dweight(x: torch.Tensor, g: torch.Tensor,
                        weight_shape) -> torch.Tensor:
    """The weight gradient ``[O, C, 3, 3]``, float32, of the fine 3x3 SAME
    conv at ``x`` ``[B, H2, W2, 4C]`` for the output gradient ``g`` ``[B,
    H2, W2, 4O]`` (phase-major s2d): ``kernels/csrc/conv_s2d_dweight.cu``
    for bfloat16 CUDA tensors (contiguous), :func:`conv3x3_s2d_dweight_plain`
    for CPU ones; other CUDA tensors raise."""
    with annotate("op.conv3x3_s2d_dweight"):
        O, C = _check_dweight(x, g, weight_shape)
        if _on_cpu(x, g):
            return conv3x3_s2d_dweight_plain(x, g, weight_shape)
        kernels.require_cuda("conv3x3_s2d_dweight", x, g,
                             dtypes=(torch.bfloat16,) * 2)
        sizes = (*x.shape[:3], C, O, torch.cuda.get_device_properties(
            x.device).multi_processor_count)
        partial = x.new_empty(_dweight_scratch_floats(*sizes),
                              dtype=torch.float32)
        out = x.new_empty((O, C, 3, 3), dtype=torch.float32)
        kernels.launch("conv_s2d_dweight", "dbsr_conv_s2d_dweight_bf16",
                       (x, g, partial, out), sizes)
        conv3x3_s2d_dweight.launches += 1
        return out


conv3x3_s2d_dweight.launches = 0


def _unfold_nchw(x: torch.Tensor) -> torch.Tensor:
    from dbsr_tpu_torch.models.layers import depth_to_space_phase_major
    return depth_to_space_phase_major(x, 2).float().permute(0, 3, 1, 2)


class Conv3x3S2D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight):
        # d_input reads the weight and d_kernel reads x
        need_dx, need_dk = ctx.needs_input_grad
        ctx.save_for_backward(x if need_dk else None,
                              weight if need_dx else None)
        ctx.weight_shape, ctx.weight_dtype = weight.shape, weight.dtype
        return conv3x3_s2d_forward(x, weight)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.contiguous()
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_s2d_forward(g, rotate_weight(weight))
        if ctx.needs_input_grad[1] and x.is_cuda \
                and x.dtype != torch.bfloat16:
            # float32 on the card: products not exact in bf16, so cuDNN's
            # float32 weight gradient on the unfolded tensors
            cudnn = torch.backends.cudnn
            tf32, cudnn.allow_tf32 = cudnn.allow_tf32, False
            try:
                dk = torch.nn.grad.conv2d_weight(
                    _unfold_nchw(x), ctx.weight_shape, _unfold_nchw(g),
                    padding=1).to(ctx.weight_dtype)
            finally:
                cudnn.allow_tf32 = tf32
        elif ctx.needs_input_grad[1]:
            dk = conv3x3_s2d_dweight(x, g, ctx.weight_shape).to(
                ctx.weight_dtype)
        return dx, dk


def conv3x3_s2d(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Fine 3x3 SAME conv on the phase-major s2d layout, differentiable in
    ``x`` and ``weight``: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. Bias is the caller's."""
    x = x.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return Conv3x3S2D.apply(x, weight)
    return conv3x3_s2d_forward(x, weight)


conv3x3_s2d.launches = 0


def conv3x3_s2d_auto(x: torch.Tensor, weight: torch.Tensor,
                     force: Optional[bool] = None) -> torch.Tensor:
    """The fine-patch conv (:func:`conv3x3_s2d`) for a CUDA tensor unless
    ``DBSR_FINE_PATCH_S2D=0``, for a CPU one only with
    ``DBSR_FINE_PATCH_S2D=1`` (the JAX package's dispatch), or as ``force``
    says; else the structured-dense conv, one 3x3 SAME ``F.conv2d`` over
    the s2d tensor with the ``[4O, 4C, 3, 3]`` kernel of
    ``s2d_conv_kernel``."""
    if force is None:
        switch = os.environ.get(FINE_PATCH_ENV)
        fine_patch = switch != "0" if x.is_cuda else switch == "1"
    else:
        fine_patch = force
    if fine_patch:
        return conv3x3_s2d(x, weight)
    from dbsr_tpu_torch.models.layers import s2d_conv_kernel
    return F.conv2d(x.permute(0, 3, 1, 2), s2d_conv_kernel(weight).to(x.dtype),
                    padding=1).permute(0, 2, 3, 1)
