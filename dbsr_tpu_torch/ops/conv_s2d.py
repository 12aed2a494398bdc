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
  (float32) its forward launches ``kernels/csrc/conv_s2d.cu``, which skips
  the block weight's zero slots, and its d_input launches the same kernel
  with ``weight.flip(2, 3).transpose(0, 1)``; d_kernel is PyTorch's conv
  weight gradient of the fine-resolution conv on the unfolded ``x`` and
  output gradient (the JAX package computes that term with XLA too). For
  CPU tensors the same ``Function`` runs the plain version. It keeps ``x``
  only when the weight needs a gradient and the weight only when ``x``
  does, and is bypassed when no gradient is needed. The kernel's launches
  (forward and d_input) are counted in ``conv3x3_s2d.launches``.
* :func:`conv3x3_s2d_auto` is the JAX package's dispatch:
  ``DBSR_FINE_PATCH_S2D=1`` (read per call) or ``force=True`` selects
  :func:`conv3x3_s2d`; otherwise the structured-dense conv, one
  ``F.conv2d`` with ``s2d_conv_kernel`` weights (``models/layers.py``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

from dbsr_tpu_torch import kernels

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


def block_weight(weight: torch.Tensor) -> torch.Tensor:
    """The fine-patch weight matrix ``[16C, 4O]`` of an OIHW ``[O, C, 3, 3]``
    weight, equal to the JAX package's ``block_weight`` of the same HWIO
    kernel: row ``_SLOT[ty*4+tx]*C + c``, column ``(py*2+px)*O + o`` holds
    ``weight[o, c, ty-py, tx-px]`` where both taps lie in 0..2, else 0.
    Built by a 0/1 selection times the weight and a sum with at most one
    non-zero term, so every entry is exactly the weight's."""
    O, C = weight.shape[:2]
    # sel[t, p, u] = 1 where the fine tap u = t - p lies in 0..2
    t = torch.arange(4, device=weight.device).view(4, 1, 1)
    p = torch.arange(2, device=weight.device).view(1, 2, 1)
    u = torch.arange(3, device=weight.device).view(1, 1, 3)
    sel = (u == t - p).to(weight.dtype)
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


def conv3x3_s2d_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The fine 3x3 SAME conv of ``x`` ``[B, H2, W2, 4C]`` (phase-major s2d)
    with ``weight`` ``[O, C, 3, 3]`` -> ``[B, H2, W2, 4O]``, as
    ``_conv3x3_block_impl``: pad one coarse pixel, the 16 fine-aligned
    ``[.., C]`` pieces as ``[16C]`` patch rows in ``_SLOT`` order, times
    :func:`block_weight`. Plain tensor ops, differentiable."""
    B, H2, W2, C, O = _check("conv3x3_s2d_plain", x, weight)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    pieces = [None] * 16
    for ty in range(4):
        off_y, py = _PIECE[ty]
        for tx in range(4):
            off_x, px = _PIECE[tx]
            q = py * 2 + px
            pieces[_SLOT[ty * 4 + tx]] = xp[
                :, off_y:off_y + H2, off_x:off_x + W2, q * C:(q + 1) * C]
    return torch.cat(pieces, dim=-1) @ block_weight(weight).to(x.dtype)


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def conv3x3_s2d_forward(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The conv alone, no autograd: the kernel for CUDA tensors (float32,
    ``x`` contiguous), :func:`conv3x3_s2d_plain` for CPU ones."""
    B, H2, W2, C, O = _check("conv3x3_s2d", x, weight)
    if _on_cpu(x, weight):
        return conv3x3_s2d_plain(x, weight)
    # [C, 9, Op]: the kernel reads 8 consecutive output channels per load
    op = -(-O // _OC_BLOCK) * _OC_BLOCK
    wk = F.pad(weight.permute(1, 2, 3, 0).reshape(C, 9, O),
               (0, op - O)).contiguous()
    kernels.require_cuda_f32("conv3x3_s2d", x, wk)
    out = x.new_empty((B, H2, W2, 4 * O))
    kernels.launch("conv_s2d", "dbsr_conv_s2d_f32", (x, wk, out),
                   (B, H2, W2, C, O))
    conv3x3_s2d.launches += 1
    return out


def rotate_weight(weight: torch.Tensor) -> torch.Tensor:
    """The weight of d_input: a SAME 3x3 conv's input gradient is the SAME
    conv of the output gradient with the spatially flipped, in/out-swapped
    kernel."""
    return weight.flip(2, 3).transpose(0, 1)


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
        ctx.weight_shape = weight.shape
        return conv3x3_s2d_forward(x, weight)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.contiguous()
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_s2d_forward(g, rotate_weight(weight))
        if ctx.needs_input_grad[1]:
            dk = torch.nn.grad.conv2d_weight(
                _unfold_nchw(x), ctx.weight_shape, _unfold_nchw(g), padding=1)
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
    """The JAX package's dispatch: the fine-patch conv (:func:`conv3x3_s2d`)
    when ``DBSR_FINE_PATCH_S2D=1`` or ``force`` is True, else the
    structured-dense conv, one 3x3 SAME ``F.conv2d`` over the s2d tensor
    with the ``[4O, 4C, 3, 3]`` kernel of ``s2d_conv_kernel``. ``force``
    wins over the environment."""
    fine_patch = (os.environ.get(FINE_PATCH_ENV) == "1" if force is None
                  else force)
    if fine_patch:
        return conv3x3_s2d(x, weight)
    from dbsr_tpu_torch.models.layers import s2d_conv_kernel
    return F.conv2d(x.permute(0, 3, 1, 2), s2d_conv_kernel(weight).to(x.dtype),
                    padding=1).permute(0, 2, 3, 1)
