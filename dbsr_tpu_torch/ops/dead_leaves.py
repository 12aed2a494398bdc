"""The dead-leaves composite: ``L`` anti-aliased, shaded ellipses painted in
order over a background, every pixel of ``n`` images (the leaf loop of
``dbsr_tpu/data/procedural.py:dead_leaves_image``, which the JAX package
leaves to XLA).

A leaf is one row of a ``[n, L, 11]`` float32 table, its columns
``LEAF_PARAMS``: radius ``r``, centre ``(cx, cy)``, ``cos`` and ``sin`` of
its angle, aspect ``a``, colour (three), shading gradient ``(gx, gy)``
(``data/procedural.py:dead_leaves_table`` computes them from the draws).
At pixel ``(x, y)``::

    dx, dy = x - cx, y - cy
    xr = (cos*dx + sin*dy) * a
    yr = (-sin*dx + cos*dy) / a
    d = sqrt(xr*xr + yr*yr + 1e-8)
    cover = clamp(0.5 + (r - d), 0, 1)
    shade = 1 + GRAD_AMP * (gx*xr + gy*yr) / r
    img = img * (1 - cover) + (colour * shade) * cover

``dead_leaves_composite`` launches ``kernels/csrc/dead_leaves.cu`` for CUDA
tensors, which does each pixel's ``L`` leaves in registers with the same
float32 operations in the same order, so its image has the bits of
``dead_leaves_composite_plain`` on the same card; for CPU tensors it runs
the plain version, one round of full-image passes a leaf.
``dead_leaves_composite.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dbsr_tpu_torch import kernels
from dbsr_tpu_torch.utils.profiling import annotate

# the shading amplitude (the JAX package's default); the kernel's source
# holds the same constant
GRAD_AMP = 0.35
LEAF_PARAMS = ("r", "cx", "cy", "cos", "sin", "a", "red", "green", "blue",
               "gx", "gy")


def dead_leaves_composite_plain(bg: torch.Tensor, table: torch.Tensor,
                                hw: Tuple[int, int]) -> torch.Tensor:
    """Plain version: ``bg`` ``[n, 3]`` and ``table`` ``[n, L, 11]`` ->
    ``[n, H, W, 3]``, the leaves painted one by one over whole images."""
    H, W = hw
    n = bg.shape[0]
    img = bg[:, None, None, :].expand(n, H, W, 3)
    ys = torch.arange(H, dtype=torch.float32, device=bg.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=bg.device)[None, :]

    def col(v):  # per-image scalar [n] -> [n, 1, 1]
        return v[:, None, None]

    for i in range(table.shape[1]):
        r, cx, cy, ct, st, a, _, _, _, gx, gy = (
            col(table[:, i, k]) for k in range(len(LEAF_PARAMS)))
        color = table[:, i, 6:9]
        dx = xs - cx
        dy = ys - cy
        xr = (ct * dx + st * dy) * a
        yr = (-st * dx + ct * dy) / a
        d = torch.sqrt(xr * xr + yr * yr + 1e-8)
        cover = (0.5 + (r - d)).clamp(0.0, 1.0)
        shade = 1.0 + GRAD_AMP * (gx * xr + gy * yr) / r
        c = color[:, None, None, :] * shade[..., None]
        img = img * (1.0 - cover[..., None]) + c * cover[..., None]
    return img


def dead_leaves_composite(bg: torch.Tensor, table: torch.Tensor,
                          hw: Tuple[int, int]) -> torch.Tensor:
    """Paint the leaves of ``table`` ``[n, L, 11]`` over the backgrounds
    ``bg`` ``[n, 3]`` (float32): ``[n, H, W, 3]`` float32. The CUDA kernel
    for CUDA tensors (contiguous), the plain version for CPU tensors."""
    with annotate("op.dead_leaves_composite"):
        H, W = hw
        if bg.ndim != 2 or bg.shape[1] != 3 or table.ndim != 3 \
                or table.shape[0] != bg.shape[0] \
                or table.shape[2] != len(LEAF_PARAMS):
            raise ValueError(
                f"dead_leaves_composite: bg {tuple(bg.shape)} and table "
                f"{tuple(table.shape)} are not [n,3], "
                f"[n,L,{len(LEAF_PARAMS)}]")
        for t in (bg, table):
            if t.dtype != torch.float32:
                raise TypeError("dead_leaves_composite: takes float32, got "
                                f"{t.dtype}")
        if bg.device.type == "cpu" and table.device.type == "cpu":
            return dead_leaves_composite_plain(bg, table, hw)
        kernels.require_cuda("dead_leaves_composite", bg, table)
        n, L = table.shape[:2]
        out = bg.new_empty((n, H, W, 3))
        kernels.launch("dead_leaves", "dbsr_dead_leaves_composite_f32",
                       (bg, table, out), (n, L, H, W))
        dead_leaves_composite.launches += 1
        return out


dead_leaves_composite.launches = 0
