"""81-channel +-4 local cost volume (port of ``dbsr_tpu/ops/correlation.py``
forward):

    out[b, y, x, (dy+4)*9 + (dx+4)] = mean_c first[b, y, x, c]
                                             * second[b, y+dy, x+dx, c]

with zero padding outside ``second``. ``cost_volume`` launches the CUDA
kernel ``kernels/csrc/correlation.cu`` for a CUDA tensor (any plane size,
C up to 256) and runs ``correlation_plain`` for a CPU tensor.
``cost_volume.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dbsr_tpu_torch import kernels

MAX_DISP = 4
NUM_OFFSETS = (2 * MAX_DISP + 1) ** 2  # 81
_MAX_KERNEL_C = 256  # shared-memory limit of the kernel's staged tiles


def correlation_plain(first: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """Shifted-window cost volume, 81 shifted products and a channel mean:
    ``[B, H, W, C] x2 -> [B, H, W, 81]``."""
    B, H, W, C = first.shape
    p = MAX_DISP
    second_p = F.pad(second, (0, 0, p, p, p, p))
    outs = []
    for dy in range(-p, p + 1):
        for dx in range(-p, p + 1):
            shifted = second_p[:, dy + p:dy + p + H, dx + p:dx + p + W, :]
            outs.append((first * shifted).mean(dim=-1))
    return torch.stack(outs, dim=-1)


def cost_volume(first: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """81-channel local cost volume: the CUDA kernel for CUDA tensors
    (float32, contiguous), :func:`correlation_plain` for CPU tensors."""
    if first.ndim != 4 or second.shape != first.shape:
        raise ValueError(f"cost_volume: first {tuple(first.shape)} and second "
                         f"{tuple(second.shape)} are not equal [B,H,W,C]")
    if first.device.type == "cpu" and second.device.type == "cpu":
        return correlation_plain(first, second)
    kernels.require_cuda_f32("cost_volume", first, second)
    B, H, W, C = first.shape
    if not 0 < C <= _MAX_KERNEL_C:
        raise ValueError(f"cost_volume: kernel takes 0 < C <= {_MAX_KERNEL_C}, "
                         f"got C={C}")
    out = first.new_empty((B, H, W, NUM_OFFSETS))
    kernels.launch("correlation", "dbsr_correlation_f32", (first, second, out),
                   (B, H, W, C))
    cost_volume.launches += 1
    return out


cost_volume.launches = 0
