"""PyTorch/CUDA port of ``dbsr_tpu`` for NVIDIA Hopper (H100).

The JAX package ``dbsr_tpu`` is the reference; module names here mirror it
(``ops/interp.py`` <-> ``ops/interp.py``, ...). Public functions keep the JAX
layout: bursts ``[B, N, h, w, 4]``, predictions ``[B, H, W, 3]``, flows
``[..., H, W, 2]`` in (x, y) order. The TPU's Pallas kernels are replaced by
hand-written CUDA kernels (``kernels/csrc``), each with a plain PyTorch
version beside its wrapper: the wrapper runs the plain version only for a
tensor on the CPU, and launches the kernel (or raises) for a CUDA tensor.

This package imports neither JAX nor anything of ``dbsr_tpu``.
"""

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no card raises
    (nothing silently runs on the CPU in its place)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev
