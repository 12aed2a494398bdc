"""Tensor-display helpers (port of ``dbsr_tpu/utils/plotting.py``).

Headless: a tensor renders to a uint8 image or a PNG file instead of a
window. Inputs are numpy arrays or torch tensors on any device, in
NHWC/HWC/HW layouts (a CHW tensor is detected and transposed). PNGs are
written by the port's own codec (``utils/png16.py``), not PIL.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dbsr_tpu_torch.utils.png16 import write_png


def _host(a) -> np.ndarray:
    """A numpy view of ``a`` on the host (a bf16 tensor as float32: numpy
    has no bf16)."""
    if torch.is_tensor(a):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def to_display(a, value_range: Tuple[Optional[float], Optional[float]]
               = (None, None)) -> np.ndarray:
    """Normalize any 2-4D tensor to a uint8 ``[H, W, 3]`` display image.

    Squeezes singleton dims, transposes CHW -> HWC when the first axis
    looks like channels, maps ``value_range`` (default: the data's min and
    max) to [0, 255], broadcasts grey to RGB and shows packed RGGB as
    (R, (Gr + Gb) / 2, B).
    """
    a = np.squeeze(np.asarray(_host(a), np.float32))
    if a.ndim == 3 and a.shape[0] in (1, 3) and a.shape[-1] not in (1, 3):
        a = np.transpose(a, (1, 2, 0))  # CHW -> HWC
    if a.ndim == 2:
        a = a[:, :, None]
    if a.ndim != 3:
        raise ValueError(f"cannot display tensor of shape {a.shape}")
    if a.shape[-1] == 1:
        a = np.repeat(a, 3, axis=-1)
    elif a.shape[-1] == 4:  # packed RGGB -> naive RGB for display
        a = np.stack([a[..., 0], 0.5 * (a[..., 1] + a[..., 2]), a[..., 3]],
                     axis=-1)
    elif a.shape[-1] != 3:
        a = a.mean(axis=-1, keepdims=True).repeat(3, axis=-1)

    lo = a.min() if value_range[0] is None else value_range[0]
    hi = a.max() if value_range[1] is None else value_range[1]
    a = (a - lo) / (hi - lo + 1e-12)
    return np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)


def save_tensor(a, path: str,
                value_range: Tuple[Optional[float], Optional[float]]
                = (None, None)) -> None:
    """Render the tensor (:func:`to_display`) to an 8-bit RGB PNG."""
    write_png(path, to_display(a, value_range))


def tensor_grid(tensors: Sequence, cols: int = 4, pad: int = 2,
                value_range=(None, None)) -> np.ndarray:
    """Tile tensors into one uint8 grid image (each tile padded to the
    largest tile's size), for bursts and feature maps."""
    tiles = [to_display(t, value_range) for t in tensors]
    th = max(t.shape[0] for t in tiles)
    tw = max(t.shape[1] for t in tiles)
    cols = max(1, min(cols, len(tiles)))
    rows = -(-len(tiles) // cols)
    grid = np.zeros((rows * (th + pad) - pad, cols * (tw + pad) - pad, 3),
                    np.uint8)
    for i, t in enumerate(tiles):
        r, c = divmod(i, cols)
        y = r * (th + pad)
        x = c * (tw + pad)
        grid[y:y + t.shape[0], x:x + t.shape[1]] = t
    return grid


def describe(a, name: str = "tensor") -> str:
    """One line: shape, dtype, min, mean and max of the finite values, and
    the count of non-finite ones. A tensor's dtype is named as numpy names
    it (a bf16 tensor's as float32)."""
    x = _host(a)
    finite = np.isfinite(x)
    fx = x[finite].astype(np.float64) if finite.any() else np.zeros(1)
    return (f"{name}: shape={tuple(x.shape)} dtype={x.dtype} "
            f"min={fx.min():.4g} mean={fx.mean():.4g} max={fx.max():.4g} "
            f"nonfinite={int((~finite).sum())}")
