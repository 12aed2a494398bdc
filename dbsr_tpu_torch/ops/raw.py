"""Packed-RAW <-> flat Bayer conversions, channels-last (port of
``dbsr_tpu/ops/raw.py``).

The packed form is ``[..., H/2, W/2, 4]`` with the planes (R, Gr, Gb, B) of
an RGGB mosaic; the flat form is the full-resolution one-channel Bayer
image ``[..., H, W]``. These serve the host-side flips of the BurstSR
reader (``data/burstsr.py:BurstSRProcessing``), so they take and return
numpy arrays.
"""

from __future__ import annotations

import numpy as np


def pack_raw_image(im_raw: np.ndarray) -> np.ndarray:
    """Flat Bayer ``[..., H, W]`` -> packed ``[..., H/2, W/2, 4]`` (RGGB)."""
    return np.stack([im_raw[..., 0::2, 0::2], im_raw[..., 0::2, 1::2],
                     im_raw[..., 1::2, 0::2], im_raw[..., 1::2, 1::2]],
                    axis=-1)


def flatten_raw_image(im_packed: np.ndarray) -> np.ndarray:
    """Packed ``[..., h, w, 4]`` -> flat Bayer ``[..., 2h, 2w]``."""
    h, w = im_packed.shape[-3], im_packed.shape[-2]
    out = np.zeros(im_packed.shape[:-3] + (2 * h, 2 * w), im_packed.dtype)
    out[..., 0::2, 0::2] = im_packed[..., 0]
    out[..., 0::2, 1::2] = im_packed[..., 1]
    out[..., 1::2, 0::2] = im_packed[..., 2]
    out[..., 1::2, 1::2] = im_packed[..., 3]
    return out


def bayer_crop_to_rggb(im_flat: np.ndarray, pattern: str) -> np.ndarray:
    """Shift-crop a flat Bayer image so that its top-left 2x2 tile reads
    RGGB: BGGR drops a row and a column at each end, GRBG a column, GBRG a
    row."""
    pattern = pattern.lower()
    if pattern == "rggb":
        return im_flat
    if pattern == "grbg":
        return im_flat[..., :, 1:-1]
    if pattern == "gbrg":
        return im_flat[..., 1:-1, :]
    if pattern == "bggr":
        return im_flat[..., 1:-1, 1:-1]
    raise ValueError(f"unknown bayer pattern {pattern!r}")
