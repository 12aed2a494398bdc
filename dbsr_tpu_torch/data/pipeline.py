"""Host-side crop extraction in numpy (port of
``dbsr_tpu/data/pipeline.py:23-82``): the random resized crop and the
centre crop that val-set generation takes from each source image, with the
half-pixel bilinear resize they need. Burst synthesis itself runs on the
device (``data/synthetic.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def random_resized_crop(rng: np.random.Generator, frame: np.ndarray,
                        crop_sz: Tuple[int, int],
                        scale_range: Optional[Tuple[float, float]] = None,
                        ar_range: Optional[Tuple[float, float]] = None,
                        ) -> np.ndarray:
    """Random crop with optional scale/aspect jitter, resized to
    ``crop_sz``: a crop of size ``crop_sz * scale * (1, ar)`` is taken at a
    random position and bilinearly resized to ``crop_sz``. ``frame`` is
    ``[H, W, 3]`` uint8 or float."""
    H, W = frame.shape[:2]
    ch, cw = crop_sz

    ar = 1.0 if ar_range is None else rng.uniform(*ar_range)
    max_scale = min(H / ch, W / (cw * ar))
    if max_scale < 1.0:
        scale = max_scale
    elif scale_range is not None:
        scale = rng.uniform(scale_range[0], min(scale_range[1], max_scale))
    else:
        scale = 1.0

    oh = int(np.floor(ch * scale))
    ow = int(np.floor(cw * ar * scale))
    oh, ow = min(oh, H), min(ow, W)
    r = rng.integers(0, H - oh + 1)
    c = rng.integers(0, W - ow + 1)
    crop = frame[r:r + oh, c:c + ow]
    if (oh, ow) != (ch, cw):
        crop = _resize_bilinear_np(crop, (ch, cw))
    return crop


def center_crop(frame: np.ndarray, crop_sz: Tuple[int, int]) -> np.ndarray:
    """The ``crop_sz`` window at the centre of ``frame``."""
    H, W = frame.shape[:2]
    ch, cw = crop_sz
    r = (H - ch) // 2
    c = (W - cw) // 2
    return frame[r:r + ch, c:c + cw]


def _resize_bilinear_np(im: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Half-pixel bilinear resize (no antialias, edge clamp), the convention
    of ``ops/interp.py:resize_bilinear``."""
    H, W = im.shape[:2]
    oh, ow = out_hw
    ys = (np.arange(oh) + 0.5) * (H / oh) - 0.5
    xs = (np.arange(ow) + 0.5) * (W / ow) - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    wy = np.clip(ys - np.floor(ys), 0, 1)[:, None, None]
    wx = np.clip(xs - np.floor(xs), 0, 1)[None, :, None]
    im = im.astype(np.float32)
    top = im[y0][:, x0] * (1 - wx) + im[y0][:, x1] * wx
    bot = im[y1][:, x0] * (1 - wx) + im[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy
