"""Host-side dataset readers (port of ``dbsr_tpu/data/datasets.py``),
channels-last numpy arrays: the single-image datasets that synthetic
training and val-set generation draw source images from (``ZurichRAW2RGB``,
``ImageFolder``), and the SyntheticBurstVal reader and writer, the
pre-generated validation set of the synthetic protocol, PNGs through
``utils/native_io.read_png`` (the native decoder, else the port's
``utils/png16.py``), as the JAX package reads them.

Source images load as uint8 RGB ``[H, W, 3]``: JPEGs through the native
libjpeg decoder (``utils/native_io.py``), else PIL where it is installed;
PNGs through ``native_io.read_png`` (png16 for what the native decoder
refuses, a palette or interlaced file); anything else through PIL. A file
nothing here can decode raises an error that names what is missing.

Sets this writer (or the JAX package's) made carry a ``format.json``
marker and hold RGB channel order; sets without it were written by OpenCV,
whose first and third channels are swapped (``cv2_channel_order``).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Optional

import numpy as np
import torch

from dbsr_tpu_torch.utils.native_io import read_png
from dbsr_tpu_torch.utils.png16 import write_png

_SCALE = 2 ** 14  # uint16 PNGs hold values in [0, 1] at this scale


def _pil_rgb(path: str, why: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{path}: cannot decode: {why}, and PIL is not "
                           "installed") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _png_rgb(path: str) -> np.ndarray:
    """An 8-bit PNG as RGB, as PIL's ``convert("RGB")`` gives it: grey
    repeated, alpha dropped."""
    try:
        im = read_png(path)
    except ValueError:  # the native decoder's refusal: png16 says why
        from dbsr_tpu_torch.utils.png16 import read_png as py_read
        im = py_read(path)
    if im.dtype != np.uint8:
        raise ValueError(f"{path}: a {im.dtype.itemsize * 8}-bit PNG; source "
                         "images are 8-bit")
    if im.shape[-1] in (1, 2):
        return np.repeat(im[..., :1], 3, axis=-1)
    return np.ascontiguousarray(im[..., :3])


def _load_image(path: str) -> np.ndarray:
    """Load an 8-bit image as uint8 RGB ``[H, W, 3]``."""
    lower = path.lower()
    if lower.endswith((".jpg", ".jpeg")):
        from dbsr_tpu_torch.utils.native_io import NativeUnavailable, read_jpeg
        try:
            return read_jpeg(path)
        except NativeUnavailable as e:
            return _pil_rgb(path, f"the native JPEG decoder is unavailable "
                                  f"({e})")
    if lower.endswith(".png"):
        try:
            return _png_rgb(path)
        except ValueError as e:
            if "color type" not in str(e):  # a palette PNG: PIL reads it
                raise
            return _pil_rgb(path, str(e))
    return _pil_rgb(path, f"no decoder of the port reads "
                          f"{os.path.splitext(path)[1] or 'this file'}")


def image_size(path: str):
    """``(H, W)`` of a PNG, JPEG or BMP from its header alone (the draws of
    a data-parallel rank's other rows need the size, not the pixels);
    another file is decoded."""
    with open(path, "rb") as f:
        head = f.read(26)
        if head[:8] == b"\x89PNG\r\n\x1a\n":
            return (int.from_bytes(head[20:24], "big"),
                    int.from_bytes(head[16:20], "big"))
        if head[:2] == b"BM":
            return (abs(int.from_bytes(head[22:26], "little", signed=True)),
                    int.from_bytes(head[18:22], "little", signed=True))
        if head[:2] == b"\xff\xd8":
            f.seek(2)
            while True:
                marker = f.read(2)
                if len(marker) < 2 or marker[0] != 0xFF:
                    break
                seg = int.from_bytes(f.read(2), "big")
                # SOF0-SOF15, but DHT (C4), JPG (C8) and DAC (CC)
                if 0xC0 <= marker[1] <= 0xCF and marker[1] not in (
                        0xC4, 0xC8, 0xCC):
                    sof = f.read(5)
                    return (int.from_bytes(sof[1:3], "big"),
                            int.from_bytes(sof[3:5], "big"))
                f.seek(seg - 2, 1)
    return _load_image(path).shape[:2]


class BaseImageDataset:
    """Single-image dataset contract: ``get_num_images()`` and
    ``get_image(i) -> (uint8 [H, W, 3], info)``."""

    def __init__(self, name: str, root: str):
        self.name = name
        self.root = root

    def get_name(self) -> str:
        return self.name

    def get_num_images(self) -> int:
        raise NotImplementedError

    def __len__(self):
        return self.get_num_images()

    def get_image(self, im_id: int, info: Optional[dict] = None):
        raise NotImplementedError

    def get_image_info(self, im_id: int) -> dict:
        return {}


class ZurichRAW2RGB(BaseImageDataset):
    """Canon sRGB images of the Zurich RAW-to-RGB dataset, the synthesis
    source: ``<root>/<split>/canon/{i}.jpg``, 46,839 train / 1,204 test. A
    partial copy is trusted when its listing holds fewer JPEGs."""

    SPLIT_SIZES = {"train": 46839, "test": 1204}

    def __init__(self, root: str, split: str = "train"):
        super().__init__("ZurichRAW2RGB", root)
        if split not in self.SPLIT_SIZES:
            raise ValueError(f"unknown split {split!r}")
        self.split = split
        self.img_pth = os.path.join(root, split, "canon")
        n = self.SPLIT_SIZES[split]
        if os.path.isdir(self.img_pth):
            present = len([f for f in os.listdir(self.img_pth)
                           if f.endswith(".jpg")])
            n = min(n, present) if present else n
        self.image_list = [f"{i:d}.jpg" for i in range(n)]

    def get_num_images(self) -> int:
        return len(self.image_list)

    def get_image(self, im_id: int, info: Optional[dict] = None):
        frame = _load_image(os.path.join(self.img_pth, self.image_list[im_id]))
        return frame, info if info is not None else {}

    def get_image_shape(self, im_id: int):
        return image_size(os.path.join(self.img_pth, self.image_list[im_id]))


class ImageFolder(BaseImageDataset):
    """A folder of images (``.jpg``, ``.jpeg``, ``.png``, ``.bmp``), sorted
    by name."""

    EXTS = (".jpg", ".jpeg", ".png", ".bmp")

    def __init__(self, root: str, name: str = "ImageFolder"):
        super().__init__(name, root)
        self.image_list = sorted(
            f for f in os.listdir(root) if f.lower().endswith(self.EXTS))

    def get_num_images(self) -> int:
        return len(self.image_list)

    def get_image(self, im_id: int, info: Optional[dict] = None):
        frame = _load_image(os.path.join(self.root, self.image_list[im_id]))
        return frame, info if info is not None else {}

    def get_image_shape(self, im_id: int):
        return image_size(os.path.join(self.root, self.image_list[im_id]))


class SyntheticBurstVal:
    """The validation set: per index, ``bursts/{idx:04d}/im_raw_{i:02d}.png``
    (uint16 at 2^14, 4-channel packed RGGB) and ``gt/{idx:04d}/im_rgb.png``
    with ``meta_info.pkl``.

    Returns numpy: burst ``[14, 48, 48, 4]`` float32, gt ``[384, 384, 3]``
    float32 and the meta dict with its ``burst_name``.
    """

    def __init__(self, root: str, burst_size: int = 14,
                 cv2_channel_order: Optional[bool] = None,
                 num_bursts: Optional[int] = None):
        """``num_bursts=None`` infers the set's size from ``gt/`` (300, the
        reference set's, when it holds none)."""
        self.root = root
        if num_bursts is None:
            gt_dir = os.path.join(root, "gt")
            if os.path.isdir(gt_dir):
                num_bursts = sum(
                    1 for d in os.listdir(gt_dir)
                    if d.isdigit() and os.path.isdir(
                        os.path.join(gt_dir, d)))
            if not num_bursts:
                num_bursts = 300
        self.burst_list = list(range(num_bursts))
        self.burst_size = burst_size
        if cv2_channel_order is None:
            cv2_channel_order = not os.path.exists(
                os.path.join(root, "format.json"))
        self.cv2_channel_order = cv2_channel_order

    def __len__(self):
        return len(self.burst_list)

    def _fix_channels(self, im: np.ndarray) -> np.ndarray:
        """Swap an OpenCV-written file's first and third channels back."""
        if self.cv2_channel_order and im.ndim == 3 and im.shape[-1] >= 3:
            im = im.copy()
            im[..., [0, 2]] = im[..., [2, 0]]
        return im

    def _read_burst_image(self, index: int, image_id: int) -> np.ndarray:
        p = os.path.join(self.root, "bursts", f"{index:04d}",
                         f"im_raw_{image_id:02d}.png")
        return self._fix_channels(read_png(p)).astype(np.float32) / _SCALE

    def _read_gt_image(self, index: int) -> np.ndarray:
        p = os.path.join(self.root, "gt", f"{index:04d}", "im_rgb.png")
        return self._fix_channels(read_png(p)).astype(np.float32) / _SCALE

    def _read_meta_info(self, index: int) -> dict:
        p = os.path.join(self.root, "gt", f"{index:04d}", "meta_info.pkl")
        with open(p, "rb") as f:
            return pickle.load(f)

    def __getitem__(self, index: int):
        burst = np.stack([self._read_burst_image(index, i)
                          for i in range(self.burst_size)])
        gt = self._read_gt_image(index)
        meta = self._read_meta_info(index)
        meta["burst_name"] = f"{index:04d}"
        return burst, gt, meta


def write_synthetic_burst_val(root: str, samples) -> None:
    """Write a SyntheticBurstVal set (uint16 PNGs at 2^14, RGB order, the
    ``format.json`` marker). ``samples`` yields dicts with ``burst``
    ``[N, h, w, 4]`` and ``frame_gt`` ``[H, W, 3]`` (floats in [0, 1];
    numpy arrays or tensors on any device) and ``meta``."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "format.json"), "w") as f:
        json.dump({"writer": "dbsr_tpu_torch", "channel_order": "rgb",
                   "scale": _SCALE}, f)
    for idx, s in enumerate(samples):
        bdir = os.path.join(root, "bursts", f"{idx:04d}")
        gdir = os.path.join(root, "gt", f"{idx:04d}")
        os.makedirs(bdir, exist_ok=True)
        os.makedirs(gdir, exist_ok=True)
        burst = _numpy(s["burst"])
        for i in range(burst.shape[0]):
            arr = (np.clip(burst[i], 0, 1) * _SCALE).astype(np.uint16)
            write_png(os.path.join(bdir, f"im_raw_{i:02d}.png"), arr)
        gt = (np.clip(_numpy(s["frame_gt"]), 0, 1) * _SCALE).astype(
            np.uint16)
        write_png(os.path.join(gdir, "im_rgb.png"), gt)
        with open(os.path.join(gdir, "meta_info.pkl"), "wb") as f:
            pickle.dump(_to_plain(s.get("meta", {})), f)


def _numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _to_plain(tree):
    """A meta dict with tensors and numpy scalars as plain Python (numpy
    arrays where they have dimensions), for pickling."""
    if isinstance(tree, dict):
        return {k: _to_plain(v) for k, v in tree.items()}
    if hasattr(tree, "shape"):
        a = _numpy(tree)
        return a.item() if a.ndim == 0 else a
    return tree
