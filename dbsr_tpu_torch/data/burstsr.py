"""BurstSR, the real-world dataset: Samsung S8 RAW bursts and Canon DSLR
ground truth (port of ``dbsr_tpu/data/burstsr.py``; numpy host code with
channels-last outputs).

* ``SamsungRAWImage``: a 4-channel packed RGGB uint16 PNG and its pickled
  metadata (black level, white balance, colour matrix, EXIF); exposure,
  F-number, ISO and the EXIF 0xC761 noise profile; normalised by 1023.
* ``CanonImage``: the 3-channel ground truth (RGGB collapsed to RGB by
  channels [0, 1, 3]), normalised by 16383, and its display path
  (``generate_processed_image``).
* ``BurstSRDataset``: ``<root>/<split>/<name>/samsung_??`` and ``canon``,
  the split's scene ids from ``dbsr_tpu_torch/data_specs``.
* ``BurstSRProcessing``: the crop (burst and ground truth at the scale
  factor), black level and white balance, Bayer-preserving random flips
  (flatten, flip, shift-crop, repack, replicate-pad), the ground truth
  scaled by the exposure ratio (exposure x ISO / F^2), optional noise.
* ``IndexedBurstSampler``, ``RandomBurstSampler``, ``get_burstsr_val_set``.

PNGs are read with ``utils/native_io.read_png`` (the native decoder, else
the port's pure-Python ``utils/png16.py``), as the JAX package reads them.
The samplers draw from
``np.random.default_rng(seed)`` in the JAX package's order (frame ids,
then the crop, then the flips), so the same seed gives the same samples,
bit for bit. EXIF is read from plain dicts (``{"exposure", "f_number",
"iso", "noise_profile"}``) or from ``exifread``-style objects, whose
pickles need the ``exifread`` package to load.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np

from dbsr_tpu_torch.ops.raw import flatten_raw_image, pack_raw_image
from dbsr_tpu_torch.utils.native_io import read_png

_SPEC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data_specs")


def load_split_ids(split: str) -> List[str]:
    """The scene ids of a BurstSR split (``train``, ``val``, ``test``)."""
    with open(os.path.join(_SPEC_DIR, f"burstsr_{split}.txt")) as f:
        return [line.strip() for line in f if line.strip()]


def _exif_scalar(exif, plain_key: str, ref_key: str) -> float:
    """A scalar from plain-dict or exifread-style EXIF data."""
    if plain_key in exif:
        return float(exif[plain_key])
    v = exif[ref_key].values[0]
    return float(v.decimal()) if hasattr(v, "decimal") else float(v)


def _fix_cv2_channels(im: np.ndarray) -> np.ndarray:
    """The dataset's PNGs were written by cv2, channels 0 and 2 swapped:
    swap them back."""
    if im.ndim == 3 and im.shape[-1] >= 3:
        im = im.copy()
        im[..., [0, 2]] = im[..., [2, 0]]
    return im


def _load(path: str, cv2_channel_order: bool):
    im = read_png(os.path.join(path, "im_raw.png")).astype(np.int16)
    if cv2_channel_order:
        im = _fix_cv2_channels(im)
    with open(os.path.join(path, "meta_info.pkl"), "rb") as f:
        meta = pickle.load(f)
    return im, meta


class SamsungRAWImage:
    """A RAW burst frame from a Samsung Galaxy S8; ``im_raw`` is
    ``[h, w, 4]`` int16 packed RGGB."""

    NORM_FACTOR = 1023.0

    @classmethod
    def load(cls, path: str, cv2_channel_order: bool = True):
        im, meta = _load(path, cv2_channel_order)
        return cls(im, meta["black_level"], meta["cam_wb"],
                   meta["daylight_wb"], meta["color_matrix"],
                   meta["exif_data"], meta.get("im_preview"))

    def __init__(self, im_raw, black_level, cam_wb, daylight_wb,
                 color_matrix, exif_data, im_preview=None):
        self.im_raw = im_raw
        self.black_level = black_level
        self.cam_wb = cam_wb
        self.daylight_wb = daylight_wb
        self.color_matrix = color_matrix
        self.exif_data = exif_data
        self.im_preview = im_preview
        self.norm_factor = self.NORM_FACTOR

    def get_all_meta_data(self) -> dict:
        cm = self.color_matrix
        return {"black_level": self.black_level, "cam_wb": self.cam_wb,
                "daylight_wb": self.daylight_wb,
                "color_matrix": cm.tolist() if hasattr(cm, "tolist") else cm}

    def get_exposure_time(self) -> float:
        return _exif_scalar(self.exif_data, "exposure", "Image ExposureTime")

    def get_f_number(self) -> float:
        return _exif_scalar(self.exif_data, "f_number", "Image FNumber")

    def get_iso(self) -> float:
        return _exif_scalar(self.exif_data, "iso", "Image ISOSpeedRatings")

    def get_noise_profile(self) -> np.ndarray:
        """Shot and read noise calibration ``[3, 2]`` from EXIF tag 0xC761."""
        if "noise_profile" in self.exif_data:
            return np.asarray(self.exif_data["noise_profile"],
                              np.float64).reshape(3, 2)
        noise = [n[0] for n in self.exif_data["Image Tag 0xC761"].values]
        return np.array(noise, np.float64).reshape(3, 2)

    def get_image_data(self, substract_black_level=False, white_balance=False,
                       normalize=False) -> np.ndarray:
        im = self.im_raw.astype(np.float32)
        if substract_black_level:
            im = im - np.asarray(self.black_level, np.float32).reshape(
                1, 1, 4)
        if white_balance:
            im = im * np.asarray(self.cam_wb, np.float32).reshape(1, 1, 4)
        if normalize:
            im = im / self.norm_factor
        return im

    def shape(self) -> Tuple[int, int, int]:
        return self.im_raw.shape

    def get_crop(self, r1, r2, c1, c2) -> "SamsungRAWImage":
        prev = (self.im_preview[2 * r1:2 * r2, 2 * c1:2 * c2]
                if self.im_preview is not None else None)
        return SamsungRAWImage(self.im_raw[r1:r2, c1:c2], self.black_level,
                               self.cam_wb, self.daylight_wb,
                               self.color_matrix, self.exif_data, prev)


def _rgb3(v):
    """A 4-entry RGGB list as (R, G, B): entries 0, 1 and 3."""
    return list(v[:2]) + [v[3]] if len(v) == 4 else list(v)


class CanonImage:
    """The DSLR ground truth; ``im_raw`` is ``[H, W, 3]`` float32."""

    NORM_FACTOR = 16383.0

    @classmethod
    def load(cls, path: str, cv2_channel_order: bool = True):
        im, meta = _load(path, cv2_channel_order)
        return cls(im.astype(np.float32), meta["black_level"],
                   meta["cam_wb"], meta["daylight_wb"],
                   meta["rgb_xyz_matrix"], meta["exif_data"])

    def __init__(self, im_raw, black_level, cam_wb, daylight_wb,
                 rgb_xyz_matrix, exif_data):
        self.im_raw = im_raw
        self.black_level = _rgb3(black_level)
        self.cam_wb = _rgb3(cam_wb)
        self.daylight_wb = _rgb3(daylight_wb)
        self.rgb_xyz_matrix = rgb_xyz_matrix
        self.exif_data = exif_data
        self.norm_factor = self.NORM_FACTOR

    @staticmethod
    def generate_processed_image(im: np.ndarray, meta_data: dict,
                                 external_norm_factor: Optional[float] = None,
                                 gamma: bool = True, smoothstep: bool = True,
                                 no_white_balance: bool = False,
                                 return_np: bool = False) -> np.ndarray:
        """The display path of ``[H, W, 3]``: normalise, subtract the black
        level, white-balance, gamma, smoothstep."""
        im = im * meta_data.get("norm_factor", 1.0)
        if not meta_data.get("black_level_subtracted", False):
            bl = np.asarray(meta_data["black_level"], np.float32)
            bl = bl[[0, 1, -1]] if bl.size == 4 else bl
            im = im - bl.reshape(1, 1, 3)
        if not meta_data.get("while_balance_applied", False) and \
                not no_white_balance:
            wb = np.asarray(meta_data["cam_wb"], np.float32)
            wb = wb[[0, 1, -1]] if wb.size == 4 else wb
            im = im * wb.reshape(1, 1, 3) / wb[1]
        if external_norm_factor is None:
            im = im / (im.mean() * 5.0)
        else:
            im = im / external_norm_factor
        im = np.clip(im, 0.0, 1.0)
        if gamma:
            im = im ** (1.0 / 2.2)
        if smoothstep:
            im = 3 * im ** 2 - 2 * im ** 3
        if return_np:
            im = (im * 255.0).astype(np.uint8)
        return im

    def get_all_meta_data(self) -> dict:
        m = self.rgb_xyz_matrix
        return {"black_level": self.black_level, "cam_wb": self.cam_wb,
                "daylight_wb": self.daylight_wb,
                "rgb_xyz_matrix": m.tolist() if hasattr(m, "tolist") else m,
                "norm_factor": self.norm_factor}

    def get_exposure_time(self) -> float:
        return _exif_scalar(self.exif_data, "exposure", "EXIF ExposureTime")

    def get_f_number(self) -> float:
        return _exif_scalar(self.exif_data, "f_number", "EXIF FNumber")

    def get_iso(self) -> float:
        return _exif_scalar(self.exif_data, "iso", "EXIF ISOSpeedRatings")

    def get_image_data(self, substract_black_level=False, white_balance=False,
                       normalize=False) -> np.ndarray:
        im = self.im_raw.astype(np.float32)
        if substract_black_level:
            im = im - np.asarray(self.black_level, np.float32).reshape(
                1, 1, 3)
        if white_balance:
            im = im * np.asarray(self.cam_wb, np.float32).reshape(
                1, 1, 3) / 1024.0
        if normalize:
            im = im / self.norm_factor
        return im

    def shape(self) -> Tuple[int, int, int]:
        return self.im_raw.shape

    def get_crop(self, r1, r2, c1, c2) -> "CanonImage":
        return CanonImage(self.im_raw[r1:r2, c1:c2], self.black_level,
                          self.cam_wb, self.daylight_wb,
                          self.rgb_xyz_matrix, self.exif_data)


class BurstSRDataset:
    """``<root>/<split>/<burst_name>/samsung_{00..13}`` and ``canon``; the
    bursts whose scene id (the name's first four characters) is in the
    split's list (or in ``seq_ids`` with ``split=None``)."""

    def __init__(self, root: str, split: str = "train",
                 seq_ids: Optional[Sequence[str]] = None):
        self.root = root
        self.split = split
        self.burst_list = self._get_burst_list(split, seq_ids)
        self.burst_size = 14

    def _get_burst_list(self, split, seq_ids):
        listing = sorted(os.listdir(os.path.join(self.root, self.split)))
        if split is None and seq_ids is not None:
            ids = set(seq_ids)
        else:
            ids = set(load_split_ids(split))
        return [b for b in listing if b[:4] in ids]

    def get_num_bursts(self) -> int:
        return len(self.burst_list)

    def __len__(self):
        return self.get_num_bursts()

    def get_burst_info(self, burst_id: int) -> dict:
        """The burst's name and its number of ``samsung_*`` frames on disk
        (14 in the real dataset, fewer in a fixture)."""
        d = os.path.join(self.root, self.split, self.burst_list[burst_id])
        n = len([f for f in os.listdir(d) if f.startswith("samsung_")])
        return {"burst_size": n or 14,
                "burst_name": self.burst_list[burst_id]}

    def _burst_dir(self, burst_id: int) -> str:
        return os.path.join(self.root, self.split, self.burst_list[burst_id])

    def get_frame_shape(self, burst_id: int, im_id: int) -> Tuple[int, int]:
        """``(h, w)`` of a burst frame from its PNG's header alone."""
        from dbsr_tpu_torch.data.datasets import image_size
        return image_size(os.path.join(self._burst_dir(burst_id),
                                       f"samsung_{im_id:02d}", "im_raw.png"))

    def get_burst(self, burst_id: int, im_ids: Sequence[int],
                  info: Optional[dict] = None):
        d = self._burst_dir(burst_id)
        frames = [SamsungRAWImage.load(os.path.join(d, f"samsung_{i:02d}"))
                  for i in im_ids]
        gt = CanonImage.load(os.path.join(d, "canon"))
        return frames, gt, info or self.get_burst_info(burst_id)


class BurstSRProcessing:
    """Per-sample processing: ``__call__(frames, gt, rng)`` -> ``burst``
    ``[N, crop, crop, 4]`` and ``frame_gt`` ``[crop * scale, crop * scale,
    3]`` (exposure-normalised), float32, with the meta dicts and the
    exposure scale factor."""

    def __init__(self, crop_sz: int = 64, substract_black_level=False,
                 white_balance=False, random_flip=False, noise_level=None,
                 random_crop=True):
        self.crop_sz = crop_sz
        self.substract_black_level = substract_black_level
        self.white_balance = white_balance
        self.random_flip = random_flip
        self.noise_level = noise_level
        self.random_crop = random_crop

    def __call__(self, frames: List[SamsungRAWImage], gt: CanonImage,
                 rng: Optional[np.random.Generator] = None) -> dict:
        rng = rng or np.random.default_rng()
        window, flips, noise = self.draws(frames[0].shape()[:2], len(frames),
                                          rng)
        if window is not None:
            r1, c1 = window
            r2, c2 = r1 + self.crop_sz, c1 + self.crop_sz
            scale = gt.shape()[1] // frames[0].shape()[1]
            frames = [f.get_crop(r1, r2, c1, c2) for f in frames]
            gt = gt.get_crop(scale * r1, scale * r2, scale * c1, scale * c2)

        burst = np.stack([
            f.get_image_data(normalize=True,
                             substract_black_level=self.substract_black_level,
                             white_balance=self.white_balance)
            for f in frames])
        gt_im = gt.get_image_data(
            normalize=True, substract_black_level=self.substract_black_level,
            white_balance=self.white_balance)

        if self.random_flip:
            flat = flatten_raw_image(burst)
            pad = [0, 0]  # (left/right, top/bottom) replicate pad after crop
            if flips[0]:
                flat = flat[..., :, ::-1][..., :, 1:-1]
                gt_im = gt_im[:, ::-1][:, 2:-2]
                pad[0] = 1
            if flips[1]:
                flat = flat[..., ::-1, :][..., 1:-1, :]
                gt_im = gt_im[::-1, :][2:-2, :]
                pad[1] = 1
            burst = pack_raw_image(np.ascontiguousarray(flat))
            if pad[0] or pad[1]:
                burst = np.pad(
                    burst, ((0, 0), (0, pad[1]), (0, pad[0]), (0, 0)),
                    mode="edge")
                gt_im = np.pad(
                    gt_im, ((0, 4 * pad[1]), (0, 4 * pad[0]), (0, 0)),
                    mode="edge")
            gt_im = np.ascontiguousarray(gt_im)

        burst_meta = frames[0].get_all_meta_data()
        burst_meta["black_level_subtracted"] = self.substract_black_level
        burst_meta["while_balance_applied"] = self.white_balance
        burst_meta["norm_factor"] = frames[0].norm_factor
        gt_meta = gt.get_all_meta_data()

        if noise is not None:
            log_shot, read_jitter, gauss = noise
            shot = np.exp(log_shot)
            read = np.exp(2.18 * log_shot + 1.20 + read_jitter)
            var = burst * shot + read
            burst = np.clip(burst + gauss * np.sqrt(var),
                            0.0, 1.0).astype(np.float32)

        light_burst = frames[0].get_exposure_time() * frames[0].get_iso() / (
            frames[0].get_f_number() ** 2)
        light_canon = gt.get_exposure_time() * gt.get_iso() / (
            gt.get_f_number() ** 2)
        exp_scale = light_burst / light_canon
        gt_im = gt_im * exp_scale

        gt_meta["black_level_subtracted"] = self.substract_black_level
        gt_meta["while_balance_applied"] = self.white_balance
        gt_meta["norm_factor"] = gt.norm_factor / exp_scale
        for meta, src in ((burst_meta, frames[0]), (gt_meta, gt)):
            meta["exposure"] = src.get_exposure_time()
            meta["f_number"] = src.get_f_number()
            meta["iso"] = src.get_iso()
        burst_meta["noise_profile"] = frames[0].get_noise_profile()[0, :]

        return {"burst": burst.astype(np.float32),
                "frame_gt": gt_im.astype(np.float32),
                "meta_info_burst": burst_meta, "meta_info_gt": gt_meta,
                "exp_scale_factor": exp_scale}

    def draws(self, frame_hw: Tuple[int, int], n_frames: int,
              rng: np.random.Generator):
        """:meth:`__call__`'s draws, in its order, for ``n_frames`` frames
        of ``frame_hw``: the crop window's ``(row, col)`` (None where the
        frames are ``crop_sz`` wide already), the two flips (None without
        ``random_flip``) and the noise (None without ``noise_level``: else
        the log shot noise, the read noise's jitter and the per-pixel
        Gaussians). A data-parallel rank takes them for another rank's row
        on the size in its first frame's header alone."""
        H, W = frame_hw
        window = None
        if W != self.crop_sz:
            if self.random_crop:
                window = (int(rng.integers(0, H - self.crop_sz + 1)),
                          int(rng.integers(0, W - self.crop_sz + 1)))
            else:
                window = ((H - self.crop_sz) // 2, (W - self.crop_sz) // 2)
            H = W = self.crop_sz
        flips = (rng.random() > 0.5, rng.random() > 0.5) \
            if self.random_flip else None
        noise = None
        if self.noise_level is not None:
            noise = (rng.uniform(np.log(self.noise_level[0]),
                                 np.log(self.noise_level[1])),
                     rng.normal(0, 0.26), rng.normal(size=(n_frames, H, W, 4)))
        return window, flips, noise


class IndexedBurstSampler:
    """Bursts in order, with frame-id selection: frame 0 is the reference
    and the others are drawn without replacement (repeated when the burst
    is short)."""

    def __init__(self, dataset: BurstSRDataset, burst_size: int = 14,
                 processing: Optional[BurstSRProcessing] = None,
                 random_reference_image: bool = False, seed: int = 0):
        self.dataset = dataset
        self.burst_size = burst_size
        self.processing = processing or BurstSRProcessing()
        self.random_reference_image = random_reference_image
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.dataset)

    def _select_ids(self, available: int) -> List[int]:
        n = min(self.burst_size, available)
        if self.random_reference_image:
            ids = list(self.rng.choice(available, n, replace=False))
        else:
            ids = [0] + list(1 + self.rng.choice(available - 1, n - 1,
                                                 replace=False))
        while len(ids) < self.burst_size:
            ids = ids + ids[:self.burst_size - len(ids)]
        return [int(i) for i in ids]

    def __getitem__(self, index: int) -> dict:
        info = self.dataset.get_burst_info(index)
        ids = self._select_ids(info["burst_size"])
        frames, gt, info = self.dataset.get_burst(index, ids, info)
        out = self.processing(frames, gt, self.rng)
        out["burst_name"] = info["burst_name"]
        return out

    def skip(self, index: int) -> None:
        """:meth:`__getitem__`'s draws without reading the burst (a
        data-parallel rank's other rows): the frame ids, then the
        processing's draws, on the size in the first frame's header."""
        info = self.dataset.get_burst_info(index)
        ids = self._select_ids(info["burst_size"])
        self.processing.draws(self.dataset.get_frame_shape(index, ids[0]),
                              len(ids), self.rng)


class RandomBurstSampler(IndexedBurstSampler):
    """Random bursts for training: each item draws its burst, then as
    :class:`IndexedBurstSampler`."""

    def __init__(self, dataset, burst_size=8, samples_per_epoch=1000,
                 processing=None, random_reference_image=False, seed=0):
        super().__init__(dataset, burst_size, processing,
                         random_reference_image, seed)
        self.samples_per_epoch = samples_per_epoch

    def __len__(self):
        return self.samples_per_epoch

    def __getitem__(self, index: int) -> dict:
        idx = int(self.rng.integers(0, len(self.dataset)))
        return super().__getitem__(idx)

    def skip(self, index: int) -> None:
        super().skip(int(self.rng.integers(0, len(self.dataset))))


def get_burstsr_val_set(root: str) -> IndexedBurstSampler:
    """The validation protocol: the val split, an 80-px centre crop, bursts
    of 14, the black level subtracted."""
    ds = BurstSRDataset(root, split="val")
    proc = BurstSRProcessing(crop_sz=80, substract_black_level=True,
                             random_flip=False, random_crop=False)
    return IndexedBurstSampler(ds, burst_size=14, processing=proc)
