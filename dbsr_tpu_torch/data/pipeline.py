"""The host-side data pipeline (port of ``dbsr_tpu/data/pipeline.py``):
image samplers, crop extraction in numpy (the random resized crop and the
centre crop, with the half-pixel bilinear resize they need), the
``CropBatcher`` that makes a batch of source crops, and the
``DevicePrefetcher`` that makes the next batches on a background thread
while the card runs the current step. Burst synthesis itself runs on the
device (``data/synthetic.py``).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from dbsr_tpu_torch.utils.profiling import annotate


def crop_window(rng: np.random.Generator, hw: Tuple[int, int],
                crop_sz: Tuple[int, int],
                scale_range: Optional[Tuple[float, float]] = None,
                ar_range: Optional[Tuple[float, float]] = None,
                ) -> Tuple[int, int, int, int]:
    """The draws of :func:`random_resized_crop` on a frame of size ``hw``:
    ``(row, col, height, width)`` of the window it takes."""
    H, W = hw
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
    return r, c, oh, ow


def random_resized_crop(rng: np.random.Generator, frame: np.ndarray,
                        crop_sz: Tuple[int, int],
                        scale_range: Optional[Tuple[float, float]] = None,
                        ar_range: Optional[Tuple[float, float]] = None,
                        ) -> np.ndarray:
    """Random crop with optional scale/aspect jitter, resized to
    ``crop_sz``: a crop of size ``crop_sz * scale * (1, ar)`` is taken at a
    random position and bilinearly resized to ``crop_sz``. ``frame`` is
    ``[H, W, 3]`` uint8 or float."""
    return take_window(frame, crop_window(rng, frame.shape[:2], crop_sz,
                                          scale_range, ar_range), crop_sz)


def take_window(frame: np.ndarray, window: Tuple[int, int, int, int],
                crop_sz: Tuple[int, int]) -> np.ndarray:
    """The ``(row, col, height, width)`` window of ``frame``, bilinearly
    resized to ``crop_sz`` where it is another size."""
    r, c, oh, ow = window
    crop = frame[r:r + oh, c:c + ow]
    if (oh, ow) != tuple(crop_sz):
        crop = _resize_bilinear_np(crop, crop_sz)
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


class RandomImageSampler:
    """Weighted random image draws with fail-safe retry: a dataset by
    ``weights``, then an image of it uniformly."""

    def __init__(self, datasets: Sequence, weights: Sequence[float],
                 samples_per_epoch: int, max_retries: int = 100):
        assert len(datasets) == len(weights)
        self.datasets = list(datasets)
        p = np.asarray(weights, np.float64)
        self.p = p / p.sum()
        self.samples_per_epoch = samples_per_epoch
        self.max_retries = max_retries

    def __len__(self):
        return self.samples_per_epoch

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        return self._draw(rng, _decode)

    def sample_shape(self, rng: np.random.Generator) -> Tuple[int, int]:
        """The draws of :meth:`sample`, and the drawn image's ``(H, W)``
        only: from the file's header where the dataset reads it
        (``get_image_shape``), else from the decoded image."""
        return self._draw(rng, _image_shape)

    def _draw(self, rng: np.random.Generator, read):
        for _ in range(self.max_retries):
            try:
                d = self.datasets[rng.choice(len(self.datasets), p=self.p)]
                idx = int(rng.integers(0, d.get_num_images()))
                return read(d, idx)
            except OutOfStep:
                raise
            except Exception:
                continue
        raise RuntimeError(
            f"failed to sample an image after {self.max_retries} retries")


class OutOfStep(RuntimeError):
    """A row's image failed in a way the node's other ranks cannot see, so
    they could not follow its retry."""


def _image_shape(d, idx: int) -> Tuple[int, int]:
    if hasattr(d, "get_image_shape"):
        return tuple(d.get_image_shape(idx)[:2])
    return np.asarray(d.get_image(idx)[0]).shape[:2]


def _decode(d, idx: int) -> np.ndarray:
    """Image ``idx`` of ``d``. One rank a node retries any failure on a
    fresh draw, as the JAX package's sampler does. Several ranks draw every
    row and the others read only its header (:func:`_image_shape`), so they
    retry alike only what the header read meets: the header is read first,
    and a decode that fails after it, or gives another size, raises
    :class:`OutOfStep` instead of drifting the ranks' streams apart."""
    from dbsr_tpu_torch.parallel.multihost import local_world_size
    if local_world_size() == 1 or not hasattr(d, "get_image_shape"):
        return d.get_image(idx)[0]
    hw = _image_shape(d, idx)
    try:
        frame = np.asarray(d.get_image(idx)[0])
    except Exception as e:
        raise OutOfStep(
            f"image {idx} of {type(d).__name__}: its header reads but it "
            f"does not decode ({e}); the other ranks of the node cannot "
            "skip it in step: remove it from the dataset") from e
    if tuple(frame.shape[:2]) != hw:
        raise OutOfStep(f"image {idx} of {type(d).__name__} decodes to "
                        f"{frame.shape[:2]}, its header says {hw}")
    return frame


class IndexedImageSampler:
    """Sequential image access."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return self.dataset.get_num_images()

    def get(self, idx: int) -> np.ndarray:
        frame, _ = self.dataset.get_image(idx)
        return frame


class CropBatcher:
    """Sample -> [0, 1] float -> brightness jitter -> random horizontal flip
    -> random (or centre) crop to ``crop_sz`` -> a batch ``[B, h, w, 3]``,
    uint8 by default (``transfer_dtype``; the card casts back to
    float32 / 255) or float32. The host half of synthetic training; with the
    same seed and datasets the batches equal the JAX package's bit for
    bit. Under data parallelism every rank of a node draws the randomness
    of the whole batch and decodes and crops only its own rows
    (``multihost.process_local_batch_slice``): the other rows take the same
    draws (``_draws``, shared by both) on the image's size alone
    (``RandomImageSampler.sample_shape``)."""

    def __init__(self, sampler, batch_size: int, crop_sz: Tuple[int, int],
                 scale_range=None, ar_range=None, random_flip: bool = True,
                 random_crop: bool = True, brightness_jitter: float = 0.0,
                 seed: int = 0, transfer_dtype: str = "uint8"):
        self.sampler = sampler
        self.batch_size = batch_size
        self.crop_sz = crop_sz
        self.scale_range = scale_range
        self.ar_range = ar_range
        self.random_flip = random_flip
        self.random_crop = random_crop
        self.brightness_jitter = brightness_jitter
        self.transfer_dtype = transfer_dtype
        self.seed = seed
        self.rng = np.random.default_rng(seed)

    def fold_in_process(self, process_index: int) -> None:
        """Decorrelate this batcher's random stream per process, for data
        parallelism where every process runs the same config seed."""
        self.rng = np.random.default_rng([self.seed, process_index])

    def __len__(self):
        return max(1, len(self.sampler) // self.batch_size)

    def next_batch(self) -> np.ndarray:
        from dbsr_tpu_torch.parallel.multihost import \
            process_local_batch_slice
        lo, n = process_local_batch_slice(self.batch_size)
        crops = []
        for j in range(self.batch_size):
            if lo <= j < lo + n:
                crops.append(self._crop())
            else:  # another rank's row: its draws, on its image's size
                self._draws(self.sampler.sample_shape(self.rng))
        batch = np.stack(crops)
        if self.transfer_dtype == "uint8":
            # 8-bit sRGB, the source JPEGs' own precision: 4x fewer bytes
            # to the card
            return (np.clip(batch, 0.0, 1.0) * 255.0 + 0.5).astype(
                np.uint8)
        return batch

    def _draws(self, hw: Tuple[int, int]):
        """A row's draws after its image, in the JAX package's order, on an
        image of size ``hw``: the brightness factor (None without jitter),
        the flip, the crop window (None: the centre crop)."""
        factor = np.exp(self.rng.uniform(-self.brightness_jitter,
                                         self.brightness_jitter)) \
            if self.brightness_jitter > 0.0 else None
        flip = self.random_flip and self.rng.random() < 0.5
        window = crop_window(self.rng, hw, self.crop_sz, self.scale_range,
                             self.ar_range) if self.random_crop else None
        return factor, flip, window

    def _crop(self) -> np.ndarray:
        frame = np.asarray(self.sampler.sample(self.rng))
        factor, flip, window = self._draws(frame.shape[:2])
        if frame.dtype == np.uint8:
            frame = frame.astype(np.float32) / 255.0
        if factor is not None:
            frame = np.clip(frame * factor, 0.0, 1.0)
        if flip:
            frame = frame[:, ::-1]
        crop = center_crop(frame, self.crop_sz) if window is None \
            else take_window(frame, window, self.crop_sz)
        return np.ascontiguousarray(crop, np.float32)


def pinned_device_put(device) -> Callable:
    """``put(batch)``: a numpy batch copied into page-locked memory and on
    to ``device`` with ``non_blocking=True`` on the current (default)
    stream, so a step launched after it on that stream reads the copied
    bytes; a CPU device takes the array as a tensor."""
    device = torch.device(device)

    def put(batch):
        t = torch.from_numpy(np.ascontiguousarray(batch))
        if device.type == "cpu":
            return t
        return t.pin_memory().to(device, non_blocking=True)

    return put


class DevicePrefetcher:
    """Background thread making host batches and shipping them to the device
    ahead of use (a queue ``depth`` deep). ``batch_fn`` runs on the one
    worker thread, in order, so the batches are the inline ones;
    ``device_put`` (None: the batch as it is) runs there after it.
    ``wait_s`` sums the time the consumer waited on the queue, ``batch_s``
    the worker's time in ``batch_fn`` and ``device_put``."""

    def __init__(self, batch_fn: Callable[[], object], num_batches: int,
                 device_put: Optional[Callable] = None, depth: int = 2):
        self.batch_fn = batch_fn
        self.num_batches = num_batches
        self.device_put = device_put
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._thread: Optional[threading.Thread] = None
        self._err = None
        self._stop = False
        self.wait_s = 0.0
        self.batch_s = 0.0

    def _put(self, b) -> bool:
        """Stop-aware queue put; False when closed mid-wait."""
        while not self._stop:
            try:
                self.q.put(b, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for _ in range(self.num_batches):
                if self._stop:
                    return
                t0 = time.perf_counter()
                with annotate("feed.render"):
                    b = self.batch_fn()
                if self.device_put is not None:
                    with annotate("feed.put"):
                        b = self.device_put(b)
                self.batch_s += time.perf_counter() - t0
                if not self._put(b):
                    return
        except Exception as e:  # surfaced in the consumer
            self._err = e
            self._put(None)

    def __iter__(self):
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        for _ in range(self.num_batches):
            t0 = time.perf_counter()
            with annotate("feed.wait"):
                b = self.q.get()
            self.wait_s += time.perf_counter() - t0
            if b is None:
                raise RuntimeError("prefetch worker failed") from self._err
            yield b
        self._thread.join()

    def close(self):
        """Release the worker when the consumer abandons the epoch
        mid-iteration (a crash or a divergence abort): else it blocks on a
        full queue, and a retried epoch's new prefetcher would race it for
        the shared batcher's random stream. Idempotent; harmless after
        normal completion."""
        self._stop = True
        t = self._thread
        if t is None:
            return
        while t.is_alive():
            try:
                self.q.get_nowait()  # unblock a put-waiting worker
            except queue.Empty:
                pass
            t.join(timeout=0.05)
