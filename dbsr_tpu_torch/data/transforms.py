"""Composable host-side image transforms in numpy (port of
``dbsr_tpu/data/transforms.py``): a ``Transform`` composes
``TransformBase`` stages; each stage draws its random roll once per call,
so the same randomness applies to every image of the call (the shared-roll
semantics). Host side only: augmentation on the device lives in burst
synthesis.

The stages: ``ToFloat`` (uint8 -> [0, 1] float32, channels last),
``ToFloatAndJitter``, ``Normalize``, ``ToGrayscale``, ``ToBGR`` and
``RandomHorizontalFlip``. The same seed gives the JAX package's bits.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class TransformBase:
    def __init__(self):
        self.rng = np.random.default_rng()

    def seed(self, seed: int):
        self.rng = np.random.default_rng(seed)
        return self

    def roll(self):
        """Draw per-call randomness (None by default)."""
        return None

    def transform(self, image: np.ndarray, roll):
        raise NotImplementedError

    def __call__(self, *images: np.ndarray):
        r = self.roll()
        out = tuple(self.transform(im, r) for im in images)
        return out[0] if len(out) == 1 else out


class Transform:
    """Compose transforms; each stage's roll is shared across all images of
    one call."""

    def __init__(self, *stages: TransformBase):
        self.stages = list(stages)

    def seed(self, seed: int):
        for i, s in enumerate(self.stages):
            s.seed(seed * 1000003 + i)
        return self

    def __call__(self, *images: np.ndarray):
        single = len(images) == 1
        images = list(images)
        for stage in self.stages:
            r = stage.roll()
            images = [stage.transform(im, r) for im in images]
        return images[0] if single else tuple(images)


class ToFloat(TransformBase):
    """uint8 [0,255] -> float32 [0,1] (ToTensor equivalent; layout already
    channels-last)."""

    def transform(self, image, roll):
        if image.dtype == np.uint8:
            return image.astype(np.float32) / 255.0
        return image.astype(np.float32)


class ToFloatAndJitter(TransformBase):
    """Normalize + shared random brightness factor (the reference's
    ``ToTensorAndJitter``)."""

    def __init__(self, brightness_jitter: float = 0.0, normalize: bool = True):
        super().__init__()
        self.brightness_jitter = brightness_jitter
        self.normalize = normalize

    def roll(self):
        return float(np.exp(self.rng.uniform(-self.brightness_jitter,
                                             self.brightness_jitter)))

    def transform(self, image, factor):
        im = image.astype(np.float32)
        if self.normalize:
            im = im / 255.0
        return np.clip(im * factor, 0.0, 1.0)


class Normalize(TransformBase):
    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        super().__init__()
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def transform(self, image, roll):
        return (image - self.mean) / self.std


class ToGrayscale(TransformBase):
    """RGB -> single-channel luminance with probability p."""

    def __init__(self, probability: float = 0.5):
        super().__init__()
        self.probability = probability

    def roll(self):
        return self.rng.random() < self.probability

    def transform(self, image, do_it):
        if not do_it:
            return image
        lum = (0.2989 * image[..., 0] + 0.587 * image[..., 1]
               + 0.114 * image[..., 2])
        return np.repeat(lum[..., None], 3, axis=-1).astype(image.dtype)


class ToBGR(TransformBase):
    def transform(self, image, roll):
        return image[..., ::-1].copy()


class RandomHorizontalFlip(TransformBase):
    def __init__(self, probability: float = 0.5):
        super().__init__()
        self.probability = probability

    def roll(self):
        return self.rng.random() < self.probability

    def transform(self, image, do_it):
        return image[:, ::-1].copy() if do_it else image
