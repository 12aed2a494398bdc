"""Smoke config: a tiny DBSR on random smooth images, 2 short epochs, no
data (port of ``dbsr_tpu/configs/dbsr/smoke_tiny.py``). It drives the host-fed
training stack end to end: CLI -> config -> ``CropBatcher`` on the host ->
the prefetcher's copy to the device -> synthesis and the train step ->
checkpoint and resume.

    python -m dbsr_tpu_torch.run_training dbsr smoke_tiny [--device cpu]

Eight 96x112 images from ``np.random.RandomState(0)`` (8x8 blocks of
uniform colour), batches of 2 crops of 40^2 (``batch_size``), 3-frame bursts
at x2, four steps an epoch; ``dbsrnet_tiny`` at an upsampling of 4 with the
JAX package's default aligner (PWC-Net, frozen), L1 with a 4-px boundary,
Adam 1e-3.
"""

from __future__ import annotations

import os

import numpy as np
import torch


class ProceduralImages:
    """Random smooth images, uint8 ``[H, W, 3]``, no disk IO."""

    def __init__(self, n=8, hw=(96, 112), seed=0):
        rng = np.random.RandomState(seed)
        self.images = []
        for _ in range(n):
            low = rng.rand(hw[0] // 8, hw[1] // 8, 3)
            img = np.kron(low, np.ones((8, 8, 1)))
            self.images.append((img * 255).astype(np.uint8))

    def get_num_images(self):
        return len(self.images)

    def get_image(self, i, info=None):
        return self.images[i], {}


def make_trainer(settings, device="cuda"):
    """The configured :class:`Trainer`: the tiny network, the host
    ``CropBatcher`` fed through the prefetcher's ``device_put``, Adam."""
    from dbsr_tpu_torch.configs.dbsr.default_synthetic import \
        make_crop_prepare_fn
    from dbsr_tpu_torch.data.pipeline import (CropBatcher,
                                              RandomImageSampler,
                                              pinned_device_put)
    from dbsr_tpu_torch.data.synthetic import BurstConfig
    from dbsr_tpu_torch.models.dbsr import dbsrnet_tiny
    from dbsr_tpu_torch.training.actors import make_synthetic_actor
    from dbsr_tpu_torch.training.state import make_optimizer
    from dbsr_tpu_torch.training.trainer import LoaderSpec, Trainer

    batch_size = getattr(settings, "batch_size", None) or 2
    dev = torch.device(device)
    cfg = BurstConfig(burst_size=3, crop_sz=(32, 32), downsample_factor=2,
                      border_crop=4, max_translation=3.0, max_rotation=0.5)
    net = dbsrnet_tiny(upsample_factor=4, flow_net="pwc")
    actor = make_synthetic_actor(net, boundary_ignore=4)
    tx = make_optimizer(1e-3, 40, 0.2, steps_per_epoch=4)
    batcher = CropBatcher(
        RandomImageSampler([ProceduralImages()], [1.0],
                           samples_per_epoch=batch_size * 4),
        batch_size, cfg.pre_crop_sz)
    workspace = os.path.join(settings.env.workspace_dir, "dbsr", "smoke_tiny")
    return Trainer(net, actor, tx, [LoaderSpec("train", batcher)],
                   make_crop_prepare_fn(cfg), workspace, net_name="smoke",
                   print_interval=2, device=dev,
                   data_parallel=getattr(settings, "multi_device", True),
                   device_put=pinned_device_put(dev))


def run(settings, device="cuda"):
    """Train 2 epochs, resuming from the workspace's latest checkpoint."""
    return make_trainer(settings, device).train(2)
