"""AlignLite aligner pretraining on the synthesis' exact flow labels (port
of ``dbsr_tpu/configs/align_lite/pretrain_synthetic.py``, float32).

15 epochs x 1000 batches of 16 8-frame bursts of ``dbsr/default_synthetic``'s
burst distribution (noisy packed RAW from 384^2 crops, <= 24 px translation,
<= 1 degree rotation) and source pools; multi-scale end-point error against
the negated synthesis flow (``training/actors.py:make_lite_flow_actor``);
Adam 2e-4 with StepLR(6 epochs, 0.3); a val pass of 50 batches every 5
epochs. ``dbsr/default_synthetic`` then finds the latest checkpoint of this
workspace (``align_lite/pretrain_synthetic/align_lite_ep*.ckpt``), grafts it
into ``encoder.alignment_net`` and trains with the aligner frozen.

Success: validation ``Stat/epe`` well below the zero-flow end-point error
(the mean norm of the target flow).

Settings read (``--set K=V``): ``batch_size``, ``epochs``,
``steps_per_epoch``, ``print_interval``, ``seed``, ``pool_size``,
``fused_resample``, ``base_lr``, ``mix``; the source imagery is
``default_synthetic``'s (``make_data``: staged Zurich RAW2RGB crops, else the
procedural pool of ``mix``).
"""

from __future__ import annotations

import os

import torch

NET_NAME = "align_lite"


def make_trainer(settings, device="cuda"):
    """The configured :class:`Trainer`: a fresh ``BurstAlignLite``, the
    source imagery of ``make_data``, the flow actor and Adam."""
    from dbsr_tpu_torch.configs.dbsr.default_synthetic import make_data
    from dbsr_tpu_torch.data.synthetic import BurstConfig
    from dbsr_tpu_torch.models.align_lite import BurstAlignLite
    from dbsr_tpu_torch.training.actors import make_lite_flow_actor
    from dbsr_tpu_torch.training.state import make_optimizer
    from dbsr_tpu_torch.training.trainer import Trainer

    settings.batch_size = getattr(settings, "batch_size", None) or 16
    settings.multi_device = getattr(settings, "multi_device", True)
    settings.print_interval = getattr(settings, "print_interval", 100)
    steps_per_epoch = getattr(settings, "steps_per_epoch", 1000)

    cfg = BurstConfig(
        burst_size=8, crop_sz=(384, 384), downsample_factor=4,
        border_crop=24, max_translation=24.0, max_rotation=1.0,
        random_ccm=True, random_gains=True, smoothstep=True, gamma=True,
        add_noise=True,
        fused_resample=getattr(settings, "fused_resample", True))

    dev = torch.device(device)
    loaders, prepare_fn, device_put = make_data(
        settings, cfg, steps_per_epoch, dev, val_batches=50, val_interval=5)
    net = BurstAlignLite()
    actor = make_lite_flow_actor(net)
    tx = make_optimizer(base_lr=getattr(settings, "base_lr", 2e-4),
                        step_size_epochs=6, gamma=0.3,
                        steps_per_epoch=steps_per_epoch)
    workspace = os.path.join(settings.env.workspace_dir, "align_lite",
                             "pretrain_synthetic")
    return Trainer(net, actor, tx, loaders, prepare_fn, workspace,
                   net_name=NET_NAME, print_interval=settings.print_interval,
                   seed=getattr(settings, "seed", 0), device=dev,
                   data_parallel=settings.multi_device,
                   device_put=device_put,
                   tensorboard_dir=os.path.join(
                       settings.env.tensorboard_dir, "align_lite",
                       "pretrain_synthetic")
                   if settings.env.tensorboard_dir else None,
                   description="AlignLite aligner pretraining on exact "
                   "synthetic burst flow labels (EPE loss)")


def run(settings, device="cuda"):
    """Train ``settings.epochs`` epochs (15 by default), resuming from the
    workspace's latest checkpoint."""
    return make_trainer(settings, device).train(getattr(settings, "epochs",
                                                        15))
