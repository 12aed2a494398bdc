"""Fine-tune DBSR on real BurstSR bursts with aligned supervision (port of
``dbsr_tpu/configs/dbsr/default_realworld.py``).

Restores the newest ``dbsr_synthetic`` checkpoint of
``<workspace>/dbsr/default_synthetic`` (the network as that checkpoint
records it, in the compute dtype it records: bf16 after a default
``default_synthetic`` run, as the JAX config rebuilds it; the prediction,
SCA and its float32 copy of the aligner, and so the masked L1, stay
float32), then trains on the
BurstSR tree of ``env.burstsr_dir`` (``DBSR_TPU_BURSTSR_DIR``): 56-px crops
(packed), bursts of 8, batch 12, random Bayer-preserving flips, 300 steps
per epoch for 40 epochs, Adam 1e-5 with StepLR(15 epochs, 0.2); the loss
is 10 x the L1 masked by SCA's validity after spatial-and-colour alignment
of the prediction to the DSLR ground truth (``models/sca.py``, the flow
from a frozen copy of the restored aligner, as the JAX config binds the
restored parameters); a val pass on the val split every 4 epochs. A fresh
``<workspace>/dbsr/default_realworld`` starts from an epoch-0 checkpoint
of the restored parameters.

The batches are made on the host (``BurstBatcher``, numpy); ``prepare_fn``
only copies them to the device. Under data parallelism each rank reads its
rows of the node's batch, and the loss is the one masked mean over the
whole batch that the JAX package's data mesh takes (the actor weights each
rank's mean by its share of the valid pixels). Settings read
(``--set K=V``):
``batch_size``, ``crop_sz``, ``burst_sz``, ``sr_factor`` (4: the ground
truth is 4x the flat RAW), ``steps_per_epoch``, ``epochs``,
``print_interval``, ``seed``.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch


class BurstBatcher:
    """Stacks ``batch_size`` consecutive samples of a burst sampler into a
    batch ``{"burst": [B, N, h, w, 4], "frame_gt": [B, H, W, 3]}`` of
    numpy arrays. Under data parallelism every rank of a node advances the
    sampler's stream over the whole batch and reads only its own rows
    (the sampler's ``skip`` for the others)."""

    def __init__(self, sampler, batch_size: int):
        self.sampler = sampler
        self.batch_size = batch_size
        self._idx = 0

    def __len__(self):
        return max(1, len(self.sampler) // self.batch_size)

    def next_batch(self):
        from dbsr_tpu_torch.parallel.multihost import \
            process_local_batch_slice
        lo, n = process_local_batch_slice(self.batch_size)
        samples = []
        for j in range(self.batch_size):
            idx = self._idx % len(self.sampler)
            if lo <= j < lo + n:
                samples.append(self.sampler[idx])
            else:
                self.sampler.skip(idx)
            self._idx += 1
        return {"burst": np.stack([s["burst"] for s in samples]),
                "frame_gt": np.stack([s["frame_gt"] for s in samples])}


def make_trainer(settings, device="cuda"):
    """``(trainer, restored parameters)``: the :class:`Trainer` of the
    network restored from the synthetic run, on the BurstSR tree."""
    from dbsr_tpu_torch.data.burstsr import (BurstSRDataset,
                                             BurstSRProcessing,
                                             IndexedBurstSampler,
                                             RandomBurstSampler)
    from dbsr_tpu_torch.evaluation.burstsr import _alignment_apply_from
    from dbsr_tpu_torch.models.sca import make_sca
    from dbsr_tpu_torch.training.actors import make_realworld_actor
    from dbsr_tpu_torch.training.checkpoint import (load_network,
                                                    resolve_checkpoint)
    from dbsr_tpu_torch.training.state import make_optimizer
    from dbsr_tpu_torch.training.trainer import LoaderSpec, Trainer

    settings.batch_size = getattr(settings, "batch_size", None) or 12
    settings.crop_sz = getattr(settings, "crop_sz", 56)
    settings.burst_sz = getattr(settings, "burst_sz", 8)
    steps_per_epoch = getattr(settings, "steps_per_epoch", 300)
    dev = torch.device(device)

    syn_dir = os.path.join(settings.env.workspace_dir, "dbsr",
                           "default_synthetic")
    ckpt_path = resolve_checkpoint(syn_dir, "dbsr_synthetic")
    if ckpt_path is None:
        raise FileNotFoundError(
            f"train dbsr/default_synthetic first (no checkpoint in {syn_dir})")
    net, _ = load_network(ckpt_path, device=dev)
    print(f"restored {ckpt_path}", flush=True)
    restored = {k: v.clone() for k, v in net.state_dict().items()}

    root = settings.env.burstsr_dir
    if not root:
        raise FileNotFoundError("no BurstSR tree: set DBSR_TPU_BURSTSR_DIR "
                                "(or env.json's burstsr_dir)")
    proc_train = BurstSRProcessing(crop_sz=settings.crop_sz,
                                   substract_black_level=True,
                                   random_flip=True)
    proc_val = BurstSRProcessing(crop_sz=settings.crop_sz,
                                 substract_black_level=True,
                                 random_flip=False, random_crop=False)
    B = settings.batch_size
    loaders = [
        LoaderSpec("train", BurstBatcher(RandomBurstSampler(
            BurstSRDataset(root, split="train"),
            burst_size=settings.burst_sz,
            samples_per_epoch=B * steps_per_epoch, processing=proc_train),
            B)),
        LoaderSpec("val", BurstBatcher(IndexedBurstSampler(
            BurstSRDataset(root, split="val"), burst_size=settings.burst_sz,
            processing=proc_val), B), training=False, epoch_interval=4),
    ]

    def prepare_fn(generator, batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    # SCA's aligner: the restored one, frozen, whatever the network trains
    aligner = copy.deepcopy(net.encoder.alignment_net).requires_grad_(False)
    sca = make_sca(_alignment_apply_from(aligner),
                   sr_factor=getattr(settings, "sr_factor", 4))
    actor = make_realworld_actor(net, sca, loss_weight=10.0)
    tx = make_optimizer(base_lr=1e-5, step_size_epochs=15, gamma=0.2,
                        steps_per_epoch=steps_per_epoch)
    workspace = os.path.join(settings.env.workspace_dir, "dbsr",
                             "default_realworld")
    trainer = Trainer(net, actor, tx, loaders, prepare_fn, workspace,
                      net_name="dbsr_realworld",
                      print_interval=getattr(settings, "print_interval", 50),
                      seed=getattr(settings, "seed", 0),
                      header_settings={"masked_adam":
                                       not net.encoder.train_alignment},
                      device=dev,
                      data_parallel=getattr(settings, "multi_device", True),
                      tensorboard_dir=os.path.join(
                          settings.env.tensorboard_dir, "dbsr",
                          "default_realworld"),
                      description="Fine-tune DBSR on real-world BurstSR "
                      "bursts with spatial-color-aligned supervision")
    return trainer, restored


def run(settings, device="cuda"):
    """Train ``settings.epochs`` epochs (40 by default), resuming from the
    workspace's latest checkpoint; a fresh workspace starts from an epoch-0
    checkpoint of the restored network."""
    from dbsr_tpu_torch.training.checkpoint import (resolve_checkpoint,
                                                    save_checkpoint)

    from dbsr_tpu_torch.parallel.multihost import barrier

    trainer, restored = make_trainer(settings, device)
    fresh = resolve_checkpoint(trainer.workspace_dir,
                               trainer.net_name) is None
    barrier()  # every rank has looked before rank 0 writes
    if fresh:
        state = trainer.init_state()
        trainer.net.load_state_dict(restored, strict=True)
        if trainer.is_main:
            save_checkpoint(trainer.workspace_dir, trainer.net_name, 0, state,
                            settings=trainer.header_settings)
        print("warm start: the restored parameters saved as the epoch-0 "
              "checkpoint", flush=True)
    return trainer.train(getattr(settings, "epochs", 40))
