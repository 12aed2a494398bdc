"""Default DBSR training on synthetic bursts (port of
``dbsr_tpu/configs/dbsr/default_synthetic.py``).

100 epochs x 1000 batches of 16 8-frame bursts from 384^2 crops (432^2
before the 24 px border crop) at x4 downsampling, <= 24 px translation and
<= 1 degree rotation, fused resampling; L1 loss with boundary_ignore 40;
Adam 1e-4 with StepLR(40 epochs, 0.2). Source imagery is random crops of
the Zurich RAW2RGB JPEGs where ``DBSR_TPU_ZURICHRAW2RGB_DIR`` stages them
(made on the host, fed through the trainer's prefetcher), else the
procedural pool on the device: dead leaves, or with ``--set mix=mixed`` the
mixed corpus. The aligner is grafted from a pretrained
checkpoint and frozen (the reference protocol): ``--set
pwc_checkpoint=<path>``, else the latest checkpoint of
``align_lite/pretrain_synthetic`` in the workspace, else that of
``pwcnet/pretrain_synthetic`` (``python -m dbsr_tpu_torch.run_training
align_lite pretrain_synthetic`` or ``pwcnet pretrain_synthetic``); an
``align_lite*`` checkpoint grafts as ``flow_net='lite'``, any other as
``flow_net='pwc'``. With no checkpoint at all it warns and trains a fresh
PWC-Net end to end with the rest (``flow_net='pwc'``,
``train_alignment=True``), as the JAX package does. ``--set
train_alignment=True`` trains a grafted aligner with the rest (Adam then
covers it too). The
decoder runs its post-shuffle stage on the space-to-depth-2 layout, as the
JAX config does (``fused_s2d_decoder``, default True; on the card its 3x3
convs launch the fine-patch conv kernel, forward and d_input, unless
``DBSR_FINE_PATCH_S2D=0``). The network computes in bf16, the JAX config's
default (``compute_dtype``): parameters and Adam's moments float32, each
conv in bf16 on the parameters cast at use, the flow, the offsets, the
prediction and the loss float32, no loss scaling; ``--set
compute_dtype=float32`` trains in float32.

Settings read (``--set K=V``): ``batch_size``, ``epochs``,
``steps_per_epoch``, ``print_interval``, ``seed``, ``pool_size``,
``fused_resample``, ``pwc_checkpoint``, ``train_alignment``, ``grad_clip``,
``fused_s2d_decoder`` (``False``: the decoder at fine resolution),
``flow_net`` (the checkpoint's kind by default; ``conv``, the two-conv
``ConvFlow``, trains end to end without a checkpoint), ``compute_dtype``
(``bfloat16``/``bf16`` or ``float32``/``f32``; any other raises), ``mix``
(``deadleaves`` or ``mixed``).
"""

from __future__ import annotations

import os
from typing import Callable

import torch


def make_crop_prepare_fn(cfg) -> Callable:
    """``prepare(generator, crops) -> batch`` for host-made source crops
    already on the device: uint8 -> float32 / 255 (float crops as they
    are), then burst synthesis (``synthesize_batch`` with ``cfg``). Under
    data parallelism the loader made this rank's rows only: the synthesis
    draws are those of the node's whole batch (``crops`` rows x the node's
    ranks), cut to this rank's rows."""
    from dbsr_tpu_torch.data.synthetic import (rgb2rawburst_from_draws,
                                               sample_draws)
    from dbsr_tpu_torch.parallel.multihost import (local_rows,
                                                   local_world_size)

    def prepare(generator, crops):
        crops = crops.float() / 255.0 if crops.dtype == torch.uint8 \
            else crops.float()
        node_batch = crops.shape[0] * local_world_size()
        draws = local_rows(sample_draws(generator, node_batch, cfg),
                           node_batch)
        return rgb2rawburst_from_draws(crops, draws, cfg)

    return prepare


def make_data(settings, cfg, steps_per_epoch: int, device,
              val_batches: int = 200, val_interval: int = 5):
    """``(loaders, prepare_fn, device_put)`` for synthetic-burst training
    (a val pass of ``val_batches`` batches every ``val_interval`` epochs):
    with Zurich RAW2RGB staged (``env.zurichraw2rgb_dir``), random crops of
    its train and test JPEGs made on the host (``CropBatcher`` seeded
    ``seed`` and ``seed + 1``), shipped as uint8 through the prefetcher's
    ``device_put``; otherwise device-resident procedural pools, the train
    pool of ``settings.mix`` (``'mixed'``: the mixed corpus; else dead
    leaves), the val pool dead leaves and an eighth of its size, and no
    ``device_put``. Shared with ``align_lite/pretrain_synthetic`` and
    ``pwcnet/pretrain_synthetic``, so all three train on the same source
    distribution."""
    from dbsr_tpu_torch.training.trainer import LoaderSpec

    B = settings.batch_size
    seed = getattr(settings, "seed", 0)
    zdir = settings.env.zurichraw2rgb_dir
    if zdir and os.path.isdir(zdir):
        from dbsr_tpu_torch.data.datasets import ZurichRAW2RGB
        from dbsr_tpu_torch.data.pipeline import (CropBatcher,
                                                  RandomImageSampler,
                                                  pinned_device_put)

        def batcher(split, n_batches, batcher_seed):
            return CropBatcher(RandomImageSampler(
                [ZurichRAW2RGB(zdir, split)], [1.0],
                samples_per_epoch=B * n_batches), B, cfg.pre_crop_sz,
                random_flip=True, seed=batcher_seed)

        loaders = [
            LoaderSpec("train", batcher("train", steps_per_epoch, seed)),
            LoaderSpec("val", batcher("test", val_batches, seed + 1),
                       training=False, epoch_interval=val_interval),
        ]
        return loaders, make_crop_prepare_fn(cfg), pinned_device_put(device)

    from dbsr_tpu_torch.data.procedural import (ProceduralImagePool,
                                                ProceduralPoolBatcher,
                                                make_pool_prepare_fn)

    mix = getattr(settings, "mix", "deadleaves")
    print(f"NOTE: no Zurich data staged (env.zurichraw2rgb_dir empty) — "
          f"training on procedural source imagery (mix={mix})", flush=True)
    pool_size = getattr(settings, "pool_size", 2048)
    train_pool = ProceduralImagePool(pool_size, cfg.pre_crop_sz, seed=seed,
                                     device=device, mix=mix)
    # the val pool stays dead leaves, so scores compare across mixes
    val_pool = ProceduralImagePool(max(pool_size // 8, 1), cfg.pre_crop_sz,
                                   seed=seed + 999, device=device)
    loaders = [
        LoaderSpec("train", ProceduralPoolBatcher(train_pool, B,
                                                  steps_per_epoch)),
        LoaderSpec("val", ProceduralPoolBatcher(val_pool, B, val_batches),
                   training=False, epoch_interval=val_interval),
    ]
    return loaders, make_pool_prepare_fn(cfg, B), None


def find_pretrained_flow(settings):
    """The pretrained aligner checkpoint: ``settings.pwc_checkpoint``, else
    the latest ``align_lite/pretrain_synthetic`` checkpoint of the
    workspace, else the latest ``pwcnet/pretrain_synthetic`` one, else
    None."""
    from dbsr_tpu_torch.training.checkpoint import resolve_checkpoint

    explicit = getattr(settings, "pwc_checkpoint", None)
    if explicit:
        return explicit
    ws = settings.env.workspace_dir
    return (resolve_checkpoint(os.path.join(ws, "align_lite",
                                            "pretrain_synthetic"),
                               "align_lite")
            or resolve_checkpoint(os.path.join(ws, "pwcnet",
                                               "pretrain_synthetic"),
                                  "pwcnet_synth"))


def flow_net_kind(flow_ckpt_path: str) -> str:
    """``'lite'`` for an ``align_lite*`` checkpoint, else ``'pwc'``."""
    from dbsr_tpu_torch.training.checkpoint import read_header

    name = read_header(flow_ckpt_path).get("net_name", "")
    return "lite" if name.startswith("align_lite") else "pwc"


def graft_alignment_params(net, flow_ckpt_path: str) -> None:
    """Load a pretrained flow checkpoint's ``alignment_net`` subtree into
    ``net.encoder.alignment_net``, every tensor's name and shape checked
    against the fresh subtree."""
    from dbsr_tpu_torch.training.checkpoint import read_checkpoint
    from dbsr_tpu_torch.utils.convert import params_from_flax

    _, raw = read_checkpoint(flow_ckpt_path)
    sub = params_from_flax(raw["params"]["params"]["alignment_net"])
    aligner = net.encoder.alignment_net
    ref = aligner.state_dict()
    for k, v in ref.items():
        if k not in sub or tuple(sub[k].shape) != tuple(v.shape):
            raise ValueError(f"pretrained flow checkpoint {flow_ckpt_path} "
                             f"incompatible at {k}")
    if set(sub) != set(ref):
        raise ValueError(f"pretrained flow checkpoint {flow_ckpt_path} has "
                         f"extra tensors: {sorted(set(sub) - set(ref))}")
    aligner.load_state_dict(sub, strict=True)


def check_resume_matches(workspace: str, net_name: str,
                         masked: bool) -> None:
    """Refuse to resume a workspace whose checkpoints were written with the
    other optimizer structure: Adam over the trainable parameters only
    (``masked``, the frozen aligner) and Adam over all of them
    (``train_alignment=True``) do not restore into each other."""
    from dbsr_tpu_torch.training.checkpoint import (read_header,
                                                    resolve_checkpoint)

    path = resolve_checkpoint(workspace, net_name)
    if path is None:
        return
    recorded = read_header(path).get("settings", {}).get("masked_adam")
    if recorded is not None and bool(recorded) != masked:
        raise ValueError(
            f"{path} was written with masked_adam={bool(recorded)} "
            f"(train_alignment={not recorded}), but this run asks for "
            f"train_alignment={not masked}: the two optimizer states cannot "
            "cross-restore. Keep the setting, or start a fresh workspace.")


def burst_config(settings):
    """The training bursts: 8 frames from 384^2 crops at x4, a 24 px border,
    <= 24 px translation, <= 1 degree rotation, fused resampling unless
    ``settings.fused_resample`` is False."""
    from dbsr_tpu_torch.data.synthetic import BurstConfig

    return BurstConfig(
        burst_size=8, crop_sz=(384, 384), downsample_factor=4,
        border_crop=24, max_translation=24.0, max_rotation=1.0,
        max_shear=0.0, max_scale=0.0, random_ccm=True, random_gains=True,
        smoothstep=True, gamma=True, add_noise=True,
        fused_resample=getattr(settings, "fused_resample", True))


def make_trainer(settings, device="cuda"):
    """``(trainer, flow_ckpt)``: the configured :class:`Trainer` (fresh
    network, ``make_data``'s source imagery, Adam) and the pretrained aligner checkpoint
    that :func:`run` grafts into it, None when there is none (the aligner
    then trains from scratch with the rest)."""
    from dbsr_tpu_torch.models.dbsr import dbsrnet_cvpr2021
    from dbsr_tpu_torch.training.actors import make_synthetic_actor
    from dbsr_tpu_torch.training.state import make_optimizer
    from dbsr_tpu_torch.training.trainer import Trainer

    settings.batch_size = getattr(settings, "batch_size", None) or 16
    settings.multi_device = getattr(settings, "multi_device", True)
    settings.print_interval = getattr(settings, "print_interval", 50)
    steps_per_epoch = getattr(settings, "steps_per_epoch", 1000)

    cfg = burst_config(settings)

    # bf16 compute, float32 parameters and Adam state, as the JAX config
    compute_dtype = getattr(settings, "compute_dtype", "bfloat16")
    dtypes = {"bfloat16": "bfloat16", "bf16": "bfloat16", "float32": None,
              "f32": None}
    if compute_dtype not in dtypes:
        raise NotImplementedError(
            f"compute_dtype={compute_dtype!r}: the port trains float32 or "
            "bfloat16")

    # the reference protocol: a pretrained aligner, frozen; without one the
    # aligner trains end to end
    flow_ckpt = find_pretrained_flow(settings)
    train_alignment = bool(getattr(settings, "train_alignment",
                                   flow_ckpt is None))
    if flow_ckpt is None:
        flow_net = getattr(settings, "flow_net", "pwc")
        print("WARNING: no pretrained flow checkpoint found — training "
              "the aligner end-to-end (reference protocol is "
              "pretrained+frozen; run `python run_training.py align_lite "
              "pretrain_synthetic` first)", flush=True)
    else:
        flow_net = getattr(settings, "flow_net", flow_net_kind(flow_ckpt))
        print(f"using pretrained flow weights: {flow_ckpt} "
              f"(flow_net={flow_net}, train_alignment={train_alignment})",
              flush=True)

    # the network first: an unknown aligner raises before the source pools
    # are rendered
    net = dbsrnet_cvpr2021(
        enc_init_dim=64, enc_num_res_blocks=9, enc_out_dim=512,
        dec_init_conv_dim=64, dec_num_pre_res_blocks=5,
        dec_post_conv_dim=32, dec_num_post_res_blocks=4,
        upsample_factor=cfg.downsample_factor * 2,
        offset_feat_dim=64, weight_pred_proj_dim=64,
        num_weight_predictor_res=3, gauss_blur_sd=1.0, icnrinit=True,
        train_alignment=train_alignment, flow_net=flow_net,
        fused_s2d_decoder=getattr(settings, "fused_s2d_decoder", True),
        dtype=dtypes[compute_dtype])
    dev = torch.device(device)
    loaders, prepare_fn, device_put = make_data(settings, cfg,
                                                steps_per_epoch, dev)
    actor = make_synthetic_actor(net, loss_weight=1.0, boundary_ignore=40)
    workspace = os.path.join(settings.env.workspace_dir, "dbsr",
                             "default_synthetic")
    # Adam runs over the trainable parameters: with the aligner frozen that
    # is the JAX package's masked Adam, with train_alignment its plain one
    masked = not train_alignment
    check_resume_matches(workspace, "dbsr_synthetic", masked)
    tx = make_optimizer(base_lr=1e-4, step_size_epochs=40, gamma=0.2,
                        steps_per_epoch=steps_per_epoch,
                        clip_norm=getattr(settings, "grad_clip", None))
    trainer = Trainer(net, actor, tx, loaders, prepare_fn, workspace,
                      net_name="dbsr_synthetic",
                      print_interval=settings.print_interval,
                      seed=getattr(settings, "seed", 0),
                      header_settings={"masked_adam": masked}, device=dev,
                      data_parallel=settings.multi_device,
                      device_put=device_put,
                      tensorboard_dir=os.path.join(
                          settings.env.tensorboard_dir, "dbsr",
                          "default_synthetic")
                      if settings.env.tensorboard_dir else None,
                      description="Default settings for training DBSR "
                      "models on synthetic bursts (on-device synthesis)")
    return trainer, flow_ckpt


def run(settings, device="cuda"):
    """Train ``settings.epochs`` epochs (100 by default), resuming from the
    workspace's latest checkpoint; with a pretrained aligner, a fresh
    workspace starts from an epoch-0 checkpoint of a fresh network with the
    aligner grafted."""
    from dbsr_tpu_torch.training.checkpoint import (resolve_checkpoint,
                                                    save_checkpoint)

    from dbsr_tpu_torch.parallel.multihost import barrier

    trainer, flow_ckpt = make_trainer(settings, device)
    fresh = flow_ckpt is not None and resolve_checkpoint(
        trainer.workspace_dir, trainer.net_name) is None
    barrier()  # every rank has looked before rank 0 writes
    if fresh:
        state = trainer.init_state()
        graft_alignment_params(trainer.net, flow_ckpt)
        if trainer.is_main:
            save_checkpoint(trainer.workspace_dir, trainer.net_name, 0, state,
                            settings=trainer.header_settings)
        print("grafted pretrained flow weights into encoder/alignment_net "
              "(saved as epoch-0 checkpoint)", flush=True)
    return trainer.train(getattr(settings, "epochs", 100))
