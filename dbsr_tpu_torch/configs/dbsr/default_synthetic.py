"""Default DBSR training on synthetic bursts (port of
``dbsr_tpu/configs/dbsr/default_synthetic.py``, float32).

100 epochs x 1000 batches of 16 8-frame bursts from 384^2 crops (432^2
before the 24 px border crop) at x4 downsampling, <= 24 px translation and
<= 1 degree rotation, fused resampling; L1 loss with boundary_ignore 40;
Adam 1e-4 with StepLR(40 epochs, 0.2). Source imagery is the procedural
dead-leaves pool on the device. The AlignLite aligner is grafted from a
pretrained checkpoint and frozen (the reference protocol): the latest
checkpoint of ``align_lite/pretrain_synthetic`` in the workspace (run
``python -m dbsr_tpu_torch.run_training align_lite pretrain_synthetic``
first), or ``--set pwc_checkpoint=<path>``. ``--set train_alignment=True``
trains the grafted aligner with the rest (Adam then covers it too). The
decoder runs its post-shuffle stage on the space-to-depth-2 layout, as the
JAX config does (``fused_s2d_decoder``, default True; with
``DBSR_FINE_PATCH_S2D=1`` its 3x3 convs launch the fine-patch conv kernel,
forward and d_input).

Settings read (``--set K=V``): ``batch_size``, ``epochs``,
``steps_per_epoch``, ``print_interval``, ``seed``, ``pool_size``,
``fused_resample``, ``pwc_checkpoint``, ``train_alignment``, ``grad_clip``,
``fused_s2d_decoder`` (``False``: the decoder at fine resolution); and, to
refuse what the port does not run, ``compute_dtype``, ``mix`` and
``flow_net``.
"""

from __future__ import annotations

import os

import torch

PRETRAINED_HINT = ("--set pwc_checkpoint="
                   "dbsr_tpu/artifacts/align_lite_params.ckpt")


def make_data(settings, cfg, steps_per_epoch: int, device,
              val_batches: int = 200, val_interval: int = 5):
    """``(loaders, prepare_fn)``: device-resident procedural dead-leaves
    pools for train and val (the val pool an eighth of the train pool; a val
    pass of ``val_batches`` batches every ``val_interval`` epochs). Shared
    with ``align_lite/pretrain_synthetic``, so both train on the same source
    distribution."""
    from dbsr_tpu_torch.data.procedural import (ProceduralImagePool,
                                                ProceduralPoolBatcher,
                                                make_pool_prepare_fn)
    from dbsr_tpu_torch.training.trainer import LoaderSpec

    zdir = settings.env.zurichraw2rgb_dir
    if zdir and os.path.isdir(zdir):
        raise NotImplementedError(
            f"Zurich RAW2RGB data is staged ({zdir}), but the port trains "
            "on the procedural pool only; unset DBSR_TPU_ZURICHRAW2RGB_DIR")
    mix = getattr(settings, "mix", "deadleaves")
    if mix != "deadleaves":
        raise NotImplementedError(f"mix={mix!r}: the port has the "
                                  "dead-leaves pool only")
    B = settings.batch_size
    seed = getattr(settings, "seed", 0)
    pool_size = getattr(settings, "pool_size", 2048)
    train_pool = ProceduralImagePool(pool_size, cfg.pre_crop_sz, seed=seed,
                                     device=device)
    val_pool = ProceduralImagePool(max(pool_size // 8, 1), cfg.pre_crop_sz,
                                   seed=seed + 999, device=device)
    loaders = [
        LoaderSpec("train", ProceduralPoolBatcher(train_pool, B,
                                                  steps_per_epoch)),
        LoaderSpec("val", ProceduralPoolBatcher(val_pool, B, val_batches),
                   training=False, epoch_interval=val_interval),
    ]
    return loaders, make_pool_prepare_fn(cfg, B)


def find_pretrained_flow(settings):
    """The pretrained aligner checkpoint: ``settings.pwc_checkpoint``, else
    the latest ``align_lite/pretrain_synthetic`` checkpoint of the
    workspace, else None."""
    from dbsr_tpu_torch.training.checkpoint import resolve_checkpoint

    explicit = getattr(settings, "pwc_checkpoint", None)
    if explicit:
        return explicit
    return resolve_checkpoint(
        os.path.join(settings.env.workspace_dir, "align_lite",
                     "pretrain_synthetic"), "align_lite")


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


def make_trainer(settings, device="cuda"):
    """``(trainer, flow_ckpt)``: the configured :class:`Trainer` (fresh
    network, procedural pools, Adam) and the pretrained AlignLite
    checkpoint that :func:`run` grafts into it. Raises, naming
    :data:`PRETRAINED_HINT`, when no AlignLite checkpoint is found."""
    from dbsr_tpu_torch.data.synthetic import BurstConfig
    from dbsr_tpu_torch.models.dbsr import dbsrnet_cvpr2021
    from dbsr_tpu_torch.training.actors import make_synthetic_actor
    from dbsr_tpu_torch.training.state import make_optimizer
    from dbsr_tpu_torch.training.trainer import Trainer

    settings.batch_size = getattr(settings, "batch_size", None) or 16
    settings.print_interval = getattr(settings, "print_interval", 50)
    steps_per_epoch = getattr(settings, "steps_per_epoch", 1000)

    cfg = BurstConfig(
        burst_size=8, crop_sz=(384, 384), downsample_factor=4,
        border_crop=24, max_translation=24.0, max_rotation=1.0,
        max_shear=0.0, max_scale=0.0, random_ccm=True, random_gains=True,
        smoothstep=True, gamma=True, add_noise=True,
        fused_resample=getattr(settings, "fused_resample", True))

    compute_dtype = getattr(settings, "compute_dtype", "float32")
    if compute_dtype not in ("float32", "f32"):
        raise NotImplementedError(
            f"compute_dtype={compute_dtype!r}: the port trains float32")

    flow_ckpt = find_pretrained_flow(settings)
    if flow_ckpt is None or flow_net_kind(flow_ckpt) != "lite":
        raise RuntimeError(
            "the port trains DBSR from a pretrained AlignLite aligner and "
            f"found {'none' if flow_ckpt is None else flow_ckpt}; run "
            "`python -m dbsr_tpu_torch.run_training align_lite "
            f"pretrain_synthetic` first, or pass {PRETRAINED_HINT} (the "
            "fallback without one is end-to-end training of PWC-Net, which "
            "is not ported)")
    train_alignment = bool(getattr(settings, "train_alignment", False))
    print(f"using pretrained flow weights: {flow_ckpt} (flow_net=lite, "
          f"train_alignment={train_alignment})", flush=True)

    dev = torch.device(device)
    loaders, prepare_fn = make_data(settings, cfg, steps_per_epoch, dev)
    net = dbsrnet_cvpr2021(
        enc_init_dim=64, enc_num_res_blocks=9, enc_out_dim=512,
        dec_init_conv_dim=64, dec_num_pre_res_blocks=5,
        dec_post_conv_dim=32, dec_num_post_res_blocks=4,
        upsample_factor=cfg.downsample_factor * 2,
        offset_feat_dim=64, weight_pred_proj_dim=64,
        num_weight_predictor_res=3, gauss_blur_sd=1.0, icnrinit=True,
        train_alignment=train_alignment,
        flow_net=getattr(settings, "flow_net", "lite"),
        fused_s2d_decoder=getattr(settings, "fused_s2d_decoder", True))
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
                      header_settings={"masked_adam": masked}, device=dev)
    return trainer, flow_ckpt


def run(settings, device="cuda"):
    """Train ``settings.epochs`` epochs (100 by default), resuming from the
    workspace's latest checkpoint; a fresh workspace starts from an epoch-0
    checkpoint of a fresh network with the pretrained aligner grafted."""
    from dbsr_tpu_torch.training.checkpoint import (resolve_checkpoint,
                                                    save_checkpoint)

    trainer, flow_ckpt = make_trainer(settings, device)
    if resolve_checkpoint(trainer.workspace_dir, trainer.net_name) is None:
        state = trainer.init_state()
        graft_alignment_params(trainer.net, flow_ckpt)
        save_checkpoint(trainer.workspace_dir, trainer.net_name, 0, state,
                        settings=trainer.header_settings)
        print("grafted pretrained flow weights into encoder/alignment_net "
              "(saved as epoch-0 checkpoint)", flush=True)
    return trainer.train(getattr(settings, "epochs", 100))
