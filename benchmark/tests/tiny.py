"""Tiny versions of the cells for the CPU tests: a tiny DBSRNet (the JAX
package's ``dbsrnet_tiny`` widths) behind the same configuration keys, its
serving checkpoint written by the port's own writer, and the training
loop's network made tiny where ``make_trainer`` builds it."""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from benchmark import harness

TINY_NET = dict(enc_init_dim=8, enc_num_res_blocks=1, enc_out_dim=16,
                dec_init_conv_dim=8, dec_num_pre_res_blocks=1,
                dec_post_conv_dim=8, dec_num_post_res_blocks=1,
                upsample_factor=8, offset_feat_dim=4, weight_pred_proj_dim=4,
                num_weight_predictor_res=1)


def tiny_config(name: str, tmp: Path) -> dict:
    """``configs/<name>.json`` with the tiny widths, a tiny serving
    checkpoint of seeded random parameters under ``tmp``, a pool of 4 and
    epochs of 3 steps."""
    from dbsr_tpu_torch.models.dbsr import DBSRNet
    from dbsr_tpu_torch.models.layers import init_params
    from dbsr_tpu_torch.data.procedural import make_generator
    from dbsr_tpu_torch.training.checkpoint import (network_spec,
                                                    write_checkpoint)
    from dbsr_tpu_torch.utils.convert import params_to_flax

    with open(harness.HERE / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg["net"].update(TINY_NET)
    kw = dict(cfg["net"], dtype=cfg["compute_dtype"],
              fused_s2d_decoder=cfg["fused_s2d_decoder"])
    net = DBSRNet(**kw)
    init_params(net, make_generator("cpu", 7))
    # the serving checkpoint keeps the banked aligner's weights: a random
    # aligner's flow would wrap the offsets anywhere
    from dbsr_tpu_torch.configs.dbsr.default_synthetic import \
        graft_alignment_params
    graft_alignment_params(net, harness.repo_path(
        cfg["train_aligner_checkpoint"]))
    path = tmp / f"{name}_tiny.ckpt"
    write_checkpoint(str(path), {"epoch": 1, "net_name": "dbsr_synthetic",
                                 "net_spec": network_spec(net),
                                 "params_only": True},
                     {"params": params_to_flax(net.state_dict())})
    cfg["serve_checkpoint"] = str(path)
    cfg["pool_size"], cfg["steps_per_epoch"] = 4, 3
    return cfg


def tiny_cell(config: str, traffic: str, limits: str, tmp: Path,
              **overrides) -> harness.Cell:
    """A cell from its files by name (``limits/<limits>.json``), whether
    or not the manifest lists it, at the tiny widths; ``overrides`` change
    the traffic's parameters."""
    def read(kind, name):
        with open(harness.HERE / kind / f"{name}.json") as f:
            return json.load(f)

    return harness.Cell(f"{config}.{traffic}", 1, config,
                        tiny_config(config, tmp), traffic,
                        dict(read("traffic", traffic), **overrides),
                        read("limits", limits), [], [])


def context(cell: harness.Cell, tmp: Path, seed: int = 2 ** 31 + 11,
            seconds: float = 0.5, trace: bool = False) -> harness.Context:
    tmp.mkdir(parents=True, exist_ok=True)
    return harness.Context(cell, seed, seconds, trace, time.perf_counter(),
                           time.time(), tmp, device="cpu")


def tiny_trainer_net(monkeypatch) -> None:
    """``make_trainer``'s network at the tiny widths (it builds the
    flagship's)."""
    from dbsr_tpu_torch.models import dbsr

    full = dbsr.dbsrnet_cvpr2021

    def tiny(**overrides):
        overrides.update(TINY_NET)
        return full(**overrides)

    monkeypatch.setattr(dbsr, "dbsrnet_cvpr2021", tiny)

