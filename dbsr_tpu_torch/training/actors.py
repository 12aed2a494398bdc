"""Actors: loss and stats of a network on a batch (port of
``dbsr_tpu/training/actors.py:19-37``)."""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from dbsr_tpu_torch.ops import metrics


def make_synthetic_actor(net: torch.nn.Module, loss_weight: float = 1.0,
                         boundary_ignore: int = 40,
                         metric: str = "l1") -> Callable:
    """``actor(batch) -> (loss, stats)``: ``pred = net(burst)``, ``loss =
    loss_weight * pixel_error(pred, frame_gt)``; the stats (detached,
    on the device) are ``Loss/total``, ``Loss/rgb`` and the per-sample-mean
    ``Stat/psnr``."""

    def actor(batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        pred, _ = net(batch["burst"])
        gt = batch["frame_gt"]
        loss_rgb = metrics.pixel_error(pred, gt, metric,
                                       boundary_ignore=boundary_ignore)
        loss = loss_weight * loss_rgb
        with torch.no_grad():
            psnr = metrics.psnr(pred, gt, boundary_ignore=boundary_ignore)
        stats = {"Loss/total": loss.detach(), "Loss/rgb": loss_rgb.detach(),
                 "Stat/psnr": psnr}
        return loss, stats

    return actor
