"""Actors: loss and stats of a network on a batch (port of
``dbsr_tpu/training/actors.py:19-47,113-156``)."""

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


def pack_flow_to(flow: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Pool dense flow ``[B, N, h, w, 2]`` down to the grid ``hw``: the
    block average of the vectors, rescaled into the coarser grid's pixels."""
    B, N, h, w, _ = flow.shape
    r = h // hw[0]
    if h != hw[0] * r or w != hw[1] * r:
        raise ValueError(f"pack_flow_to: {tuple(flow.shape)} does not pool to "
                         f"{tuple(hw)}")
    return flow.reshape(B, N, hw[0], r, hw[1], r, 2).mean(dim=(3, 5)) / r


# AlignLite's multi-scale weights by pyramid level: every level has its own
# correlation, so the fine level leads
LITE_LEVEL_WEIGHTS = {0: 1.0, 1: 0.5, 2: 0.25}
EPE_EPS = 1e-3  # end-point error sqrt(|d|^2 + eps^2): smooth at zero error


def end_point_error(d: torch.Tensor) -> torch.Tensor:
    """Smoothed norm of the flow differences ``d [..., 2]``."""
    return torch.sqrt((d * d).sum(-1) + EPE_EPS * EPE_EPS)


def make_lite_flow_actor(net: torch.nn.Module) -> Callable:
    """Multi-scale end-point-error supervision of
    ``models.align_lite.BurstAlignLite`` on the synthesis' exact dense flow
    labels.

    The synthesis emits ``flow`` with ``lr_0(p) ~= lr_i(p - flow_i(p))`` and
    the aligner's contract is ``ref(p) ~= oth(p + f(p))``, so the target is
    the **negated** synthesis flow of frames 1..N-1, pooled to the packed
    grid. Every pyramid level predicts flow in its own grid's pixels, so the
    level's target is :func:`pack_flow_to` of the packed-grid target and the
    loss is the levels' mean EPE weighted by ``LITE_LEVEL_WEIGHTS``. Stats:
    ``Loss/total``, ``Stat/epe`` and ``Stat/acc_0.5px`` of the final flow."""

    def actor(batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        pred, aux = net(batch["burst"], return_pyramid=True)
        h, w = pred.shape[2:4]  # pred [B, N-1, h, w, 2]
        gt = pack_flow_to(-batch["flow"][:, 1:], (h, w))

        loss = 0.0
        for lvl, f in aux["pyramid"].items():
            lh, lw = f.shape[-3], f.shape[-2]
            # the pyramid flows carry a flattened [B*(N-1)] lead
            tgt = pack_flow_to(gt, (lh, lw)).reshape(-1, lh, lw, 2)
            l_epe = end_point_error(f.float().reshape(-1, lh, lw, 2) - tgt).mean()
            loss = loss + LITE_LEVEL_WEIGHTS[lvl] * l_epe

        with torch.no_grad():
            epe = end_point_error(pred.float() - gt)
            stats = {"Loss/total": loss.detach(), "Stat/epe": epe.mean(),
                     "Stat/acc_0.5px": (epe < 0.5).float().mean()}
        return loss, stats

    return actor
