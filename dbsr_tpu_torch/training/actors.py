"""Actors: loss and stats of a network on a batch (port of
``dbsr_tpu/training/actors.py``)."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from dbsr_tpu_torch.ops import metrics
from dbsr_tpu_torch.ops.interp import resize_bilinear
from dbsr_tpu_torch.parallel import multihost


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


# PWC-Net's multi-scale weights by decoder level, the coarse decoders first
# (PWC-Net's training loss, arXiv:1709.02371 sec. 4)
PWC_LEVEL_WEIGHTS = {6: 0.32, 5: 0.08, 4: 0.02, 3: 0.01, 2: 0.005}
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


def make_flow_actor(net: torch.nn.Module) -> Callable:
    """Multi-scale end-point-error supervision of
    ``models.pwcnet.BurstFlowNet`` on the synthesis' exact dense flow
    labels: the target is the negated synthesis flow of frames 1..N-1 pooled
    to the packed grid (as :func:`make_lite_flow_actor`). Every decoder
    level's raw flow is in 1/20 of a preprocessed-grid pixel, so the target
    goes into that unit (``[Wp/w, Hp/h] / 20``, x then y) and is resized
    bilinearly to each level's grid; the loss is the levels' mean EPE
    weighted by ``PWC_LEVEL_WEIGHTS``. Stats: ``Loss/total``, ``Stat/epe``
    and ``Stat/acc_0.5px`` of the final flow."""

    def actor(batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        pred, aux = net(batch["burst"], return_pyramid=True)
        h, w = pred.shape[2:4]  # pred [B, N-1, h, w, 2]
        gt = pack_flow_to(-batch["flow"][:, 1:], (h, w))

        Hp, Wp = aux["preprocessed_hw"]
        unit = torch.tensor([Wp / w, Hp / h], dtype=torch.float32,
                            device=gt.device) / 20.0
        gt_raw = (gt * unit).reshape(-1, h, w, 2)
        loss = 0.0
        for lvl, f in aux["pyramid"].items():
            lh, lw = f.shape[-3], f.shape[-2]
            tgt = resize_bilinear(gt_raw, (lh, lw))
            l_epe = end_point_error(f.float().reshape(-1, lh, lw, 2) - tgt).mean()
            loss = loss + PWC_LEVEL_WEIGHTS[lvl] * l_epe

        with torch.no_grad():
            epe = end_point_error(pred.float() - gt)
            stats = {"Loss/total": loss.detach(), "Stat/epe": epe.mean(),
                     "Stat/acc_0.5px": (epe < 0.5).float().mean()}
        return loss, stats

    return actor


def make_realworld_actor(net: torch.nn.Module, sca_apply: Callable,
                         loss_weight: float = 10.0,
                         boundary_ignore: Optional[int] = None,
                         metric: str = "l1") -> Callable:
    """``actor(batch) -> (loss, stats)`` on real bursts: the prediction is
    aligned to the DSLR ground truth in space and colour first
    (``sca_apply(pred, gt, burst) -> (pred_warped, valid)``,
    ``models/sca.py``), then ``loss = loss_weight * pixel_error`` masked by
    ``valid``; stats ``Loss/total``, ``Loss/rgb`` and the masked
    ``Stat/psnr``. Under data parallelism the masked mean is one over every
    rank's rows, as the JAX package's data mesh takes it: each rank's mean
    is weighted by its share of the valid pixels
    (``multihost.global_mean_weight``) before the trainer averages the
    ranks' gradients and stats. ``Stat/psnr`` is the ranks' mean of their
    per-sample means, which is the batch's wherever every sample's PSNR is
    finite."""

    def actor(batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        pred, _ = net(batch["burst"])
        gt = batch["frame_gt"]
        pred_warped, valid = sca_apply(pred, gt, batch["burst"])
        loss_rgb = metrics.pixel_error(pred_warped, gt, metric,
                                       boundary_ignore=boundary_ignore,
                                       valid=valid)
        if valid is not None and multihost.world_size() > 1:
            b = boundary_ignore
            counted = valid[..., b:-b, b:-b, :] if b else valid
            loss_rgb = loss_rgb * multihost.global_mean_weight(counted.sum())
        loss = loss_weight * loss_rgb
        with torch.no_grad():
            psnr = metrics.psnr(pred_warped, gt,
                                boundary_ignore=boundary_ignore, valid=valid)
        stats = {"Loss/total": loss.detach(), "Loss/rgb": loss_rgb.detach(),
                 "Stat/psnr": psnr}
        return loss, stats

    return actor
