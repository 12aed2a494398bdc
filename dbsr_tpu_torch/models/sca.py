"""Spatial-and-colour alignment (SCA) for real-burst supervision (port of
``dbsr_tpu/models/sca.py``).

BurstSR's ground truth (a DSLR image) is registered with the prediction
(from a phone's burst) neither in space nor in colour, so before any loss
or metric the prediction is (1) warped to the ground truth by the aligner's
flow (computed without gradient on inputs divided by their maxima), and
(2) colour-matched by a per-image 3x3 least-squares transform estimated
between the Gaussian-smoothed, warped base RAW frame and the downsampled
ground truth; pixels whose colour-fit error exceeds 20/255 are masked out.

Channels-last and batched. Both warps are ``ops/warp.warp_feat`` on
3-channel images, the warp kernel on the card. The least squares is the JAX
package's normal equations, ``(AᵀA + 1e-6 I) c = AᵀB``, solved per image;
the 3x3 sums and the solve run in float64 (the JAX package's run at
float32 ``Precision.HIGHEST``), the products with ``c`` in float32 with
TF32 off.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from dbsr_tpu_torch.ops import metrics
from dbsr_tpu_torch.ops.filtering import apply_kernel, get_gaussian_kernel
from dbsr_tpu_torch.ops.interp import resize_bilinear
from dbsr_tpu_torch.ops.warp import warp_feat
from dbsr_tpu_torch.serving import float32_math


def match_colors(im_ref: torch.Tensor, im_q: torch.Tensor,
                 im_test: torch.Tensor, gauss_kernel: torch.Tensor,
                 err_thresh: float = 20.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Estimate a 3x3 colour transform ``im_q -> im_ref`` and apply it to
    ``im_test``: Gaussian smoothing, a 5-px interior crop, per-image least
    squares, validity where the fit's error is below ``err_thresh`` / 255,
    the mask padded back, resized bilinearly to ``im_test``'s size and
    thresholded at 0.9.

    ``im_ref``, ``im_q`` ``[B, h, w, 3]``; ``im_test`` ``[B, H, W, 3]``.
    Returns ``(im_test transformed [B, H, W, 3], valid [B, H, W, 1])``, the
    mask boolean."""
    bi = 5
    ref_s = apply_kernel(im_ref, gauss_kernel)[:, bi:-bi, bi:-bi]
    q_s = apply_kernel(im_q, gauss_kernel)[:, bi:-bi, bi:-bi]
    B = ref_s.shape[0]
    ref_f = ref_s.reshape(B, -1, 3)
    q_f = q_s.reshape(B, -1, 3)
    with float32_math():
        # the 3x3 sums and the solve in float64: cond(AᵀA) of natural
        # images' colours is ~1e2-1e4, and two float32 sums of the same
        # pixels in other orders moved the transformed image by ~2e-5, so
        # the card and the CPU would disagree by that much; the float32
        # products with c below are the JAX package's
        q64 = q_f.double()
        qt = q64.transpose(1, 2)
        ata = torch.bmm(qt, q64) + 1e-6 * torch.eye(3, dtype=q64.dtype,
                                                    device=q64.device)
        atb = torch.bmm(qt, ref_f.double())
        # solve_ex: the same LU solve as solve, without a host sync to check
        # the (regularised) factorisation
        c_mat = torch.linalg.solve_ex(ata, atb).result.to(q_f.dtype)
        q_conv = torch.bmm(q_f, c_mat).reshape(ref_s.shape)
        test_conv = torch.bmm(im_test.reshape(B, -1, 3), c_mat).reshape(
            im_test.shape)
    err = torch.linalg.vector_norm((q_conv - ref_s) * 255.0, dim=-1)
    valid = (err < err_thresh).to(torch.float32)[..., None]
    pad = (im_q.shape[-2] - valid.shape[-2]) // 2
    valid = F.pad(valid, (0, 0, pad, pad, pad, pad))
    valid = resize_bilinear(valid, tuple(im_test.shape[-3:-1])) > 0.9
    return test_conv, valid


def make_sca(alignment_apply: Callable, sr_factor: int = 4,
             gauss_sd: float = 1.5) -> Callable:
    """SCA as ``sca(pred, gt, burst) -> (pred warped and colour-matched,
    valid)``: ``pred``, ``gt`` ``[B, H, W, 3]``, ``burst`` ``[B, N, h, w,
    4]`` with ``H = 2 sr_factor h``. ``alignment_apply(source, target) ->
    flow`` is the aligner (``evaluation/burstsr._alignment_apply_from``);
    it runs without gradient on ``pred / (pred.max() + 1e-6)`` and ``gt /
    (gt.max() + 1e-6)``, the maxima over the whole batch. The gradient
    reaches ``pred`` through the warp (d_feat) and the colour transform."""
    gauss_kernel, _ = get_gaussian_kernel(gauss_sd)

    def sca(pred: torch.Tensor, gt: torch.Tensor,
            burst: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with float32_math():
            with torch.no_grad():
                flow = alignment_apply(pred / (pred.max() + 1e-6),
                                       gt / (gt.max() + 1e-6)).contiguous()
            pred_warped = warp_feat(pred.contiguous(), flow)

            ds = 1.0 / (2.0 * sr_factor)
            h, w = gt.shape[-3], gt.shape[-2]
            ds_hw = (int(h * ds), int(w * ds))
            flow_ds = (resize_bilinear(flow, ds_hw) * ds).contiguous()
            # the base RAW frame as pseudo-RGB: channels (R, Gr, B)
            burst_0 = burst[:, 0][..., [0, 1, 3]].contiguous()
            burst_0_warped = warp_feat(burst_0, flow_ds)
            gt_ds = resize_bilinear(gt, ds_hw)
            return match_colors(gt_ds, burst_0_warped, pred_warped,
                                gauss_kernel)

    return sca


def make_aligned_l2(alignment_apply: Callable, sr_factor: int = 4,
                    boundary_ignore: int = None) -> Callable:
    """AlignedL2: SCA of the prediction to the ground truth, then the
    validity-masked MSE with an optional boundary crop; ``fn(pred, gt,
    burst) -> scalar``."""
    sca = make_sca(alignment_apply, sr_factor)

    def aligned_l2(pred, gt, burst):
        pred_m, valid = sca(pred, gt, burst)
        return metrics.pixel_error(pred_m, gt, "l2", boundary_ignore,
                                   valid.to(torch.float32))

    return aligned_l2
