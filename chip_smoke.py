"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result line):

Phases 4-9 pin the decoder at fine resolution (``fused_s2d=False``,
``fused_s2d_decoder=False``), so that their numbers stay comparable with
the earlier runs; phase 10 drives the s2d decoder, the entry points'
default.

1. environment: torch / CUDA versions, the card's name and power limit;
   the predictor's forward runs its convs and matmuls with TF32 off
   (float32), which the script checks by leaving PyTorch's defaults on;
2. build the ten CUDA kernels (eight sources) from
   ``dbsr_tpu_torch/kernels/csrc`` (one ``nvcc`` per source, all started
   together);
3. each forward kernel against its plain PyTorch version on the card,
   float32, at the shapes the serving forward gives it (B=8, N=14) and at
   those the train step gives it (B=16, N=8), inputs from a fixed seed;
   times of the kernel, the plain version and, where there is one, a
   PyTorch library call as a yardstick (``F.grid_sample`` for the warp; for
   the s2d conv the structured-dense ``F.conv2d`` on the s2d tensor, and,
   for context, the fine-resolution ``F.conv2d`` on the unfolded tensor),
   by CUDA events, median of several runs after warm-up; the s2d conv also
   in its d_input orientation and against the fine-resolution conv, and
   its ``Function``'s backward against autograd of the plain version;
4. serving: ``load_predictor`` on the banked flagship checkpoint (full
   width, batch 8, 14 frames, 48x48 -> 384x384) answers three requests
   (8 bursts, 3 bursts, one burst) with the launch counters reset just
   before and read just after; each kernel must have launched exactly as
   often as its call sites in three forwards ask;
5. the card's forward (kernels) against the CPU forward (plain versions) on
   one burst with the same parameters;
6. the training path's kernels against their plain versions on the card,
   float32, at the shapes the train step gives them (B=16, N=8): the
   affine resample (fused and strict synthesis), the warp's d_feat and
   d_flow (flows up to +-5 px, some on exact integers; also AlignLite's
   backwarp shapes), the cost volume's d_first and d_second (AlignLite's
   three levels and an odd shape; then the ``Function`` on the card) and
   the merge backward, each also against ``torch.autograd.grad`` of the
   plain forward; times of the kernel, the plain version and, where there
   is one, a PyTorch library call (``F.grid_sample`` and its autograd: for
   d_feat with respect to the input alone, for d_flow with respect to
   both) as a yardstick;
7. training with the banked aligner, frozen: (a) one train step of the
   banked flagship at B=1, N=8 on the card against the same step on the
   CPU (loss and every gradient); (b) ``run_training("dbsr",
   "default_synthetic", ...)`` for one epoch of 10 steps at B=16 (20 before
   the pretraining phases were added), then again for a second epoch,
   resumed from the first, with the launch counters reset just before each
   run and read just after: each kernel must have launched exactly as
   often per train step as the step asks; (c) 20 Adam steps on one fixed
   batch from a fresh network with the grafted aligner (the loss must
   fall), timed by CUDA events, with peak memory; (d) a ``torch.profiler``
   trace of three train steps, device time by group;
8. pretraining the aligner: (a) one ``BurstAlignLite`` train step at B=16,
   N=8 on the card against the same step on the CPU from the same fresh
   parameters and batch (loss, all gradients, and each extractor tensor's
   gradient on its own: a gradient that stopped at the cost volumes would
   show there); (b) ``run_training("align_lite", "pretrain_synthetic",
   ...)`` for two epochs of 750 steps with a resume (the
   net leaves the zero-flow plateau after ~750 steps), the exact launches per
   step, ``Stat/epe`` falling and ending below the zero-flow EPE of the
   same batches; (c) step time, peak memory and a profile as in 7c-7d;
9. closing the loop: in the workspace of 8b, ``run_training("dbsr",
   "default_synthetic", ...)`` without ``pwc_checkpoint`` finds and grafts
   that checkpoint and takes 5 steps frozen, then 5 with
   ``train_alignment=True`` (exact launches per step; ``warp_dflow`` and
   the cost volume's backward now run inside DBSR's step); one unfrozen
   step's gradients against the CPU's at B=1; the unfrozen step's time and
   peak memory at B=16;
10. the s2d decoder: (a) ``load_predictor`` with its defaults answers the
    three requests of phase 4 with ``DBSR_FINE_PATCH_S2D=1`` (exactly 8
    ``conv_s2d`` launches per forward) and without it (the structured-dense
    conv, none), and the fine decoder again, each form's bursts/s and peak
    memory; (b) the card's forward with the kernel against the CPU's; (c)
    one ``default_synthetic`` step with ``fused_s2d_decoder=True`` and the
    switch at B=1 on the card against the CPU; (d) ``run_training`` for
    one epoch of 5 steps with the switch (8 + 8 ``conv_s2d`` launches per
    step on top of phase 7's); (e) the B=16 step's time and peak memory with
    the kernel and with the dense conv (the fine form's is 7c's).

The second-to-last line is ``{"kernels": [...]}`` (all ten kernels;
``launches`` is the count on the entry's own ``path``, whose shapes its
times are summed over, except the s2d conv's, whose times are one launch's
and whose path launches it 8 times per forward; ``launches_by_path`` has
the counts on all six paths); the last line is ``{"ok": true, "device":
{...}}``.
"""

import contextlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
FP32_FLOPS_PER_S = 67e12    # H100 SXM float32 rate outside the tensor cores
B, N, HW = 8, 14, 48
# launches per forward: warp serves the 512-channel feature warp and
# AlignLite's two backwarps; correlation runs at AlignLite's three levels;
# the s2d conv runs only in phase 10 (LAUNCHES_S2D_PER_FORWARD)
LAUNCHES_PER_FORWARD = {"warp": 3, "correlation": 3, "merge": 1}
# the decoder's 4 post-shuffle ResBlocks x 2 convs, with the switch
LAUNCHES_S2D_PER_FORWARD = 8
FRAMES = B * (N - 1)
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6   # vs plain on the card: sum order only
CARD_VS_CPU_TOL = 1e-3                  # [0, 1] output, whole network

# training: default_synthetic's batch of 16 8-frame bursts, 48x48 packed
TRAIN_B, TRAIN_N = 16, 8
TRAIN_FRAMES = TRAIN_B * (TRAIN_N - 1)
# launches per train step: the forward's (resample for the synthesis), the
# warp's d_feat and the merge backward; d_flow never (the flow comes from
# the frozen aligner, without gradient)
LAUNCHES_PER_TRAIN_STEP = {"resample": 1, "warp": 3, "correlation": 3,
                           "merge": 1, "warp_dfeat": 1, "warp_dflow": 0,
                           "merge_backward": 1, "correlation_dfirst": 0,
                           "correlation_dsecond": 0, "conv_s2d": 0}
# launches per AlignLite pretraining step: the synthesis' resample; the three
# cost volumes with both gradients each (target and source features both
# train); the two backwarps with d_feat (the source features) and d_flow (the
# coarser level's flow); no merge
LAUNCHES_PER_PRETRAIN_STEP = {"resample": 1, "warp": 2, "correlation": 3,
                              "merge": 0, "warp_dfeat": 2, "warp_dflow": 2,
                              "merge_backward": 0, "correlation_dfirst": 3,
                              "correlation_dsecond": 3, "conv_s2d": 0}
# launches per default_synthetic step with train_alignment=True: the frozen
# step's, and the backward now runs through the flow (the 512-channel warp's
# d_flow) and the aligner (its two backwarps and three cost volumes)
LAUNCHES_PER_UNFROZEN_STEP = {"resample": 1, "warp": 3, "correlation": 3,
                              "merge": 1, "warp_dfeat": 3, "warp_dflow": 3,
                              "merge_backward": 1, "correlation_dfirst": 3,
                              "correlation_dsecond": 3, "conv_s2d": 0}
# launches per default_synthetic step with the s2d decoder and
# DBSR_FINE_PATCH_S2D=1: the frozen step's, and the decoder's 8 post-shuffle
# 3x3 convs launch the s2d conv in the forward and again as d_input
LAUNCHES_PER_S2D_STEP = dict(LAUNCHES_PER_TRAIN_STEP,
                             conv_s2d=2 * LAUNCHES_S2D_PER_FORWARD)
GRAD_TOL = 1e-3    # ||g_card - g_cpu||_2 <= GRAD_TOL ||g_cpu||_2, all grads
LOSS_RTOL = 1e-5   # card vs CPU loss of one train step
PRETRAIN_STEPS = 750  # per epoch of the smoke pretraining, two epochs
# run_training's cuts against default_synthetic (1000 steps x 100 epochs,
# a pool of 2048 sources; val every 5 epochs, so no val pass here)
SMOKE_SETTINGS = dict(steps_per_epoch=10, pool_size=128, print_interval=5,
                      fused_s2d_decoder=False)
# pretraining's cuts against align_lite/pretrain_synthetic (1000 steps x 15
# epochs, a pool of 2048 sources; val every 5 epochs, so no val pass here)
PRETRAIN_SETTINGS = dict(steps_per_epoch=PRETRAIN_STEPS, pool_size=128,
                         print_interval=150)
FINE_PATCH_ENV = "DBSR_FINE_PATCH_S2D"  # the fine-patch s2d conv's switch
ALIGN_LITE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "dbsr_tpu", "artifacts", "align_lite_params.ckpt")


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, warmup=2, reps=10):
    """Median milliseconds of ``fn()`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, want):
    err = (got - want).abs().max().item()
    lim = KERNEL_RTOL * want.abs().max().item() + KERNEL_ATOL
    log(f"  {name}: max|kernel - plain| = {err:.3e} (limit {lim:.3e})")
    if not err <= lim:
        raise AssertionError(f"{name}: kernel disagrees with plain version: "
                             f"{err} > {lim}")
    return err


def kernel_phase(dev, g):
    """Phase 3: the three forward kernels against their plain versions at the
    serving forward's shapes (B=8, N=14; the entry's rows, summed per
    forward) and at the train step's (B=16, N=8; listed apart)."""
    from dbsr_tpu_torch.ops.correlation import (NUM_OFFSETS,
                                                correlation_plain, cost_volume)
    from dbsr_tpu_torch.ops.merge import (fused_softmax_merge,
                                          fused_softmax_merge_plain)
    from dbsr_tpu_torch.ops.warp import base_grid, warp_feat, warp_feat_plain

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def flow(frames, h, w):  # up to +-5 px: out-of-range taps at the borders
        f = (torch.rand(frames, h, w, 2, generator=g, device=dev) * 10 - 5)
        f[:, ::7] = torch.round(f[:, ::7])  # and taps on exact pixel centres
        return f.contiguous()

    def warp_rows(frames):
        # the 512-channel feature warp, then AlignLite's two backwarps
        rows = []
        for s in ((frames, HW, HW, 512), (frames, HW // 2, HW // 2, 48),
                  (frames, HW, HW, 24)):
            feat, fl = randn(*s), flow(*s[:3])
            err = check_close(f"warp {list(s)}", warp_feat(feat, fl),
                              warp_feat_plain(feat, fl))
            # yardstick: grid_sample with the grid equal to p + flow
            grid = _grid_sample_grid(base_grid(s[1], s[2], dev) + fl, s[1],
                                     s[2])
            nchw = feat.permute(0, 3, 1, 2)
            lib = F.grid_sample(nchw, grid, align_corners=False,
                                padding_mode="zeros").permute(0, 2, 3, 1)
            log(f"  warp {list(s)} grid_sample vs plain (info only): "
                f"{(lib - warp_feat_plain(feat, fl)).abs().max().item():.3e}")
            bms, by = bound((2 * feat.numel() + fl.numel()) * 4,
                            7 * feat.numel())
            rows.append(dict(
                shape=list(s), max_abs_err=err,
                ms=cuda_ms(lambda: warp_feat(feat, fl)),
                plain_ms=cuda_ms(lambda: warp_feat_plain(feat, fl), 1, 3),
                library_ms=cuda_ms(lambda: F.grid_sample(
                    nchw, grid, align_corners=False, padding_mode="zeros")),
                bound_ms=bms, bound_by=by))
            del feat, fl, lib, grid, nchw
        return rows

    def correlation_rows(frames):
        # AlignLite's three levels
        rows = []
        for s in ((frames, HW // 4, HW // 4, 96),
                  (frames, HW // 2, HW // 2, 48), (frames, HW, HW, 24)):
            a, b = randn(*s), randn(*s)
            err = check_close(f"correlation {list(s)}", cost_volume(a, b),
                              correlation_plain(a, b))
            npix = s[0] * s[1] * s[2]
            bms, by = bound((2 * a.numel() + npix * NUM_OFFSETS) * 4,
                            2 * NUM_OFFSETS * a.numel())
            rows.append(dict(
                shape=list(s), max_abs_err=err,
                ms=cuda_ms(lambda: cost_volume(a, b)),
                plain_ms=cuda_ms(lambda: correlation_plain(a, b), 1, 3),
                library_ms=None, bound_ms=bms, bound_by=by))
        return rows

    def merge_rows(b, n):
        s = (b, n, HW, HW, 512)
        feat, logits = randn(*s), randn(*s, scale=3.0)
        err = check_close(f"merge {list(s)}", fused_softmax_merge(feat, logits),
                          fused_softmax_merge_plain(feat, logits))
        bms, by = bound((2 * feat.numel() + feat.numel() // n) * 4,
                        6 * feat.numel())
        return [dict(
            shape=list(s), max_abs_err=err,
            ms=cuda_ms(lambda: fused_softmax_merge(feat, logits)),
            plain_ms=cuda_ms(lambda: fused_softmax_merge_plain(feat, logits),
                             1, 3),
            library_ms=None, bound_ms=bms, bound_by=by)]

    csrc = "dbsr_tpu_torch/kernels/csrc/"
    return [
        _entry("warp", csrc + "warp.cu", "dbsr_tpu/ops/warp_pallas.py:118",
               warp_rows(FRAMES), warp_rows(TRAIN_FRAMES)),
        _entry("correlation", csrc + "correlation.cu",
               "dbsr_tpu/ops/correlation.py:85", correlation_rows(FRAMES),
               correlation_rows(TRAIN_FRAMES)),
        _entry("merge", csrc + "merge.cu", "dbsr_tpu/ops/merge_pallas.py:78",
               merge_rows(B, N), merge_rows(TRAIN_B, TRAIN_N)),
        conv_s2d_entry(dev, g)]


def conv_s2d_entry(dev, g):
    """Phase 3, the s2d conv at the decoder's post-shuffle shape (x8: 48^2
    -> 384^2 fine, 192^2 coarse, C = O = 32): the forward at the serving
    batch (the entry's row) and at the train step's, and d_input at the
    train step's (the rotated weight), each against the plain version and
    against the fine-resolution conv of the unfolded input; then the
    ``Function``'s backward (dx by the kernel, dk by PyTorch's weight
    gradient) against ``torch.autograd.grad`` of the plain version. Times
    of one launch, TF32 off: the kernel, the plain version, the
    structured-dense ``F.conv2d`` on the s2d tensor with ``s2d_conv_kernel``
    weights (``library_ms``: the JAX package's default form, 4x the true
    work) and the fine-resolution ``F.conv2d`` on the unfolded tensor
    (``fine_conv_ms``, for context). The bound counts the true conv work,
    2*9*C*O operations per fine output pixel (the kernel skips the block
    weight's zero slots), and x and the output once."""
    from dbsr_tpu_torch.models.layers import (depth_to_space_phase_major,
                                              s2d_conv_kernel,
                                              space_to_depth_phase_major)
    from dbsr_tpu_torch.ops.conv_s2d import (conv3x3_s2d, conv3x3_s2d_forward,
                                             conv3x3_s2d_plain, rotate_weight)
    from dbsr_tpu_torch.serving import float32_math

    C = O = 32
    H2 = W2 = HW * 4
    rows = []
    with float32_math():
        w0 = torch.randn(O, C, 3, 3, generator=g, device=dev) / math.sqrt(
            9 * C)
        for b, orient in ((B, "forward"), (TRAIN_B, "forward"),
                          (TRAIN_B, "d_input")):
            w = rotate_weight(w0) if orient == "d_input" else w0
            x = torch.randn(b, H2, W2, 4 * C, generator=g, device=dev)
            got = conv3x3_s2d_forward(x, w)
            torch.cuda.synchronize()
            name = f"conv_s2d {orient} {[b, H2, W2, 4 * C]}"
            fine_in = depth_to_space_phase_major(x).permute(0, 3, 1, 2)
            fine = space_to_depth_phase_major(
                F.conv2d(fine_in, w, padding=1).permute(0, 2, 3, 1))
            errs = [check_close(name, got, conv3x3_s2d_plain(x, w)),
                    check_close(name + " vs the fine conv", got, fine)]
            del fine
            x_nchw, dense_w = x.permute(0, 3, 1, 2), s2d_conv_kernel(w)
            bms, by = bound((x.numel() + got.numel()) * 4,
                            2 * 9 * O * x.numel())
            rows.append(dict(
                shape=[list(x.shape), list(got.shape)], orientation=orient,
                max_abs_err=errs[0], err_vs_fine_conv=errs[1],
                ms=cuda_ms(lambda: conv3x3_s2d_forward(x, w)),
                plain_ms=cuda_ms(lambda: conv3x3_s2d_plain(x, w), 1, 3),
                library_ms=cuda_ms(lambda: F.conv2d(x_nchw, dense_w,
                                                    padding=1)),
                fine_conv_ms=cuda_ms(lambda: F.conv2d(fine_in, w, padding=1)),
                bound_ms=bms, bound_by=by))
            del got, fine_in, x_nchw
        # the Function's backward at the train step's shape
        gout = torch.randn(x.shape, generator=g, device=dev)
        xs = (x.clone().requires_grad_(True), w0.clone().requires_grad_(True))
        want = torch.autograd.grad(conv3x3_s2d_plain(*xs), xs, gout)
        xk = x.clone().requires_grad_(True)
        wk = w0.clone().requires_grad_(True)
        before = conv3x3_s2d.launches
        conv3x3_s2d(xk, wk).backward(gout)
        torch.cuda.synchronize()
        if conv3x3_s2d.launches - before != 2:
            raise AssertionError("conv_s2d Function: forward and d_input "
                                 "launched "
                                 f"{conv3x3_s2d.launches - before} times")
        rows[-1]["err_vs_autograd"] = check_close(
            "conv_s2d Function dx vs autograd", xk.grad, want[0])
        rows[-1]["dk_err_vs_autograd"] = check_close(
            "conv_s2d Function dk (PyTorch's weight gradient) vs autograd",
            wk.grad, want[1])
    return _entry("conv_s2d", "dbsr_tpu_torch/kernels/csrc/conv_s2d.cu",
                  "dbsr_tpu/ops/conv_s2d_pallas.py:160", rows[:1], rows[1:],
                  path="serving_s2d_3_requests")


def _entry(name, source, replaces, rows, other_rows=(),
           path="serving_3_requests"):
    """A kernel line entry from its rows at the shapes of one pass of its
    path (their sum: one forward's or one step's worth of each time) and
    its rows at other shapes (checked and timed, listed apart). ``path``
    names the driven path that ``launches`` is read from."""
    e = dict(name=name, route="cuda", source=source, replaces=replaces,
             path=path, shape=[r["shape"] for r in rows], per_shape=rows)
    for k in ("ms", "plain_ms", "bound_ms"):
        e[k] = sum(r[k] for r in rows)
    libs = [r["library_ms"] for r in rows]
    e["library_ms"] = sum(libs) if None not in libs else None
    e["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    if all("err_vs_autograd" in r for r in rows):
        e["max_err_vs_autograd"] = max(r["err_vs_autograd"] for r in rows)
    e["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                     else "operations")
    e["other_shapes"] = list(other_rows)
    return e


def _grid_sample_grid(coords, H, W):
    """Pixel (x, y) sampling positions -> ``F.grid_sample``'s normalised
    grid (``align_corners=False``: pixel centres at integers)."""
    return torch.stack([(2 * coords[..., 0] + 1) / W - 1,
                        (2 * coords[..., 1] + 1) / H - 1], dim=-1)


def backward_kernel_phase(dev, g):
    """Phase 6: the training path's four kernels against their plain
    versions (and autograd of the plain forward) at its shapes."""
    from dbsr_tpu_torch.data.synthetic import (BurstConfig, burst_transforms,
                                               sample_draws)
    from dbsr_tpu_torch.ops.interp import apply_affine_to_points, invert_2x3
    from dbsr_tpu_torch.ops.merge import (fused_softmax_merge_backward_plain,
                                          fused_softmax_merge_plain,
                                          merge_backward)
    from dbsr_tpu_torch.ops.resample import (affine_resample,
                                             affine_resample_plain,
                                             fine_grid)
    from dbsr_tpu_torch.ops.warp import (base_grid, warp_dfeat,
                                         warp_dfeat_plain, warp_dflow,
                                         warp_dflow_plain, warp_feat,
                                         warp_feat_backward_plain,
                                         warp_feat_plain)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    results = []

    # resample: fused (d=4, border 24; default_synthetic's path) and strict
    # (d=1) synthesis of a batch, affines drawn as default_synthetic draws
    # them
    cfg = BurstConfig(fused_resample=True)
    H, W = cfg.pre_crop_sz
    images = torch.rand(TRAIN_B, H, W, 3, generator=g, device=dev)
    invs = invert_2x3(burst_transforms(sample_draws(g, TRAIN_B, cfg), (H, W),
                                       cfg)).contiguous()
    rows = []
    d_lr = cfg.downsample_factor
    for out_hw, d, border in (((cfg.crop_sz[0] // d_lr, cfg.crop_sz[1] // d_lr),
                               d_lr, cfg.border_crop), ((H, W), 1, 0)):
        args = (images, invs, out_hw, d, border)
        got = affine_resample(*args)
        err = check_close(f"resample d={d} border={border}", got,
                          affine_resample_plain(*args))
        coords = apply_affine_to_points(invs, fine_grid(out_hw, d, border,
                                                        dev))
        grid = _grid_sample_grid(coords, H, W).reshape(
            TRAIN_B, TRAIN_N * out_hw[0], out_hw[1], 2)
        nchw = images.permute(0, 3, 1, 2)
        lib = F.grid_sample(nchw, grid, align_corners=False,
                            padding_mode="zeros")
        log(f"  resample d={d} grid_sample vs plain (info only): "
            f"{(lib.permute(0, 2, 3, 1).reshape(got.shape) - got).abs().max().item():.3e}")
        nb = (images.numel() + invs.numel() + got.numel()) * 4
        bms, by = bound(nb, got.numel() // 3 * (20 + 8 * 3))
        rows.append(dict(
            shape=[list(images.shape), list(got.shape)], max_abs_err=err,
            ms=cuda_ms(lambda: affine_resample(*args)),
            plain_ms=cuda_ms(lambda: affine_resample_plain(*args), 1, 3),
            library_ms=cuda_ms(lambda: F.grid_sample(
                nchw, grid, align_corners=False, padding_mode="zeros")),
            bound_ms=bms, bound_by=by))
        del got, lib, grid, coords
    results.append(_entry("resample", "dbsr_tpu_torch/kernels/csrc/resample.cu",
                          "dbsr_tpu/ops/resample_pallas.py:121", rows[:1],
                          rows[1:], path="train_step"))
    del images

    # warp backward: the encoder's 512-channel warp, then AlignLite's two
    # backwarp shapes (the aligner's own training, not this path)
    rows_dfeat, rows_dflow = [], []
    for s in ((TRAIN_FRAMES, 48, 48, 512), (TRAIN_FRAMES, 24, 24, 48),
              (TRAIN_FRAMES, 48, 48, 24)):
        feat, gout = randn(*s), randn(*s)
        fl = torch.rand(s[0], s[1], s[2], 2, generator=g, device=dev) * 10 - 5
        fl[:, ::5] = torch.round(fl[:, ::5])  # taps on exact pixel centres
        fl = fl.contiguous()
        want_df, want_dfl = warp_feat_backward_plain(feat, fl, gout)
        xs = (feat.clone().requires_grad_(True), fl.clone().requires_grad_(True))
        auto_df, auto_dfl = torch.autograd.grad(warp_feat_plain(*xs), xs, gout)
        got_df, got_dfl = warp_dfeat(fl, gout), warp_dflow(feat, fl, gout)
        errs = [check_close(f"warp d_feat {list(s)}", got_df, want_df),
                check_close(f"warp d_feat {list(s)} vs autograd", got_df,
                            auto_df),
                check_close(f"warp d_flow {list(s)}", got_dfl, want_dfl),
                check_close(f"warp d_flow {list(s)} vs autograd", got_dfl,
                            auto_dfl)]
        del want_df, want_dfl, auto_df, auto_dfl, xs
        # the library yardsticks, autograd through grid_sample: d_feat's
        # asks for the input's gradient alone (the grid needs none);
        # d_flow's, for both (the whole warp backward: PyTorch has no call
        # for the grid's gradient alone)
        nchw = feat.permute(0, 3, 1, 2).detach().requires_grad_(True)
        grid = _grid_sample_grid(base_grid(s[1], s[2], dev) + fl, s[1], s[2])
        grid_req = grid.detach().requires_grad_(True)
        out_feat = F.grid_sample(nchw, grid, align_corners=False,
                                 padding_mode="zeros")
        out_both = F.grid_sample(nchw, grid_req, align_corners=False,
                                 padding_mode="zeros")
        g_nchw = gout.permute(0, 3, 1, 2)
        n, nf = feat.numel(), fl.numel()
        bms, by = bound((2 * n + nf) * 4, 8 * n)
        rows_dfeat.append(dict(
            shape=list(s), max_abs_err=errs[0], err_vs_autograd=errs[1],
            ms=cuda_ms(lambda: warp_dfeat(fl, gout)),
            plain_ms=cuda_ms(lambda: warp_dfeat_plain(fl, gout), 1, 3),
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                out_feat, nchw, g_nchw, retain_graph=True)),
            bound_ms=bms, bound_by=by))
        bms, by = bound((2 * n + 2 * nf) * 4, 20 * n)
        rows_dflow.append(dict(
            shape=list(s), max_abs_err=errs[2], err_vs_autograd=errs[3],
            ms=cuda_ms(lambda: warp_dflow(feat, fl, gout)),
            plain_ms=cuda_ms(lambda: warp_dflow_plain(feat, fl, gout), 1, 3),
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                out_both, (nchw, grid_req), g_nchw, retain_graph=True)),
            bound_ms=bms, bound_by=by))
        del feat, gout, fl, nchw, grid, grid_req, out_feat, out_both
    # the encoder's warp alone is on the frozen train step; d_flow runs
    # where the aligner trains: all three shapes in a train_alignment step
    results.append(_entry("warp_dfeat", "dbsr_tpu_torch/kernels/csrc/warp_bwd.cu",
                          "dbsr_tpu/ops/warp_pallas.py:178", rows_dfeat[:1],
                          rows_dfeat[1:], path="train_step"))
    results.append(_entry("warp_dflow", "dbsr_tpu_torch/kernels/csrc/warp_bwd.cu",
                          "dbsr_tpu/ops/warp_pallas.py:219", rows_dflow,
                          path="train_alignment_step"))

    # the Function on the card: d_flow only when the flow needs a gradient
    feat = randn(TRAIN_B, 48, 48, 512).requires_grad_(True)
    fl = (torch.rand(TRAIN_B, 48, 48, 2, generator=g, device=dev)
          * 10 - 5)
    gout = randn(*feat.shape)
    for flow_grad in (False, True):
        feat.grad = None
        f = fl.clone().requires_grad_(flow_grad)
        before = warp_dflow.launches
        warp_feat(feat, f).backward(gout)
        torch.cuda.synchronize()
        if warp_dflow.launches - before != int(flow_grad):
            raise AssertionError(f"warp Function: d_flow launched "
                                 f"{warp_dflow.launches - before} times with "
                                 f"flow requires_grad={flow_grad}")
        want_df, want_dfl = warp_feat_backward_plain(feat.detach(), fl, gout)
        check_close(f"warp Function d_feat (flow grad {flow_grad})",
                    feat.grad, want_df)
        if flow_grad:
            check_close("warp Function d_flow", f.grad, want_dfl)
    del feat, fl, gout, f, want_df, want_dfl

    results += correlation_backward_entries(dev, g)

    # merge backward at the training merge's shape
    s = (TRAIN_B, TRAIN_N, 48, 48, 512)
    feat, logits = randn(*s), randn(*s, scale=3.0)
    gout = randn(TRAIN_B, 48, 48, 512)
    got_df, got_dl = merge_backward(feat, logits, gout)
    want_df, want_dl = fused_softmax_merge_backward_plain(feat, logits, gout)
    errs = [check_close(f"merge backward d_feat {list(s)}", got_df, want_df),
            check_close(f"merge backward d_logits {list(s)}", got_dl, want_dl)]
    del want_df, want_dl
    xs = (feat.clone().requires_grad_(True), logits.clone().requires_grad_(True))
    out = fused_softmax_merge_plain(*xs)
    auto_df, auto_dl = torch.autograd.grad(out, xs, gout, retain_graph=True)
    errs += [check_close("merge backward d_feat vs autograd", got_df, auto_df),
             check_close("merge backward d_logits vs autograd", got_dl,
                         auto_dl)]
    del got_df, got_dl, auto_df, auto_dl
    # yardstick: autograd of softmax + weighted sum in PyTorch's own ops
    lib_ms = cuda_ms(lambda: torch.autograd.grad(out, xs, gout,
                                                 retain_graph=True))
    n = feat.numel()
    bms, by = bound((4 * n + gout.numel()) * 4, 16 * n)
    results.append(_entry(
        "merge_backward", "dbsr_tpu_torch/kernels/csrc/merge_bwd.cu",
        "dbsr_tpu/ops/merge_pallas.py:107",
        [dict(shape=list(s), max_abs_err=max(errs[:2]),
              err_vs_autograd=max(errs[2:]),
              ms=cuda_ms(lambda: merge_backward(feat, logits, gout)),
              plain_ms=cuda_ms(lambda: fused_softmax_merge_backward_plain(
                  feat, logits, gout), 1, 3),
              library_ms=lib_ms, bound_ms=bms, bound_by=by)],
        path="train_step"))
    del feat, logits, gout, xs, out
    return results


def correlation_backward_entries(dev, g):
    """Phase 6, the cost volume's d_first and d_second: against their plain
    versions and ``torch.autograd.grad`` of ``correlation_plain`` at
    AlignLite's three training shapes (B=16, N=8) and at an odd one (H != W,
    neither a multiple of the 4x8 tile, C above one staged chunk of 128);
    then the ``Function`` on the card. ``library_ms`` is None: no single
    PyTorch call computes either; autograd of the plain version is
    ``plain_ms``."""
    from dbsr_tpu_torch.ops.correlation import (NUM_OFFSETS,
                                                correlation_dfirst,
                                                correlation_dfirst_plain,
                                                correlation_dsecond,
                                                correlation_dsecond_plain,
                                                correlation_plain, cost_volume)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    rows = {"dfirst": [], "dsecond": []}
    for s in ((TRAIN_FRAMES, 12, 12, 96), (TRAIN_FRAMES, 24, 24, 48),
              (TRAIN_FRAMES, 48, 48, 24), (5, 13, 22, 136)):
        first, second = randn(*s), randn(*s)
        gout = randn(*s[:3], NUM_OFFSETS)
        xs = (first.clone().requires_grad_(True),
              second.clone().requires_grad_(True))
        auto = torch.autograd.grad(correlation_plain(*xs), xs, gout)
        nbytes = (2 * first.numel() + gout.numel()) * 4
        bms, by = bound(nbytes, 2 * NUM_OFFSETS * first.numel())
        for name, fn, plain, operand, want_auto in (
                ("dfirst", correlation_dfirst, correlation_dfirst_plain,
                 second, auto[0]),
                ("dsecond", correlation_dsecond, correlation_dsecond_plain,
                 first, auto[1])):
            got = fn(operand, gout)
            torch.cuda.synchronize()
            errs = [check_close(f"correlation {name} {list(s)}", got,
                                plain(operand, gout)),
                    check_close(f"correlation {name} {list(s)} vs autograd",
                                got, want_auto)]
            rows[name].append(dict(
                shape=list(s), max_abs_err=errs[0], err_vs_autograd=errs[1],
                ms=cuda_ms(lambda: fn(operand, gout)),
                plain_ms=cuda_ms(lambda: plain(operand, gout), 1, 3),
                library_ms=None, bound_ms=bms, bound_by=by))
        del first, second, gout, xs, auto

    # the Function on the card: a volume that needs a gradient has a grad_fn
    # and its backward launches only the kernels whose input needs one;
    # under no_grad nothing is saved
    s = (TRAIN_B, 24, 24, 48)
    first, second, gout = randn(*s), randn(*s), randn(*s[:3], NUM_OFFSETS)
    for needs in ((True, True), (True, False), (False, True)):
        a = first.clone().requires_grad_(needs[0])
        b = second.clone().requires_grad_(needs[1])
        before = (correlation_dfirst.launches, correlation_dsecond.launches)
        out = cost_volume(a, b)
        if out.grad_fn is None:
            raise AssertionError("cost_volume on the card has no grad_fn")
        out.backward(gout)
        torch.cuda.synchronize()
        ran = (correlation_dfirst.launches - before[0],
               correlation_dsecond.launches - before[1])
        if ran != tuple(int(n) for n in needs):
            raise AssertionError(f"cost_volume Function: backward launched "
                                 f"(d_first, d_second) {ran} times with "
                                 f"requires_grad={needs}")
        if needs[0]:
            check_close(f"cost_volume Function d_first (needs {needs})",
                        a.grad, correlation_dfirst_plain(second, gout))
        if needs[1]:
            check_close(f"cost_volume Function d_second (needs {needs})",
                        b.grad, correlation_dsecond_plain(first, gout))
    with torch.no_grad():
        out = cost_volume(first.requires_grad_(True), second)
    if out.grad_fn is not None or out.requires_grad:
        raise AssertionError("cost_volume under no_grad kept a graph")

    csrc = "dbsr_tpu_torch/kernels/csrc/correlation_bwd.cu"
    return [_entry("correlation_dfirst", csrc,
                   "dbsr_tpu/ops/correlation.py:163", rows["dfirst"][:3],
                   rows["dfirst"][3:], path="pretrain_step"),
            _entry("correlation_dsecond", csrc,
                   "dbsr_tpu/ops/correlation.py:178", rows["dsecond"][:3],
                   rows["dsecond"][3:], path="pretrain_step")]


def _counters():
    from dbsr_tpu_torch.ops.conv_s2d import conv3x3_s2d
    from dbsr_tpu_torch.ops.correlation import (correlation_dfirst,
                                                correlation_dsecond,
                                                cost_volume)
    from dbsr_tpu_torch.ops.merge import fused_softmax_merge, merge_backward
    from dbsr_tpu_torch.ops.resample import affine_resample
    from dbsr_tpu_torch.ops.warp import warp_dfeat, warp_dflow, warp_feat
    return {"resample": affine_resample, "warp": warp_feat,
            "correlation": cost_volume, "merge": fused_softmax_merge,
            "warp_dfeat": warp_dfeat, "warp_dflow": warp_dflow,
            "merge_backward": merge_backward,
            "correlation_dfirst": correlation_dfirst,
            "correlation_dsecond": correlation_dsecond,
            "conv_s2d": conv3x3_s2d}


def reset_counts():
    for w in _counters().values():
        w.launches = 0


def read_counts():
    return {k: w.launches for k, w in _counters().items()}


def check_counts(what, counts, steps, per_step=None):
    per_step = per_step or LAUNCHES_PER_TRAIN_STEP
    want = {k: v * steps for k, v in per_step.items()}
    log(f"launches over {what} ({steps} train steps): {counts}")
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want} "
                             f"({per_step} per train step)")


def card_vs_cpu(what, out, prefix=None, each=True):
    """Compare one train step on the card with the same step on the CPU:
    ``out[device] = (loss, {name: grad}, seconds)``. The loss within
    LOSS_RTOL, all gradients together within GRAD_TOL of their norm; the
    tensors under ``prefix`` together within GRAD_TOL of their own norm and,
    with ``each``, every one of them within GRAD_TOL of its own norm."""
    (l_card, g_card, s_card), (l_cpu, g_cpu, s_cpu) = out["cuda"], out["cpu"]
    if set(g_card) != set(g_cpu):
        raise AssertionError(f"{what}: gradients of different tensors")
    rel_loss = abs(l_card - l_cpu) / abs(l_cpu)
    diff2 = sum(float(((g_card[k] - g_cpu[k]) ** 2).sum()) for k in g_cpu)
    norm2 = sum(float((g_cpu[k] ** 2).sum()) for k in g_cpu)
    rel_grad = math.sqrt(diff2 / norm2)

    def rel(k):
        return float((g_card[k] - g_cpu[k]).norm()) \
            / max(float(g_cpu[k].norm()), 1e-30)

    worst = max(g_cpu, key=rel)
    worst_rel = rel(worst)
    worst_share = float(g_cpu[worst].norm()) / math.sqrt(norm2)
    log(f"{what}, card vs CPU: loss {l_card:.8f} vs {l_cpu:.8f} (rel "
        f"{rel_loss:.2e}, limit {LOSS_RTOL}); all {len(g_cpu)} gradients "
        f"||diff||/||g|| {rel_grad:.2e} (limit {GRAD_TOL}); worst tensor "
        f"{worst}: ||diff||/||its g|| {worst_rel:.2e}, its ||g|| "
        f"{worst_share:.2e} of the whole (a tensor whose true gradient is ~0, "
        f"such as the bias of the merge's logits, to which the frame softmax "
        f"is blind, shows rounding noise here); step {s_card:.1f} s on the "
        f"card (first, with set-up), {s_cpu:.1f} s on the CPU")
    res = dict(loss_rel=rel_loss, grad_rel=rel_grad, worst_tensor=worst,
               worst_tensor_rel=worst_rel, worst_tensor_norm_share=worst_share)
    if not rel_loss <= LOSS_RTOL:
        raise AssertionError(f"{what}: card vs CPU loss: {rel_loss} > "
                             f"{LOSS_RTOL}")
    if not rel_grad <= GRAD_TOL:
        raise AssertionError(f"{what}: card vs CPU gradients: {rel_grad} > "
                             f"{GRAD_TOL}")
    if prefix is not None:
        own = {k: rel(k) for k in g_cpu if k.startswith(prefix)}
        if not own:
            raise AssertionError(f"{what}: no gradient under {prefix}")
        k_max = max(own, key=own.get)
        own_norm2 = sum(float((g_cpu[k] ** 2).sum()) for k in own)
        own_rel = math.sqrt(sum(float(((g_card[k] - g_cpu[k]) ** 2).sum())
                                for k in own) / own_norm2)
        log(f"  the {len(own)} tensors under {prefix}: together "
            f"||diff||/||their g|| {own_rel:.2e} (limit {GRAD_TOL}), their "
            f"||g|| {math.sqrt(own_norm2 / norm2):.2e} of the whole; worst "
            f"single tensor ||diff||/||its g|| {own[k_max]:.2e} ({k_max}"
            + (f"; limit {GRAD_TOL})" if each else "; reported only)"))
        if not own_rel <= GRAD_TOL:
            raise AssertionError(f"{what}: {prefix}: {own_rel} > {GRAD_TOL}")
        if each and not own[k_max] <= GRAD_TOL:
            raise AssertionError(f"{what}: {k_max}: {own[k_max]} > {GRAD_TOL}")
        res.update(prefix=prefix, prefix_rel=own_rel,
                   prefix_worst_tensor=k_max, prefix_worst_rel=own[k_max])
    return res


def _grads(net):
    return {k: p.grad.detach().cpu() for k, p in net.named_parameters()
            if p.requires_grad}


def grad_phase(train_alignment=False, flow_ckpt=None, s2d=False):
    """Phases 7a, 9 and 10c: one train step of the banked flagship (B=1,
    N=8) on the card and on the CPU from the same batch, synthesised on the
    CPU; the decoder at fine resolution, or with ``s2d`` in the s2d layout
    (under the caller's ``DBSR_FINE_PATCH_S2D``); with ``train_alignment``
    the aligner of ``flow_ckpt`` is grafted and
    trains too, and the aligner's gradients are also held together on their
    own (not tensor by tensor: the flow heads' two-element bias gradients
    are sums of d_flow over all pixels that largely cancel, and their
    relative error moved between 3.6e-4 and 7.0e-4 from run to run with
    the d_feat atomics' order and the freshly pretrained aligner)."""
    from dbsr_tpu_torch.configs.dbsr.default_synthetic import \
        graft_alignment_params
    from dbsr_tpu_torch.data.procedural import (dead_leaves_image,
                                                make_generator)
    from dbsr_tpu_torch.data.synthetic import BurstConfig, synthesize_batch
    from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT, float32_math
    from dbsr_tpu_torch.training.actors import make_synthetic_actor
    from dbsr_tpu_torch.training.checkpoint import load_network

    cfg = BurstConfig(fused_resample=True)
    gen = make_generator("cpu", 11)
    batch = synthesize_batch(gen, dead_leaves_image(gen, 1, cfg.pre_crop_sz),
                             cfg)
    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        net, _ = load_network(FLAGSHIP_CHECKPOINT, device=device, dtype=None,
                              train_alignment=train_alignment,
                              fused_s2d_decoder=s2d)
        if flow_ckpt is not None:
            graft_alignment_params(net, flow_ckpt)
        b = {k: batch[k].to(device) for k in ("burst", "frame_gt")}
        reset_counts()
        with float32_math():
            loss, _ = make_synthetic_actor(net, boundary_ignore=40)(b)
            loss.backward()
        if device == "cuda":
            torch.cuda.synchronize()
            launches = read_counts()
        out[device] = (loss.item(), _grads(net), time.perf_counter() - t0)
        del net
    what = ("train step (banked flagship, B=1, N=8"
            + (", the port's own aligner grafted, train_alignment=True"
               if train_alignment else "")
            + (f", s2d decoder, {FINE_PATCH_ENV}="
               f"{os.environ.get(FINE_PATCH_ENV)})" if s2d else ")"))
    log(f"{what}: launches on the card {launches}")
    res = card_vs_cpu(what, out, "encoder.alignment_net."
                      if train_alignment else None, each=False)
    res["launches"] = launches
    return res


def pretrain_grad_phase(dev):
    """Phase 8a: one ``BurstAlignLite`` train step at full width (B=16, N=8)
    on the card and on the CPU, from the same fresh parameters and the same
    batch (synthesised on the card, copied to the CPU). A gradient that
    stopped at the cost volumes would still be non-zero (the extractor also
    feeds the decoders directly), so each extractor tensor's gradient is
    held against the CPU's on its own."""
    from dbsr_tpu_torch.data.procedural import (dead_leaves_image,
                                                make_generator)
    from dbsr_tpu_torch.data.synthetic import BurstConfig, synthesize_batch
    from dbsr_tpu_torch.models.align_lite import BurstAlignLite
    from dbsr_tpu_torch.models.layers import init_params
    from dbsr_tpu_torch.serving import float32_math
    from dbsr_tpu_torch.training.actors import make_lite_flow_actor

    cfg = BurstConfig(fused_resample=True)
    gen = make_generator(dev, 21)
    with float32_math():
        batch = synthesize_batch(
            gen, dead_leaves_image(gen, TRAIN_B, cfg.pre_crop_sz), cfg)
    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        net = init_params(BurstAlignLite(), make_generator("cpu", 22))
        net = net.to(device)
        b = {k: batch[k].to(device) for k in ("burst", "flow")}
        reset_counts()
        with float32_math():
            loss, stats = make_lite_flow_actor(net)(b)
            loss.backward()
        if device == "cuda":
            torch.cuda.synchronize()
            counts = read_counts()
            want = dict(LAUNCHES_PER_PRETRAIN_STEP, resample=0)
            if counts != want:
                raise AssertionError(f"pretrain step: launches {counts}, "
                                     f"expected {want}")
        out[device] = (loss.item(), _grads(net), time.perf_counter() - t0)
        del net
    return card_vs_cpu(f"pretrain step (fresh BurstAlignLite, B={TRAIN_B}, "
                       f"N={TRAIN_N})", out, "alignment_net.extractor.")


def entry_phase(module, config, kwargs, epochs_list, per_step_want,
                net_name):
    """Drive ``run_training(module, config, ...)`` once for each entry of
    ``epochs_list`` (each run resumes from the one before), the launch
    counters reset just before each run and read just after: each kernel
    must have launched exactly ``per_step_want`` times per train step.
    Returns the launches per step, the logged running stats by name, the
    printed text and the checkpoint headers by epoch."""
    from dbsr_tpu_torch.run_training import run_training
    from dbsr_tpu_torch.training.checkpoint import (list_checkpoints,
                                                    read_header)

    steps = kwargs["steps_per_epoch"]
    logged, texts, per_step, done = defaultdict(list), [], None, 0
    for epochs in epochs_list:
        buf = io.StringIO()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            state = run_training(module, config, epochs=epochs, **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        text = buf.getvalue()
        texts.append(text)
        for line in text.splitlines():
            log(f"  | {line}")
        ran = (epochs - done) * steps
        check_counts(f"run_training {module} {config} epochs={epochs}",
                     counts, ran, per_step_want)
        per_step = {k: v // ran for k, v in counts.items()}
        if state.step != epochs * steps:
            raise AssertionError(f"step {state.step} after {epochs} epochs")
        if "Training crashed" in text or "ivergence" in text:
            raise AssertionError("run_training restarted an epoch")
        if done and not re.search(rf"resumed from \S+_ep{done:04d}\.ckpt "
                                  rf"\(epoch {done}", text):
            raise AssertionError(f"the run did not resume from epoch {done}")
        for name, v in re.findall(r"(\S+/\S+): (-?[\d.]+(?:e-?\d+)?|nan|inf)",
                                  text):
            logged[name].append(float(v))
        log(f"run_training {module} {config} epochs={epochs}: {wall:.1f} s "
            f"wall")
        done = epochs
    workspace = os.path.join(os.environ["DBSR_TPU_WORKSPACE_DIR"], module,
                             config)
    ckpts = list_checkpoints(workspace, net_name)
    log(f"checkpoints: {[os.path.basename(p) for _, p in ckpts]}")
    if not ckpts or ckpts[-1][0] != epochs_list[-1]:
        raise AssertionError(f"no epoch-{epochs_list[-1]} checkpoint")
    losses = logged["Loss/total"]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"logged losses not all finite: {losses}")
    log(f"logged running losses: {losses}")
    return per_step, dict(logged), texts, {e: read_header(p)
                                           for e, p in ckpts}


def training_entry_phase():
    """Phase 7b: the training entry with the banked aligner, one epoch, then
    a second resumed from the first; the main path's exact launch counts per
    train step."""
    kwargs = dict(SMOKE_SETTINGS, pwc_checkpoint=ALIGN_LITE)
    log(f"run_training cuts against default_synthetic: steps_per_epoch "
        f"{kwargs['steps_per_epoch']} of 1000, epochs 2 of 100, pool_size "
        f"{kwargs['pool_size']} of 2048; no val pass (every 5 epochs); "
        f"full width, B={TRAIN_B}, N={TRAIN_N}, 384^2 crops")
    per_step, logged, _, _ = entry_phase(
        "dbsr", "default_synthetic", kwargs, (1, 2), LAUNCHES_PER_TRAIN_STEP,
        "dbsr_synthetic")
    return per_step, logged["Loss/total"]


def zero_flow_epe(dev, epoch):
    """The end-point error of the zero flow on the batches that epoch
    ``epoch`` of the smoke pretraining trained on: the mean norm of the
    target (the negated synthesis flow pooled to the packed grid), over the
    same pools, crops and draws, made again from the trainer's own stream."""
    from dbsr_tpu_torch.configs.align_lite import pretrain_synthetic
    from dbsr_tpu_torch.serving import float32_math
    from dbsr_tpu_torch.training.actors import (end_point_error,
                                                pack_flow_to)

    trainer = pretrain_synthetic.make_trainer(_settings(**PRETRAIN_SETTINGS),
                                              dev)
    trainer.epoch = epoch
    loader = trainer.loaders[0]
    gen = trainer.cycle_generator(loader)
    total = torch.zeros((), device=dev)
    with torch.no_grad(), float32_math():
        for _ in range(loader.num_batches()):
            batch = trainer.prepare_fn(gen, loader.batcher.next_batch())
            h, w = batch["burst"].shape[2:4]
            gt = pack_flow_to(-batch["flow"][:, 1:], (h, w))
            total += end_point_error(gt).mean()
    return float(total) / loader.num_batches()


def pretrain_entry_phase(dev):
    """Phase 8b: ``run_training("align_lite", "pretrain_synthetic")`` for
    one epoch, then a second resumed from the first; the exact launches per
    pretraining step; the epoch's mean ``Stat/epe`` must fall from the first
    epoch to the second and end below the zero-flow EPE of the second
    epoch's own batches."""
    log(f"run_training cuts against align_lite/pretrain_synthetic: "
        f"steps_per_epoch {PRETRAIN_STEPS} of 1000, epochs 2 of 15, pool_size "
        f"{PRETRAIN_SETTINGS['pool_size']} of 2048; no val pass (every 5 "
        f"epochs); full width, B={TRAIN_B}, N={TRAIN_N}, 384^2 crops")
    per_step, logged, _, headers = entry_phase(
        "align_lite", "pretrain_synthetic", dict(PRETRAIN_SETTINGS), (1, 2),
        LAUNCHES_PER_PRETRAIN_STEP, "align_lite")
    epe = {e: h["stats"]["train"]["Stat/epe"] for e, h in headers.items()}
    acc = {e: h["stats"]["train"]["Stat/acc_0.5px"]
           for e, h in headers.items()}
    zero = {e: zero_flow_epe(dev, e) for e in (1, 2)}
    log(f"pretraining, mean Stat/epe by epoch (packed px): {epe}; zero-flow "
        f"EPE of the same batches: {zero}; Stat/acc_0.5px: {acc}; running "
        f"Stat/epe as logged: {logged['Stat/epe']}")
    if headers[2]["net_spec"]["cls"] != "BurstAlignLite":
        raise AssertionError(f"checkpoint header: {headers[2]['net_spec']}")
    if not epe[2] < epe[1]:
        raise AssertionError(f"Stat/epe did not fall: {epe}")
    if not epe[2] < zero[2]:
        raise AssertionError(f"Stat/epe {epe[2]} of epoch 2 is not below the "
                             f"zero-flow EPE {zero[2]} of its batches")
    return per_step, dict(epe_by_epoch=epe, zero_flow_epe_by_epoch=zero,
                          acc_half_px_by_epoch=acc,
                          running_epe=logged["Stat/epe"])


def _step_part(evt):
    """The part of the train step whose host code launched a profiled
    operator: the labels the profile phase puts on synthesis and the
    forward, the autograd engine's nodes, torch.optim's own label."""
    while evt is not None:
        if evt.name in ("synthesis", "forward"):
            return evt.name
        if evt.name.startswith("autograd::engine::evaluate_function"):
            return "backward"
        if evt.name.startswith("Optimizer.step"):
            return "optimizer"
        evt = evt.cpu_parent
    return "other"


def _labelled(label, fn):
    def call(*args):
        with torch.profiler.record_function(label):
            return fn(*args)
    return call


def _settings(**kwargs):
    from dbsr_tpu_torch.environment import Settings

    settings = Settings()
    for k, v in kwargs.items():
        setattr(settings, k, v)
    return settings


def default_synthetic_trainer(dev, **kwargs):
    """``default_synthetic``'s trainer from a fresh network with the found
    or given aligner grafted, on a pool of one batch."""
    from dbsr_tpu_torch.configs.dbsr.default_synthetic import (
        graft_alignment_params, make_trainer)

    with contextlib.redirect_stdout(io.StringIO()):
        trainer, flow_ckpt = make_trainer(
            _settings(**dict(SMOKE_SETTINGS, pool_size=TRAIN_B, **kwargs)),
            dev)
    state = trainer.init_state()
    graft_alignment_params(trainer.net, flow_ckpt)
    return trainer, state


def pretrain_trainer(dev):
    """``align_lite/pretrain_synthetic``'s trainer from a fresh network, on
    a pool of one batch."""
    from dbsr_tpu_torch.configs.align_lite import pretrain_synthetic

    trainer = pretrain_synthetic.make_trainer(
        _settings(**dict(PRETRAIN_SETTINGS, pool_size=TRAIN_B)), dev)
    return trainer, trainer.init_state()


def step_phase(dev, what, trainer, state, per_step_want, n_steps=20):
    """Phases 7c-7d, 8c and 9: ``n_steps`` Adam steps of ``trainer`` on one
    fixed batch (the generator is reseeded each step, so the crop draw and
    synthesis repeat), timed by CUDA events, the loss must fall; then a
    profile of three train steps, its device time by part of the step
    (synthesis, forward, backward, optimizer) and by kernel group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dbsr_tpu_torch.data.procedural import make_generator
    from dbsr_tpu_torch.profile_serving import kernel_group, kernel_us

    pool = trainer.loaders[0].batcher.next_batch()

    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(n_steps):
        if i == 3:
            reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        stats = trainer.train_step(state, make_generator(dev, 7), pool)
        end.record()
        if i == 3:
            torch.cuda.synchronize()
            check_counts(f"one step, {what}", read_counts(), 1,
                         per_step_want)
        losses.append(stats["Loss/total"])
        times.append((start, end))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in losses]
    step_ms = statistics.median(s.elapsed_time(e) for s, e in times[5:])
    log(f"{what}: fixed batch, {n_steps} Adam steps from a fresh network: "
        f"loss {losses[0]:.6f} -> {losses[-1]:.6f}; all: "
        + ", ".join(f"{v:.5f}" for v in losses))
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: the loss did not fall over {n_steps} "
                             f"steps on one batch")
    log(f"{what}: step at B={TRAIN_B}: median {step_ms:.2f} ms (CUDA events, "
        f"steps 6-{n_steps}), {TRAIN_B / step_ms * 1e3:.2f} samples/s, peak "
        f"memory {peak:.2f} GiB")
    gen = make_generator(dev, 8)
    synth_ms = cuda_ms(lambda: trainer.prepare_fn(gen, pool), 1, 5)

    gen = make_generator(dev, 9)
    trainer.prepare_fn = _labelled("synthesis", trainer.prepare_fn)
    trainer.actor_fn = _labelled("forward", trainer.actor_fn)
    for _ in range(2):
        trainer.train_step(state, gen, pool)
    torch.cuda.synchronize()
    steps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(state, gen, pool)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, kernel_us(e), e.count) for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    if busy_us == 0:
        raise AssertionError("the profile holds no device time")
    groups = defaultdict(float)
    for name, us, _ in rows:
        groups[kernel_group(name)] += us
    log(f"{what}: profile of {steps} train steps: wall {wall_us / steps / 1e3:.2f} "
        f"ms/step, device busy {busy_us / steps / 1e3:.2f} ms/step "
        f"({100 * busy_us / wall_us:.1f}% of wall); synthesis (prepare "
        f"alone, CUDA events) {synth_ms:.2f} ms")
    for name, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {name}: {us / steps / 1e3:.3f} ms/step "
            f"({100 * us / busy_us:.1f}%)")
    log("  top kernels (ms/step, launches/step):")
    for name, us, n in rows[:12]:
        log(f"    {us / steps / 1e3:8.3f}  {n / steps:6.1f}  {name[:90]}")
    # each kernel in the part of the step whose host operator launched it;
    # what the profiler links to no operator (some of the kernels launched
    # through ctypes) is listed as not placed
    split = defaultdict(lambda: defaultdict(float))
    for evt in prof.events():
        if evt.device_type == DeviceType.CPU:
            for k in evt.kernels:
                split[_step_part(evt)][kernel_group(k.name)] += \
                    k.duration / steps / 1e3
    placed = sum(sum(g.values()) for g in split.values())
    for group, us in groups.items():
        rest = us / steps / 1e3 - sum(g.get(group, 0.0)
                                      for g in split.values())
        if rest > 5e-4:
            split["not placed"][group] = rest
    log(f"  by part of the step ({100 * placed * steps * 1e3 / busy_us:.1f}% "
        f"of the device time placed), ms/step:")
    for part, g in sorted(split.items(), key=lambda kv: -sum(kv[1].values())):
        log(f"    {part}: {sum(g.values()):.3f} (" + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(g.items(),
                                                key=lambda kv: -kv[1])) + ")")
    return dict(step_ms=step_ms, samples_per_s=TRAIN_B / step_ms * 1e3,
                peak_mem_gib=peak, fixed_batch_losses=losses,
                synthesis_ms=synth_ms,
                profile_ms_per_step={k: v / steps / 1e3
                                     for k, v in groups.items()},
                profile_ms_per_step_by_part={p: dict(g)
                                             for p, g in split.items()},
                device_busy_share=busy_us / wall_us)


def closing_phase(dev):
    """Phase 9: in the workspace that the smoke pretraining wrote,
    ``default_synthetic`` with no ``pwc_checkpoint`` finds the port's own
    aligner checkpoint, grafts it and takes a few steps frozen; asking the
    same workspace for ``train_alignment=True`` is refused; from a fresh
    ``dbsr`` workspace it takes a few steps with the aligner unfrozen. Then
    one unfrozen step's gradients against the CPU's (B=1), and the unfrozen
    step's time and peak memory at B=16."""
    import shutil

    from dbsr_tpu_torch.run_training import run_training
    from dbsr_tpu_torch.training.checkpoint import resolve_checkpoint

    workspace = os.environ["DBSR_TPU_WORKSPACE_DIR"]
    flow_ckpt = resolve_checkpoint(os.path.join(
        workspace, "align_lite", "pretrain_synthetic"), "align_lite")
    out = {}
    for name, extra, want in (
            ("frozen", {}, LAUNCHES_PER_TRAIN_STEP),
            ("train_alignment", {"train_alignment": True},
             LAUNCHES_PER_UNFROZEN_STEP)):
        kwargs = dict(SMOKE_SETTINGS, steps_per_epoch=5, **extra)
        if extra:
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    run_training("dbsr", "default_synthetic", epochs=2,
                                 **kwargs)
            except ValueError as e:
                if "cross-restore" not in str(e):
                    raise
                log(f"resume of the frozen run's workspace with "
                    f"train_alignment=True refused: {e}")
            else:
                raise AssertionError("a masked workspace resumed unmasked")
            shutil.rmtree(os.path.join(workspace, "dbsr"))
        per_step, logged, texts, headers = entry_phase(
            "dbsr", "default_synthetic", kwargs, (1,), want, "dbsr_synthetic")
        if (f"using pretrained flow weights: {flow_ckpt} (flow_net=lite, "
                f"train_alignment={bool(extra)})") not in texts[0] \
                or "grafted pretrained flow weights" not in texts[0]:
            raise AssertionError(f"{name}: the port's own aligner checkpoint "
                                 f"{flow_ckpt} was not found and grafted")
        if headers[1]["settings"] != {"masked_adam": not extra}:
            raise AssertionError(f"{name}: header {headers[1]['settings']}")
        out[name] = dict(launches_per_step=per_step,
                         losses=logged["Loss/total"])
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = grad_phase(train_alignment=True,
                                    flow_ckpt=flow_ckpt)
    torch.cuda.empty_cache()
    trainer, state = default_synthetic_trainer(dev, train_alignment=True)
    out["step"] = step_phase(dev, "default_synthetic, train_alignment=True",
                             trainer, state, LAUNCHES_PER_UNFROZEN_STEP,
                             n_steps=10)
    return out


def serve(what, pred, requests, per_forward):
    """Phases 4 and 10a: the three requests with the launch counters reset
    just before and read just after (each kernel exactly ``per_forward``
    times per forward, the rest never), outputs checked; then the median
    request at batch 8 (host clock: it ends in a copy to the host), the
    forward by CUDA events and the peak memory of the timed requests."""
    reset_counts()
    torch.cuda.synchronize()
    outs = [pred(r) for r in requests]
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"{what}: launches over the three requests (3 forwards): {launches}")
    for r, o in zip(requests, outs):
        n = r.shape[0] if r.ndim == 5 else 1
        if o.shape != (n, HW * 8, HW * 8, 3):
            raise AssertionError(f"output shape {o.shape} for {n} bursts")
        if not np.isfinite(o).all() or o.min() < 0 or o.max() > 1:
            raise AssertionError("output not finite or outside [0, 1]")
    for k in launches:
        want = per_forward.get(k, 0)  # no backward here
        if launches[k] != want * len(requests):
            raise AssertionError(f"{what}: {k}: {launches[k]} launches in "
                                 f"{len(requests)} forwards, expected {want} "
                                 f"per forward")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        pred(requests[0])
    for _ in range(5):
        t0 = time.perf_counter()
        pred(requests[0])  # ends in a copy to the host: synchronous
        times.append(time.perf_counter() - t0)
    req_s = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    x = torch.from_numpy(requests[0]).to(pred.device)
    fwd_ms = cuda_ms(lambda: pred.forward(x), 1, 5)
    log(f"{what}: request at batch {B}: median {req_s * 1e3:.1f} ms over 5 "
        f"({B / req_s:.2f} bursts/s), peak memory {peak:.2f} GiB; forward "
        f"{fwd_ms:.2f} ms (CUDA events)")
    return dict(bursts_per_s=B / req_s, request_ms=req_s * 1e3,
                forward_ms=fwd_ms, peak_mem_gib=peak, launches=launches)


def forward_vs_cpu(pred, burst, **net_kwargs):
    """Phases 5 and 10b: the card's forward of ``pred`` (kernels) against
    the CPU's (plain versions) of the banked flagship rebuilt with
    ``net_kwargs``, on one burst; the largest difference of the [0, 1]
    output, which must stay within CARD_VS_CPU_TOL."""
    from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT
    from dbsr_tpu_torch.training.checkpoint import load_network

    cpu_net, _ = load_network(FLAGSHIP_CHECKPOINT, device="cpu", dtype=None,
                              **net_kwargs)
    on_card = pred.forward(torch.from_numpy(burst).to(pred.device))
    on_card = on_card.clamp(0, 1).cpu()
    with torch.inference_mode():
        t0 = time.perf_counter()
        on_cpu = cpu_net(torch.from_numpy(burst))[0].clamp(0, 1)
    cpu_s = time.perf_counter() - t0
    diff = (on_card - on_cpu).abs().max().item()
    log(f"card (kernels) vs CPU (plain) forward, 1 burst, {net_kwargs}, "
        f"{FINE_PATCH_ENV}={os.environ.get(FINE_PATCH_ENV)}: max|diff| "
        f"{diff:.3e} (limit {CARD_VS_CPU_TOL}); CPU forward {cpu_s:.1f} s")
    if not diff <= CARD_VS_CPU_TOL:
        raise AssertionError(f"card vs CPU: {diff} > {CARD_VS_CPU_TOL}")
    return diff


@contextlib.contextmanager
def fine_patch(on):
    """``DBSR_FINE_PATCH_S2D`` set to 1 (``on``) or unset for the block,
    then as it was before."""
    saved = os.environ.pop(FINE_PATCH_ENV, None)
    if on:
        os.environ[FINE_PATCH_ENV] = "1"
    try:
        yield
    finally:
        os.environ.pop(FINE_PATCH_ENV, None)
        if saved is not None:
            os.environ[FINE_PATCH_ENV] = saved


def s2d_phase(dev, requests):
    """Phase 10: the s2d decoder, the entry points' default, through the
    entry points: serving in the three decoder forms (10a-b), one train
    step's gradients against the CPU's (10c), ``run_training`` (10d) and
    the B=16 step (10e). Returns the launches of the three requests with
    the switch (``launches``) and per ``run_training`` step
    (``launches_per_step``) beside the measurements."""
    from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT, load_predictor

    out = {"serving_b8": {}, "step": {}}
    for form, on, kwargs in (("s2d_kernel", True, {}),
                             ("s2d_dense", False, {}),
                             ("fine", False, {"fused_s2d": False})):
        with fine_patch(on):
            pred = load_predictor(FLAGSHIP_CHECKPOINT, batch_size=B,
                                  burst_size=N, burst_hw=(HW, HW),
                                  device="cuda", **kwargs)
            if pred.net.decoder.s2d != (form != "fine"):
                raise AssertionError(f"{form}: decoder s2d "
                                     f"{pred.net.decoder.s2d}")
            res = serve(f"serving, {form} decoder", pred, requests,
                        dict(LAUNCHES_PER_FORWARD, conv_s2d=(
                            LAUNCHES_S2D_PER_FORWARD if on else 0)))
            if on:
                out["launches"] = res.pop("launches")
                res["card_vs_cpu_max_abs"] = forward_vs_cpu(pred,
                                                            requests[2][None])
            else:
                del res["launches"]
        out["serving_b8"][form] = res
        del pred
        torch.cuda.empty_cache()

    with fine_patch(True):
        out["card_vs_cpu"] = grad_phase(s2d=True)
        want = dict(LAUNCHES_PER_S2D_STEP, resample=0)  # CPU synthesis
        if out["card_vs_cpu"]["launches"] != want:
            raise AssertionError(f"s2d train step: launches "
                                 f"{out['card_vs_cpu']['launches']}, "
                                 f"expected {want}")
        torch.cuda.empty_cache()
        kwargs = dict(SMOKE_SETTINGS, steps_per_epoch=5,
                      pwc_checkpoint=ALIGN_LITE, fused_s2d_decoder=True)
        per_step, logged, _, headers = entry_phase(
            "dbsr", "default_synthetic", kwargs, (1,), LAUNCHES_PER_S2D_STEP,
            "dbsr_synthetic")
        if not headers[1]["net_spec"]["kwargs"]["fused_s2d_decoder"]:
            raise AssertionError(f"header: {headers[1]['net_spec']}")
        out["launches_per_step"] = per_step
        out["run_training_losses"] = logged["Loss/total"]
        torch.cuda.empty_cache()
    for form, on in (("s2d_kernel", True), ("s2d_dense", False)):
        with fine_patch(on):
            trainer, state = default_synthetic_trainer(
                dev, pwc_checkpoint=ALIGN_LITE, fused_s2d_decoder=True)
            out["step"][form] = step_phase(
                dev, f"default_synthetic, {form} decoder", trainer, state,
                LAUNCHES_PER_S2D_STEP if on else LAUNCHES_PER_TRAIN_STEP,
                n_steps=10)
        del trainer, state
        torch.cuda.empty_cache()
    return out


def main():
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; nothing to measure")
        return 2
    from dbsr_tpu_torch import kernels
    from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT, load_predictor

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    os.environ.pop(FINE_PATCH_ENV, None)  # phase 10 sets it where it runs
    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"device {torch.cuda.get_device_name(0)}; count "
        f"{torch.cuda.device_count()}")
    log(f"TF32 outside the predictor left at PyTorch's defaults (cudnn "
        f"{torch.backends.cudnn.allow_tf32}, matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}); the predictor's forward "
        f"turns it off (float32 convs and matmuls)")

    # 2. build
    secs = kernels.build()
    log(f"kernels built in {secs:.1f} s into {kernels.build_dir()}")
    for name in kernels.SOURCES:
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    log("kernel vs plain (float32, serving and train-step shapes):")
    results = kernel_phase(dev, g)
    for e in results:
        for r in e["per_shape"] + e["other_shapes"]:
            log(f"  {e['name']} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), library {r['library_ms']}")
    torch.cuda.empty_cache()

    # 4-5. serving through the fine decoder, then card against CPU
    rng = np.random.RandomState(0)
    requests = [rng.rand(B, N, HW, HW, 4).astype(np.float32),
                rng.rand(3, N, HW, HW, 4).astype(np.float32),
                rng.rand(N, HW, HW, 4).astype(np.float32)]
    t0 = time.perf_counter()
    pred = load_predictor(FLAGSHIP_CHECKPOINT, batch_size=B, burst_size=N,
                          burst_hw=(HW, HW), device="cuda", fused_s2d=False)
    log(f"predictor loaded in {time.perf_counter() - t0:.1f} s")
    serving = serve("serving, fine decoder", pred, requests,
                    LAUNCHES_PER_FORWARD)
    launches = serving.pop("launches")
    serving["card_vs_cpu_max_abs"] = forward_vs_cpu(
        pred, requests[2][None], fused_s2d_decoder=False)
    del pred
    torch.cuda.empty_cache()

    # 6. the training path's kernels against their plain versions
    log(f"training kernels vs plain (float32, train-step shapes, B={TRAIN_B}, "
        f"N={TRAIN_N}):")
    new = backward_kernel_phase(dev, g)
    for e in new:
        for r in e["per_shape"] + e["other_shapes"]:
            log(f"  {e['name']} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), library {r['library_ms']}")
    results += new
    torch.cuda.empty_cache()

    # 7. training with the banked aligner, frozen
    grads = grad_phase()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        os.environ["DBSR_TPU_ENV"] = os.path.join(workdir, "env.json")
        os.environ["DBSR_TPU_WORKSPACE_DIR"] = os.path.join(workdir, "banked")
        os.environ.pop("DBSR_TPU_ZURICHRAW2RGB_DIR", None)
        per_step, run_losses = training_entry_phase()
        torch.cuda.empty_cache()
        trainer, state = default_synthetic_trainer(dev,
                                                   pwc_checkpoint=ALIGN_LITE)
        train = step_phase(dev, "default_synthetic", trainer, state,
                           LAUNCHES_PER_TRAIN_STEP)
        del trainer, state
        torch.cuda.empty_cache()

        # 8. pretraining the aligner; 9. default_synthetic from its checkpoint
        os.environ["DBSR_TPU_WORKSPACE_DIR"] = os.path.join(workdir, "own")
        pre_grads = pretrain_grad_phase(dev)
        torch.cuda.empty_cache()
        pre_per_step, pretrain = pretrain_entry_phase(dev)
        torch.cuda.empty_cache()
        trainer, state = pretrain_trainer(dev)
        pretrain["step"] = step_phase(dev, "align_lite pretraining", trainer,
                                      state, LAUNCHES_PER_PRETRAIN_STEP)
        del trainer, state
        torch.cuda.empty_cache()
        closing = closing_phase(dev)
        torch.cuda.empty_cache()

        # 10. the s2d decoder
        os.environ["DBSR_TPU_WORKSPACE_DIR"] = os.path.join(workdir, "s2d")
        s2d = s2d_phase(dev, requests)
    paths = {"train_step": per_step, "pretrain_step": pre_per_step,
             "train_alignment_step":
                 closing["train_alignment"]["launches_per_step"],
             "s2d_train_step": s2d.pop("launches_per_step")}
    serving_launches = {"serving_3_requests": launches,
                        "serving_s2d_3_requests": s2d.pop("launches")}
    for e in results:
        # launches on each driven path: the three serving requests through
        # each decoder, then per step of the four training paths; `launches`
        # is the count on the entry's own path
        by_path = {k: v[e["name"]]
                   for k, v in {**serving_launches, **paths}.items()}
        e["launches_by_path"] = by_path
        e["launches"] = by_path[e["path"]]
        if not e["launches"]:
            raise AssertionError(f"{e['name']} was not launched on its path "
                                 f"{e['path']}")

    summary = dict(serving_b8=serving, train=train,
                   train_card_vs_cpu=grads, run_training_losses=run_losses,
                   launches_per_train_step=per_step,
                   pretrain=pretrain, pretrain_card_vs_cpu=pre_grads,
                   launches_per_pretrain_step=pre_per_step,
                   closing_the_loop=closing, s2d_decoder=s2d, build_s=secs,
                   total_s=time.perf_counter() - t_start, card=smi)
    log("summary " + json.dumps(summary))
    log(smi)
    log(json.dumps({"kernels": results}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
