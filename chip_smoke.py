"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. environment: torch / CUDA versions, the card's name and power limit;
   the predictor's forward runs its convs and matmuls with TF32 off
   (float32), which the script checks by leaving PyTorch's defaults on;
2. build the three CUDA kernels from ``dbsr_tpu_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together);
3. each kernel against its plain PyTorch version on the card, float32, at
   the shapes the serving forward gives it, inputs from a fixed seed; times
   of the kernel, the plain version and (warp only) ``F.grid_sample`` as a
   library yardstick, by CUDA events, median of several runs after warm-up;
4. serving: ``load_predictor`` on the banked flagship checkpoint (full
   width, batch 8, 14 frames, 48x48 -> 384x384) answers three requests
   (8 bursts, 3 bursts, one burst) with the launch counters reset just
   before and read just after; each kernel must have launched exactly as
   often as its call sites in three forwards ask;
5. the card's forward (kernels) against the CPU forward (plain versions) on
   one burst with the same parameters.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
FP32_FLOPS_PER_S = 67e12    # H100 SXM float32 rate outside the tensor cores
B, N, HW = 8, 14, 48
# launches per forward: warp serves the 512-channel feature warp and
# AlignLite's two backwarps; correlation runs at AlignLite's three levels
LAUNCHES_PER_FORWARD = {"warp": 3, "correlation": 3, "merge": 1}
FRAMES = B * (N - 1)
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6   # vs plain on the card: sum order only
CARD_VS_CPU_TOL = 1e-3                  # [0, 1] output, whole network


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
    from dbsr_tpu_torch.ops.correlation import (NUM_OFFSETS,
                                                correlation_plain, cost_volume)
    from dbsr_tpu_torch.ops.merge import (fused_softmax_merge,
                                          fused_softmax_merge_plain)
    from dbsr_tpu_torch.ops.warp import warp_feat, warp_feat_plain

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def flow(frames, h, w):  # up to +-5 px: out-of-range taps at the borders
        f = (torch.rand(frames, h, w, 2, generator=g, device=dev) * 10 - 5)
        f[:, ::7] = torch.round(f[:, ::7])  # and taps on exact pixel centres
        return f.contiguous()

    results = []

    # warp: the 512-channel feature warp, then AlignLite's two backwarps
    shapes = [(FRAMES, HW, HW, 512), (FRAMES, HW // 2, HW // 2, 48),
              (FRAMES, HW, HW, 24)]
    entry = dict(name="warp", route="cuda",
                 source="dbsr_tpu_torch/kernels/csrc/warp.cu",
                 replaces="dbsr_tpu/ops/warp_pallas.py:118",
                 tpu_counterpart="warp_pallas.py:_warp_pallas_impl",
                 shape=[list(s) for s in shapes], ms=0.0, plain_ms=0.0,
                 bound_ms=0.0, library_ms=None, max_abs_err=0.0, per_shape=[])
    for s in shapes:
        feat, fl = randn(*s), flow(*s[:3])
        got = warp_feat(feat, fl)
        err = check_close(f"warp {list(s)}", got, warp_feat_plain(feat, fl))
        ms = cuda_ms(lambda: warp_feat(feat, fl))
        plain = cuda_ms(lambda: warp_feat_plain(feat, fl), 1, 3)
        nb = (2 * feat.numel() + fl.numel()) * 4
        bms, by = bound(nb, 7 * feat.numel())
        row = dict(shape=list(s), ms=ms, plain_ms=plain, bound_ms=bms,
                   bound_by=by, max_abs_err=err, library_ms=None)
        # yardstick: grid_sample with the grid equal to p + flow
        H, W = s[1], s[2]
        xs = torch.arange(W, device=dev, dtype=torch.float32)
        ys = torch.arange(H, device=dev, dtype=torch.float32)
        gx = (2 * (xs[None, None, :] + fl[..., 0]) + 1) / W - 1
        gy = (2 * (ys[None, :, None] + fl[..., 1]) + 1) / H - 1
        grid = torch.stack([gx, gy], -1)
        nchw = feat.permute(0, 3, 1, 2)
        lib = F.grid_sample(nchw, grid, align_corners=False,
                            padding_mode="zeros").permute(0, 2, 3, 1)
        log(f"  warp {list(s)} grid_sample vs plain (info only): "
            f"{(lib - warp_feat_plain(feat, fl)).abs().max().item():.3e}")
        row["library_ms"] = cuda_ms(lambda: F.grid_sample(
            nchw, grid, align_corners=False, padding_mode="zeros"))
        entry["per_shape"].append(row)
        del feat, fl, got
    results.append(entry)

    # correlation at AlignLite's three levels
    shapes = [(FRAMES, HW // 4, HW // 4, 96), (FRAMES, HW // 2, HW // 2, 48),
              (FRAMES, HW, HW, 24)]
    entry = dict(name="correlation", route="cuda",
                 source="dbsr_tpu_torch/kernels/csrc/correlation.cu",
                 replaces="dbsr_tpu/ops/correlation.py:85",
                 tpu_counterpart="correlation.py:_correlation_pallas_fwd_impl",
                 shape=[list(s) for s in shapes], ms=0.0, plain_ms=0.0,
                 bound_ms=0.0, library_ms=None, max_abs_err=0.0, per_shape=[])
    for s in shapes:
        a, b = randn(*s), randn(*s)
        err = check_close(f"correlation {list(s)}", cost_volume(a, b),
                          correlation_plain(a, b))
        ms = cuda_ms(lambda: cost_volume(a, b))
        plain = cuda_ms(lambda: correlation_plain(a, b), 1, 3)
        npix = s[0] * s[1] * s[2]
        bms, by = bound((2 * a.numel() + npix * NUM_OFFSETS) * 4,
                        2 * NUM_OFFSETS * a.numel())
        entry["per_shape"].append(dict(shape=list(s), ms=ms, plain_ms=plain,
                                       bound_ms=bms, bound_by=by,
                                       max_abs_err=err, library_ms=None))
    results.append(entry)

    # merge
    s = (B, N, HW, HW, 512)
    feat, logits = randn(*s), randn(*s, scale=3.0)
    entry = dict(name="merge", route="cuda",
                 source="dbsr_tpu_torch/kernels/csrc/merge.cu",
                 replaces="dbsr_tpu/ops/merge_pallas.py:78",
                 tpu_counterpart="merge_pallas.py:_merge_fwd_impl",
                 shape=[list(s)], ms=0.0, plain_ms=0.0, bound_ms=0.0,
                 library_ms=None, max_abs_err=0.0, per_shape=[])
    err = check_close(f"merge {list(s)}", fused_softmax_merge(feat, logits),
                      fused_softmax_merge_plain(feat, logits))
    ms = cuda_ms(lambda: fused_softmax_merge(feat, logits))
    plain = cuda_ms(lambda: fused_softmax_merge_plain(feat, logits), 1, 3)
    bms, by = bound((2 * feat.numel() + feat.numel() // N) * 4,
                    6 * feat.numel())
    entry["per_shape"].append(dict(shape=list(s), ms=ms, plain_ms=plain,
                                   bound_ms=bms, bound_by=by, max_abs_err=err,
                                   library_ms=None))
    results.append(entry)
    del feat, logits

    # one forward's worth of each kernel: the sum over its main-path shapes
    for e in results:
        rows = e["per_shape"]
        for k in ("ms", "plain_ms", "bound_ms"):
            e[k] = sum(r[k] for r in rows)
        if all(r["library_ms"] is not None for r in rows):
            e["library_ms"] = sum(r["library_ms"] for r in rows)
        e["max_abs_err"] = max(r["max_abs_err"] for r in rows)
        e["max_err_vs_plain"] = e["max_abs_err"]
        e["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                         else "operations")
    return results


def main():
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; nothing to measure")
        return 2
    from dbsr_tpu_torch import kernels
    from dbsr_tpu_torch.ops.correlation import cost_volume
    from dbsr_tpu_torch.ops.merge import fused_softmax_merge
    from dbsr_tpu_torch.ops.warp import warp_feat
    from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT, load_predictor

    t_start = time.perf_counter()
    dev = torch.device("cuda")
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
    log("kernel vs plain (float32, main-path shapes):")
    results = kernel_phase(dev, g)
    for e in results:
        for r in e["per_shape"]:
            log(f"  {e['name']} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), library {r['library_ms']}")
    torch.cuda.empty_cache()

    # 4. serving: three requests through the main path
    t0 = time.perf_counter()
    pred = load_predictor(FLAGSHIP_CHECKPOINT, batch_size=B, burst_size=N,
                          burst_hw=(HW, HW), device="cuda")
    log(f"predictor loaded in {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(0)
    requests = [rng.rand(B, N, HW, HW, 4).astype(np.float32),
                rng.rand(3, N, HW, HW, 4).astype(np.float32),
                rng.rand(N, HW, HW, 4).astype(np.float32)]
    wrappers = {"warp": warp_feat, "correlation": cost_volume,
                "merge": fused_softmax_merge}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    outs = [pred(r) for r in requests]
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"launches over the three requests (3 forwards): {launches}")
    for r, o in zip(requests, outs):
        n = r.shape[0] if r.ndim == 5 else 1
        if o.shape != (n, HW * 8, HW * 8, 3):
            raise AssertionError(f"output shape {o.shape} for {n} bursts")
        if not np.isfinite(o).all() or o.min() < 0 or o.max() > 1:
            raise AssertionError("output not finite or outside [0, 1]")
    for k, per_forward in LAUNCHES_PER_FORWARD.items():
        if launches[k] != per_forward * len(requests):
            raise AssertionError(f"{k}: {launches[k]} launches in "
                                 f"{len(requests)} forwards, expected "
                                 f"{per_forward} per forward")
    for e in results:
        e["launches"] = launches[e["name"]]

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        pred(requests[0])
    for _ in range(5):
        t0 = time.perf_counter()
        pred(requests[0])  # ends in a copy to the host: synchronous
        times.append(time.perf_counter() - t0)
    req_s = statistics.median(times)
    log(f"request at batch {B}: median {req_s * 1e3:.1f} ms over 5 "
        f"({B / req_s:.2f} bursts/s), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    x = torch.from_numpy(requests[0]).to(dev)
    fwd_ms = cuda_ms(lambda: pred.forward(x), 1, 5)
    log(f"forward at batch {B} on the card: {fwd_ms:.2f} ms (CUDA events)")

    # 5. the card's forward against the CPU's plain forward
    from dbsr_tpu_torch.training.checkpoint import load_network
    cpu_net, _ = load_network(FLAGSHIP_CHECKPOINT, device="cpu", dtype=None)
    burst = requests[2][None]
    on_card = pred.forward(torch.from_numpy(burst).to(dev)).clamp(0, 1).cpu()
    with torch.inference_mode():
        t0 = time.perf_counter()
        on_cpu = cpu_net(torch.from_numpy(burst))[0].clamp(0, 1)
    cpu_s = time.perf_counter() - t0
    diff = (on_card - on_cpu).abs().max().item()
    log(f"card (kernels) vs CPU (plain) forward, 1 burst: max|diff| "
        f"{diff:.3e} (limit {CARD_VS_CPU_TOL}); CPU forward {cpu_s:.1f} s")
    if not diff <= CARD_VS_CPU_TOL:
        raise AssertionError(f"card vs CPU: {diff} > {CARD_VS_CPU_TOL}")

    summary = dict(bursts_per_s_b8=B / req_s, request_ms_b8=req_s * 1e3,
                   forward_ms_b8=fwd_ms, card_vs_cpu_max_abs=diff,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   build_s=secs, total_s=time.perf_counter() - t_start,
                   card=smi)
    log("summary " + json.dumps(summary))
    log(smi)
    log(json.dumps({"kernels": results}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
