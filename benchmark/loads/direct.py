"""A closed loop of one library caller: ``Predictor.__call__`` on batches of
``batch_size`` float32 bursts, back to back, cycling through the traffic's
``distinct_bursts`` bursts (a photo collection run through the predictor).

Set-up: the kernels built, the configuration's serving checkpoint loaded
by ``load_predictor`` (its compute dtype and decoder), the bursts made,
two calls to warm up the one shape. The window counts every burst
returned until ``--seconds`` have passed. A sample of ``sample_calls``
calls, drawn from the seed, keeps its answers; once the window has closed
and the program is freed, each is compared with the reference's
prediction for its burst. With ``--trace 1``, ``trace_calls`` further calls
after the window are traced.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness, inputs, oracle
from benchmark.yardstick import recording_bounds


def _call_ids(order: np.ndarray, call: int, batch: int) -> np.ndarray:
    return order[(call * batch + np.arange(batch)) % len(order)]


def run(ctx: harness.Context) -> harness.Run:
    from dbsr_tpu_torch import kernels
    from dbsr_tpu_torch.serving import load_predictor

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    B, D = tr["batch_size"], tr["distinct_bursts"]
    dev = torch.device(ctx.device)
    on_card = dev.type == "cuda"
    out = harness.Run(cell=ctx.cell)

    bursts_dev = inputs.serving_bursts(ctx.seed, D, cfg["serve_burst_size"],
                                       dev)
    bursts = bursts_dev.cpu().numpy()
    del bursts_dev
    harness.free_device()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        kernels.build()
    ckpt = harness.repo_path(cfg["serve_checkpoint"])
    pred = load_predictor(ckpt, batch_size=B, device=ctx.device,
                          dtype=cfg["compute_dtype"],
                          fused_s2d=cfg["fused_s2d_decoder"])
    rng = np.random.default_rng([ctx.seed, 1])
    order = rng.permutation(D)
    for call in range(2):
        pred(bursts[_call_ids(order, call, B)])
    harness.sync(ctx.device)
    out.metrics["setup_s"] = ctx.setup_s()

    keep_n = tr["sample_calls"]
    kept = []  # reservoir of (ids, answers)
    calls = 0
    t0 = time.perf_counter()
    while True:
        ids = _call_ids(order, calls, B)
        answers = pred(bursts[ids])
        calls += 1
        if len(kept) < keep_n:
            kept.append((ids, answers))
        else:
            j = int(rng.integers(0, calls))
            if j < keep_n:
                kept[j] = (ids, answers)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    out.metrics["serve_bursts_per_s"] = calls * B / window_s
    out.attempted = calls * B
    out.counters.update({"serve.calls": calls, "serve.window_s": window_s,
                         "serve.batch": B})

    if ctx.trace:
        n = tr["trace_calls"]
        with harness.Trace() as trace, recording_bounds(trace.launches):
            for call in range(calls, calls + n):
                pred(bursts[_call_ids(order, call, B)])
        out.trace = trace
        out.counters["serve.traced_calls"] = n
    out.device = harness.device_info(1, ctx.device)
    del pred
    harness.free_device()

    ids = sorted({int(i) for ids_, _ in kept for i in ids_})
    ref = oracle.serve_reference(ckpt, torch.from_numpy(bursts[ids]), dev)
    row = {b: k for k, b in enumerate(ids)}
    worst = max(oracle.rel_l2(a, ref[row[int(b)]].numpy())
                for ids_, answers in kept for b, a in zip(ids_, answers))
    out.checks["worst_rel_l2"] = (worst, ctx.cell.limits["worst_rel_l2"])
    return out
