"""An open loop of single-burst ``POST /predict`` requests against the
serving daemon as ``run_serving`` builds it: ``serving_daemon.make_server``
over ``load_predictor(<the configuration's serving checkpoint>,
batch_size)``, ``linger_ms``, on loopback at a port the system picks.

The client is a process of its own (``loads/http_client.py``). Each
request's body is one burst as uint16 ``.npy`` at 2^14, as a phone client
sends RAW. Arrivals are Poisson at ``rate_per_s`` for ``--seconds``: every
seed sends the same number of requests with the same set of gaps between
them (the exponential distribution's quantiles), in another order, and
cycles through ``distinct_bursts`` bursts in another order. After
``warmup_requests`` requests at once, set-up runs the open loop for
``warmup_s`` (the daemon reaches its steady state: its threads, the
allocator's thresholds); the window is the schedule's next ``--seconds``;
``http_p95_ms`` is the 95th percentile of every request's
latency from its due time (a failed request counts as missing the limit).
The server's counters are read over the window: ``MicroBatcher``'s
occupancies and ``ServingStats``' p95. With ``--trace 1`` the same load
goes on after the window, and the server's process is traced for
``trace_s`` of it (the profiler slows the host, so nothing of the window is
read under it).
A sample of ``sample_requests`` requests, drawn from the seed, keeps its
answers, which are compared with the reference's prediction for each
request's burst once the window has closed.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time
from typing import List

import numpy as np
import torch

from benchmark import harness, inputs, oracle
from benchmark.yardstick import recording_bounds

TRACE_MARGIN_S = 15.0  # load beyond the traced slice
FAILED_MS = 1e9  # the latency a failed request counts with


def plan_arrivals(rate: float, seconds: float,
                  rng: np.random.Generator) -> List[float]:
    """Due times of ``round(rate * seconds)`` requests after the start: the
    gap before each is one of the exponential distribution's quantiles at
    ``(i + 0.5) / n``, in an order drawn from ``rng``."""
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    return np.cumsum(gaps[rng.permutation(n)]).tolist()


def p95(values_ms: List[float]) -> float:
    """The nearest-rank 95th percentile."""
    s = sorted(values_ms)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def start_server(cfg: dict, tr: dict, device: str):
    from dbsr_tpu_torch.serving import load_predictor
    from dbsr_tpu_torch.serving_daemon import make_server

    pred = load_predictor(harness.repo_path(cfg["serve_checkpoint"]),
                          batch_size=tr["batch_size"], device=device,
                          dtype=cfg["compute_dtype"],
                          fused_s2d=cfg["fused_s2d_decoder"])
    server = make_server(pred, "127.0.0.1", 0, linger_ms=tr["linger_ms"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def stop_server(server, thread) -> None:
    server.shutdown()
    thread.join()
    server.batcher.close()
    server.server_close()


class Client:
    """The client process on ``plan``: started, its warm-up awaited
    (``start_wall``, the wall time of its first request's due time), then
    waited for and its record read (:meth:`finish`)."""

    def __init__(self, plan: dict, tmp):
        path = tmp / "plan.json"
        with open(path, "w") as f:
            json.dump(plan, f)
        self.out = plan["out"]
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "benchmark.loads.http_client", str(path)],
            stdout=subprocess.PIPE, text=True, cwd=str(harness.ROOT))
        line = self.proc.stdout.readline().split()
        if len(line) != 2 or line[0] != "ready":
            self.close()
            raise RuntimeError(f"the HTTP client did not start: {line}")
        self.start_wall = float(line[1])

    def finish(self) -> dict:
        self.proc.stdout.read()
        rc = self.proc.wait()
        if rc:
            raise RuntimeError(f"the HTTP client exited with {rc}")
        with open(f"{self.out}/client.json") as f:
            return json.load(f)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def _server_counters(server) -> dict:
    """The daemon's counters since they were cleared: the mean bursts a
    device call and ``ServingStats``' p95."""
    occ = list(server.batcher.batch_occupancies)
    summary = server.stats.summary(occ)
    return {"http.occupancy": float(np.mean(occ)) if occ else None,
            "http.server_p95_ms": summary.get("latency_p95_ms")}


def sleep_until(wall: float) -> None:
    while True:
        left = wall - time.time()
        if left <= 0:
            return
        time.sleep(min(left, 0.01))


def run(ctx: harness.Context) -> harness.Run:
    from dbsr_tpu_torch import kernels

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    D = tr["distinct_bursts"]
    dev = torch.device(ctx.device)
    on_card = dev.type == "cuda"
    out = harness.Run(cell=ctx.cell)

    bursts_dev = inputs.serving_bursts(ctx.seed, D, cfg["serve_burst_size"],
                                       dev)
    bursts = bursts_dev.cpu()
    del bursts_dev
    harness.free_device()
    bodies = ctx.tmp / "bodies.npy"
    np.save(bodies, np.round(bursts.numpy() * inputs.RAW_SCALE)
            .astype(np.uint16))
    rng = np.random.default_rng([ctx.seed, 3])
    # the open loop first runs for warmup_s at the cell's rate (set-up),
    # then the window's n requests
    warm = plan_arrivals(tr["rate_per_s"], tr["warmup_s"], rng)
    w0 = len(warm)
    window = plan_arrivals(tr["rate_per_s"], ctx.seconds, rng)
    n = len(window)
    arrivals = warm + [warm[-1] + a for a in window]
    if ctx.trace:
        # the same load goes on after the window: while the profiler starts
        # (seconds, the first time in a process), then through the traced
        # slice, then a margin
        more = plan_arrivals(tr["rate_per_s"],
                             tr["trace_s"] + TRACE_MARGIN_S, rng)
        arrivals += [arrivals[-1] + a for a in more]
    order = rng.permutation(D)
    ids = [int(order[j % D]) for j in range(len(arrivals))]
    sample = sorted(w0 + int(j) for j in rng.choice(
        n, size=min(tr["sample_requests"], n), replace=False))

    if on_card:
        torch.cuda.reset_peak_memory_stats()
        kernels.build()
    server, thread = start_server(cfg, tr, ctx.device)
    plan = {"host": "127.0.0.1", "port": server.server_address[1],
            "bodies": str(bodies), "ids": ids, "arrivals": arrivals,
            "sample": sample, "warmup": tr["warmup_requests"],
            "out": str(ctx.tmp / "client")}
    try:
        client = Client(plan, ctx.tmp)
        try:
            start = client.start_wall + warm[-1]
            sleep_until(start)
            server.stats.latencies.clear()
            server.batcher.batch_occupancies.clear()
            out.metrics["setup_s"] = start - ctx.wall_start
            if ctx.trace:
                # the window's counters as it closes, then the traced slice
                sleep_until(client.start_wall + arrivals[w0 + n - 1])
                counters = _server_counters(server)
                with harness.Trace() as trace, \
                        recording_bounds(trace.launches):
                    time.sleep(tr["trace_s"])
                out.trace = trace
            record = client.finish()
            if not ctx.trace:
                counters = _server_counters(server)
        finally:
            client.close()
    finally:
        stop_server(server, thread)
    out.device = harness.device_info(1, ctx.device)
    del server, thread
    harness.free_device()

    timed = record["latency_s"][w0:w0 + n]
    failed = sum(v is None for v in timed)
    lat_ms = [FAILED_MS if v is None else 1e3 * v for v in timed]
    out.metrics["http_p95_ms"] = p95(lat_ms)
    out.attempted, out.failed = n, failed
    out.counters.update(counters)
    out.counters["http.late_ms_max"] = record["late_ms_max"]
    if record["failed"]:
        out.errors.append(f"{record['failed']} of {record['sent']} requests "
                          "got no answer")

    kept = {}
    for j in sample:
        try:
            kept[j] = np.load(f"{plan['out']}/answer_{j}.npy")
        except (OSError, ValueError):
            out.errors.append(f"request {j}'s answer was not kept")
    distinct = sorted({ids[j] for j in kept})
    if distinct:
        ckpt = harness.repo_path(cfg["serve_checkpoint"])
        ref = oracle.serve_reference(ckpt, bursts[distinct], dev)
        row = {b: k for k, b in enumerate(distinct)}
        worst = max(oracle.rel_l2(a, ref[row[ids[j]]].numpy())
                    for j, a in kept.items())
    else:
        worst = float("inf")
    out.checks["worst_rel_l2"] = (worst, ctx.cell.limits["worst_rel_l2"])
    return out
