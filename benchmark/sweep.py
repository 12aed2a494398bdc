"""The knee of an HTTP cell, found once by a sweep on the card: the cell's
open loop at each of several offered rates against one server, in one
process. The benchmark's own runs do not run this.

    python3 -m benchmark.sweep --workload <an http cell> --seed <n> \
        --seconds <s> --rates <r> [<r> ...]

Prints one JSON line a rate: offered and completed bursts a second, the
latency's p50 and p95 from the due times, the median latency of the last
quarter of the requests over that of the first (a backlog that grows
through the window reads well above 1), the daemon's mean occupancy. The
knee is the highest rate whose completions keep pace and whose backlog
does not grow; the cell runs at four fifths of it.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import sys
import time

import numpy as np
import torch

from benchmark import harness, inputs
from benchmark.loads import http


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = harness.find_cell(args.workload)
    cfg, tr = cell.config, cell.traffic
    tmp = harness.scratch_dir("sweep")
    harness.env_for_program(tmp)
    print(harness.card_line(), file=sys.stderr)
    dev = torch.device("cuda")
    D = tr["distinct_bursts"]
    bursts = inputs.serving_bursts(args.seed, D, cfg["serve_burst_size"], dev)
    bodies = tmp / "bodies.npy"
    np.save(bodies, np.round(bursts.cpu().numpy() * inputs.RAW_SCALE)
            .astype(np.uint16))
    del bursts
    harness.free_device()
    from dbsr_tpu_torch import kernels

    kernels.build()
    server, thread = http.start_server(cfg, tr, "cuda")
    rng = np.random.default_rng([args.seed, 3])
    try:
        for i, rate in enumerate(args.rates):
            arrivals = http.plan_arrivals(rate, args.seconds, rng)
            ids = [int(j % D) for j in range(len(arrivals))]
            plan = {"host": "127.0.0.1", "port": server.server_address[1],
                    "bodies": str(bodies), "ids": ids, "arrivals": arrivals,
                    "sample": [], "warmup": tr["warmup_requests"],
                    "out": str(tmp / f"client{i}")}
            client = http.Client(plan, tmp)
            try:
                http.sleep_until(client.start_wall)
                server.batcher.batch_occupancies.clear()
                record = client.finish()
            finally:
                client.close()
            done = [v for v in record["latency_s"] if v is not None]
            n = len(arrivals)
            last_end = max(a + v for a, v in zip(arrivals,
                                                  record["latency_s"])
                           if v is not None)
            q = max(1, n // 4)
            first = [v for v in record["latency_s"][:q] if v is not None]
            last = [v for v in record["latency_s"][-q:] if v is not None]
            occ = list(server.batcher.batch_occupancies)
            print(json.dumps({
                "rate_offered": n / arrivals[-1],
                "completed_per_s": len(done) / last_end,
                "failed": record["failed"],
                "p50_ms": 1e3 * statistics.median(done),
                "p95_ms": http.p95([1e3 * v for v in done]),
                "backlog_growth": statistics.median(last)
                / statistics.median(first),
                "occupancy": float(np.mean(occ)) if occ else None,
                "late_ms_max": record["late_ms_max"]}), flush=True)
            time.sleep(1.0)
    finally:
        http.stop_server(server, thread)
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
