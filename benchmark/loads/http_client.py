"""The open-loop client of the HTTP cell, a process of its own (clients in
the server's process share its interpreter lock and skew the load).

    python3 -m benchmark.loads.http_client <plan.json>

The plan gives the server's address, the request bodies (one ``.npy`` file
of the distinct bursts, uint16 at 2^14), each request's due time after the
start and its burst, the requests whose answers are kept, and how many
warm-up requests to send first. After the warm-up the client prints
``ready <wall time of the start>`` on standard output and sends each
request when it is due, on a thread of its own, whether or not earlier
ones have finished. A request's latency runs from its due time to the end
of its answer, so a stall also delays the requests behind it; a request
that fails or never ends counts as failed. It waits for the last answers
up to ``GRACE_S`` past the last due time, writes its record as JSON
(``<out>/client.json``, the kept answers beside it) and prints requests
sent, completed and failed and how late the generator ran on standard
error.
"""

from __future__ import annotations

import http.client
import io
import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np

THREADS = 256   # senders: enough that a due request never waits for one
GRACE_S = 60.0  # how long past the last due time the last answers may take


def _npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def post(host: str, port: int, body: bytes, timeout: float):
    """``(status, answer bytes)`` of one ``POST /predict``; ``(None, error
    text)`` when the request fails."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", "/predict", body=body,
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    except (OSError, http.client.HTTPException) as e:
        return None, f"{type(e).__name__}: {e}".encode()
    finally:
        conn.close()


def run_plan(plan: dict) -> dict:
    host, port = plan["host"], plan["port"]
    timeout = GRACE_S + 30.0
    bodies = np.load(plan["bodies"])
    encoded = [_npy(b) for b in bodies]
    ids, arrivals = plan["ids"], plan["arrivals"]
    keep = set(plan["sample"])
    out_dir = plan["out"]
    os.makedirs(out_dir, exist_ok=True)

    with ThreadPoolExecutor(max_workers=16) as pool:
        warm = list(pool.map(
            lambda i: post(host, port, encoded[i], timeout)[0],
            [ids[j % len(ids)] for j in range(plan["warmup"])]))
    if any(s != 200 for s in warm):
        print(f"client: warm-up answers {warm}", file=sys.stderr)

    n = len(arrivals)
    latency = [None] * n
    status = [None] * n
    late = [0.0] * n
    lock = threading.Lock()

    def task(j: int, due: float):
        st, data = post(host, port, encoded[ids[j]], timeout)
        end = time.monotonic()
        with lock:
            status[j] = st
            if st == 200:
                latency[j] = end - due
        if st == 200 and j in keep:
            with open(os.path.join(out_dir, f"answer_{j}.npy"), "wb") as f:
                f.write(data)

    start_mono = time.monotonic() + 0.05
    start_wall = time.time() + (start_mono - time.monotonic())
    print(f"ready {start_wall!r}", flush=True)
    futures = []
    with ThreadPoolExecutor(max_workers=THREADS) as pool:
        for j, a in enumerate(arrivals):
            due = start_mono + a
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            late[j] = time.monotonic() - due
            futures.append(pool.submit(task, j, due))
        deadline = start_mono + (arrivals[-1] if arrivals else 0.0) \
            + GRACE_S
        wait(futures, timeout=max(0.0, deadline - time.monotonic()))
        for f in futures:
            f.cancel()
        with lock:
            lat = list(latency)
            sts = list(status)
    for f in futures:  # a task's failure is its own status; read them all
        if f.done() and not f.cancelled() and f.exception() is not None:
            print(f"client: {f.exception()!r}", file=sys.stderr)
    failed = sum(1 for v in lat if v is None)
    late_ms = sorted(1e3 * v for v in late)
    record = {"start_wall": start_wall, "sent": n,
              "completed": n - failed, "failed": failed,
              "latency_s": lat, "status": sts,
              "late_ms_p50": late_ms[len(late_ms) // 2] if n else 0.0,
              "late_ms_p99": late_ms[min(n - 1, int(0.99 * n))] if n else 0.0,
              "late_ms_max": late_ms[-1] if n else 0.0}
    print(f"client: sent {n}, completed {n - failed}, failed {failed}; "
          f"generator late p50 {record['late_ms_p50']:.3f} ms, p99 "
          f"{record['late_ms_p99']:.3f} ms, max "
          f"{record['late_ms_max']:.3f} ms", file=sys.stderr, flush=True)
    return record


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        plan = json.load(f)
    record = run_plan(plan)
    path = os.path.join(plan["out"], "client.json")
    with open(path + ".tmp", "w") as f:
        json.dump(record, f)
    os.replace(path + ".tmp", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
