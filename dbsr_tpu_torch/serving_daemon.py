"""Burst-SR serving daemon: dynamic micro-batching over the fixed-shape
predictor, fronted by an HTTP API on the standard library (port of
``dbsr_tpu/serving_daemon.py``; numpy, the standard library and the
port's span helper).

The predictor (``dbsr_tpu_torch.serving``) runs one shape, ``batch_size``
bursts. Traffic arrives one burst at a time, so a naive server would run
every request at occupancy 1. The :class:`MicroBatcher` groups concurrent
requests into one device call and dispatches a partial group after
``linger_ms``, so a lone request never waits on traffic that is not
coming. Its one thread makes every device call: one forward at a time,
which the predictor's process-wide float32 flags need.

HTTP API:

  - ``POST /predict``: body = ``.npy`` bytes of ONE burst
    ``[N, h, w, 4]`` (float in [0, 1] or uint16 at 2^14 scale);
    response = ``.npy`` bytes of ``[H, W, 3]`` linear RGB float32. A
    malformed body or a wrong shape gets 400, a failed prediction 503
    (every request of that device call), an unknown route 404.
  - ``GET /healthz``: JSON: the predictor's shape, ``compile_seconds``
    (its warm-up forward) and ``flops_per_batch``.
  - ``GET /stats``: JSON: request and error counts, latency mean / p50 /
    p95 and mean batch occupancy over bounded windows, and the p50 / p95
    of the operators' counters over the same windows: a request's queue
    wait (``queue_wait``, from ``submit`` to its batch being taken), a
    device call's wall time (``device_call``), the handler's ``.npy``
    decode and encode (``decode``, ``encode``), each as ``<name>_p50_ms``
    and ``<name>_p95_ms``.

The handler's ``.npy`` codec and the batcher's linger and device call open
``annotate`` spans (``http.decode``, ``http.encode``, ``batcher.linger``,
``batcher.call``), which a ``maybe_trace`` trace shows on their threads.

Run via ``python -m dbsr_tpu_torch.run_serving --checkpoint <ckpt> --port
8000``; ``make_server`` warms the predictor up if nothing did yet.
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from dbsr_tpu_torch.utils.profiling import annotate

_Q = 2 ** 14
MAX_BODY_BYTES = 64 * 1024 * 1024


class _Item:
    __slots__ = ("burst", "event", "result", "error", "t_submit")

    def __init__(self, burst):
        self.burst = burst
        self.t_submit = time.perf_counter()
        self.event = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None


class MicroBatcher:
    """Group concurrent single-burst requests into fixed-shape predictor
    calls (see module doc). Thread-safe; ``submit`` blocks the calling
    thread until its burst's prediction is ready."""

    def __init__(self, predictor, linger_ms: float = 5.0):
        self.predictor = predictor
        self.linger = linger_ms / 1000.0
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: List[_Item] = []
        self._closed = False
        from collections import deque
        self.batch_occupancies = deque(maxlen=10000)  # bounded, see stats
        # seconds: each request's wait from submit to its batch being
        # taken, and each device call's wall time
        self.queue_waits = deque(maxlen=10000)
        self.call_seconds = deque(maxlen=10000)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="microbatcher")
        self._thread.start()

    def submit(self, burst: np.ndarray) -> np.ndarray:
        burst = np.asarray(burst, np.float32)
        want = self.predictor.in_shape[1:]
        if burst.shape != want:
            raise ValueError(f"expected one burst of shape {want}, "
                             f"got {burst.shape}")
        item = _Item(burst)
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher closed")
            self._pending.append(item)
            self._cond.notify()
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.result

    def _loop(self):
        bs = self.predictor.batch_size
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if self._closed and not self._pending:
                    return
                # linger for stragglers unless the batch is already full
                with annotate("batcher.linger"):
                    deadline = time.monotonic() + self.linger
                    while len(self._pending) < bs and not self._closed:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cond.wait(timeout=remaining)
                batch, self._pending = (self._pending[:bs],
                                        self._pending[bs:])
            t0 = time.perf_counter()
            self.queue_waits.extend(t0 - it.t_submit for it in batch)
            try:
                with annotate("batcher.call"):
                    stacked = np.stack([it.burst for it in batch])
                    preds = self.predictor(stacked)
                for it, pred in zip(batch, preds):
                    it.result = pred
            except Exception as e:
                for it in batch:
                    it.error = e
            finally:
                self.call_seconds.append(time.perf_counter() - t0)
                self.batch_occupancies.append(len(batch))
                for it in batch:
                    it.event.set()

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join()


class ServingStats:
    """Bounded: percentiles/means are over the most recent
    ``window`` samples (a long-lived daemon must not grow per-request
    state without bound); ``requests``/``errors`` are lifetime
    counters. ``decodes`` and ``encodes`` hold the handler's ``.npy``
    codec seconds a request."""

    def __init__(self, window: int = 10000):
        from collections import deque
        self._lock = threading.Lock()
        self.latencies = deque(maxlen=window)
        self.decodes = deque(maxlen=window)
        self.encodes = deque(maxlen=window)
        self.requests = 0
        self.errors = 0

    def record(self, seconds: float):
        with self._lock:
            self.requests += 1
            self.latencies.append(seconds)

    def record_error(self):
        with self._lock:
            self.errors += 1

    def record_codec(self, decode_s: Optional[float] = None,
                     encode_s: Optional[float] = None):
        with self._lock:
            if decode_s is not None:
                self.decodes.append(decode_s)
            if encode_s is not None:
                self.encodes.append(encode_s)

    def summary(self, occupancies, queue_waits=(), call_seconds=()) -> dict:
        """The counts, the latency's mean / p50 / p95, the mean occupancy of
        ``occupancies``, and the p50 / p95 of the batcher's
        ``queue_waits`` and ``call_seconds`` and of the codec's times."""
        with self._lock:
            lat = sorted(self.latencies)
            out = {"requests": self.requests, "errors": self.errors}
            if lat:
                out["latency_mean_ms"] = 1e3 * float(np.mean(lat))
                out.update(_p50_p95_ms("latency", lat))
            occ = list(occupancies)
            if occ:
                out["mean_batch_occupancy"] = float(np.mean(occ))
            for name, seconds in (("queue_wait", queue_waits),
                                  ("device_call", call_seconds),
                                  ("decode", self.decodes),
                                  ("encode", self.encodes)):
                out.update(_p50_p95_ms(name, sorted(seconds)))
            return out


def _p50_p95_ms(name: str, ordered) -> dict:
    """``<name>_p50_ms`` and ``<name>_p95_ms`` of seconds in order; nothing
    where there are none."""
    if not ordered:
        return {}
    n = len(ordered)
    return {f"{name}_p50_ms": 1e3 * ordered[n // 2],
            f"{name}_p95_ms": 1e3 * ordered[min(n - 1, int(0.95 * n))]}


def _decode_burst(body: bytes) -> np.ndarray:
    arr = np.load(io.BytesIO(body), allow_pickle=False)
    if arr.dtype == np.uint16:
        arr = arr.astype(np.float32) / _Q
    return np.asarray(arr, np.float32)


def _encode_array(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def make_server(predictor, host: str = "127.0.0.1", port: int = 8000,
                linger_ms: float = 5.0):
    """Build (and return, unstarted) the HTTP server + its batcher, the
    predictor warmed up first where it has not been.
    ``server.serve_forever()`` to run; ``server.batcher.close()`` on
    shutdown."""
    if predictor.compile_seconds is None:
        predictor.warm_up()
    batcher = MicroBatcher(predictor, linger_ms=linger_ms)
    stats = ServingStats()

    class Handler(BaseHTTPRequestHandler):
        # quiet per-request stderr logging (stats endpoint replaces it)
        def log_message(self, fmt, *args):
            pass

        def _reply(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code: int, obj: dict):
            self._reply(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                p = predictor
                self._reply_json(200, {
                    "status": "ok",
                    "input_shape": list(p.in_shape),
                    "compile_seconds": p.compile_seconds,
                    "flops_per_batch": p.flops_per_batch,
                })
            elif self.path == "/stats":
                self._reply_json(200, stats.summary(
                    batcher.batch_occupancies, batcher.queue_waits,
                    batcher.call_seconds))
            else:
                self._reply_json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._reply_json(404, {"error": f"no route {self.path}"})
                return
            t0 = time.perf_counter()
            # client errors (malformed body, wrong shape) -> 400;
            # server-side prediction failures (e.g. device lost, which
            # fails every co-batched request) -> 503 so clients/load
            # balancers retry and monitoring doesn't blame the sender
            try:
                n = int(self.headers.get("Content-Length", 0))
                if not 0 < n <= MAX_BODY_BYTES:
                    raise ValueError(f"bad Content-Length {n}")
                body = self.rfile.read(n)
                t_decode = time.perf_counter()
                with annotate("http.decode"):
                    burst = _decode_burst(body)
                stats.record_codec(decode_s=time.perf_counter() - t_decode)
                want = predictor.in_shape[1:]
                if burst.shape != want:
                    raise ValueError(
                        f"expected one burst of shape {want}, "
                        f"got {burst.shape}")
            except Exception as e:
                stats.record_error()
                self._reply_json(400, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                pred = batcher.submit(burst)
            except Exception as e:
                stats.record_error()
                self._reply_json(503, {"error": f"{type(e).__name__}: {e}"})
                return
            stats.record(time.perf_counter() - t0)
            t_encode = time.perf_counter()
            with annotate("http.encode"):
                body = _encode_array(pred)
            stats.record_codec(encode_s=time.perf_counter() - t_encode)
            self._reply(200, body, "application/octet-stream")

    server = ThreadingHTTPServer((host, port), Handler)
    server.batcher = batcher
    server.stats = stats
    return server
