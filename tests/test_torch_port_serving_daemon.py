"""The port's serving daemon and ``run_serving`` on the CPU, against the JAX
package's.

JAX's five daemon tests (``tests/test_serving_daemon.py``) run on JAX's
``make_server`` / ``MicroBatcher`` and on the port's with the same fake
predictor, and one scripted session gives both the same occupancies,
responses, status codes, ``/stats`` counts and ``/healthz`` keys. Then a
real tiny checkpoint (``dbsrnet_tiny(flow_net="lite")``: the port refuses
the JAX test stub ``flow_net="conv"``) served over HTTP by the port's
``Predictor`` on the CPU against JAX's ``load_predictor``: float32 within
2e-4, bf16 within relative L2 2e-2 (``PERF.md`` section 2); the argument
parsing of ``run_serving``; ``flops_per_batch`` against torch's own count
of the convolutions the network runs.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from dbsr_tpu import serving_daemon as jax_daemon
from dbsr_tpu.serving import load_predictor as jax_load_predictor
from dbsr_tpu_torch import serving_daemon as port_daemon
from dbsr_tpu_torch.data.procedural import make_generator
from dbsr_tpu_torch.models.dbsr import dbsrnet_tiny
from dbsr_tpu_torch.models.layers import init_params
from dbsr_tpu_torch.run_serving import parse_args, predictor_kwargs
from dbsr_tpu_torch.serving import load_predictor
from dbsr_tpu_torch.training import checkpoint as ckpt
from dbsr_tpu_torch.training.state import make_optimizer

DAEMONS = pytest.mark.parametrize("daemon", [jax_daemon, port_daemon],
                                  ids=["jax", "port"])
TINY = dict(batch_size=2, burst_size=3, burst_hw=(16, 16))
F32_ABS, BF16_REL_L2 = 2e-4, 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this module runs (the suite runs
    in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakePredictor:
    """JAX's test double: records call occupancies; output row = burst mean
    (identifies which input produced which output)."""

    def __init__(self, batch_size=4, frame_shape=(3, 8, 8, 4)):
        self.batch_size = batch_size
        self.in_shape = (batch_size,) + frame_shape
        self.compile_seconds = 0.01
        self.flops_per_batch = 123.0
        self.calls = []

    fail_next = False

    def __call__(self, burst):
        assert burst.shape[0] <= self.batch_size
        self.calls.append(burst.shape[0])
        if self.fail_next:
            self.fail_next = False
            raise RuntimeError("device lost")
        return np.array([[b.mean()] for b in burst], np.float32)


def _burst(seed, shape=(3, 8, 8, 4)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _post(port, body, path="/predict"):
    """``(status, body bytes)`` of one POST."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


class _Serving:
    """``make_server`` on an ephemeral port, ``serve_forever`` on a thread;
    shut down and the batcher closed on exit."""

    def __init__(self, daemon, pred, linger_ms=1.0):
        self.server = daemon.make_server(pred, port=0, linger_ms=linger_ms)
        self.port = self.server.server_address[1]

    def __enter__(self):
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.server.batcher.close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


# -- JAX's five daemon tests, on both daemons ---------------------------------

@DAEMONS
def test_microbatcher_groups_concurrent_requests(daemon):
    pred = FakePredictor(batch_size=4)
    mb = daemon.MicroBatcher(pred, linger_ms=200.0)
    bursts = [_burst(i) for i in range(4)]
    results = [None] * 4

    def call(i):
        results[i] = mb.submit(bursts[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert pred.calls == [4]  # one full-occupancy call, not four singles
    for i in range(4):
        np.testing.assert_allclose(results[i], [bursts[i].mean()], rtol=1e-6)
    assert list(mb.batch_occupancies) == [4]
    mb.close()


@DAEMONS
def test_microbatcher_linger_dispatches_partial_batch(daemon):
    pred = FakePredictor(batch_size=8)
    mb = daemon.MicroBatcher(pred, linger_ms=10.0)
    out = mb.submit(_burst(0))  # alone; must not wait for 7 more
    assert out.shape == (1,)
    assert pred.calls == [1]
    mb.close()


@DAEMONS
def test_microbatcher_rejects_wrong_shape_and_propagates_errors(daemon):
    pred = FakePredictor(batch_size=2)
    mb = daemon.MicroBatcher(pred, linger_ms=1.0)
    with pytest.raises(ValueError, match="expected one burst"):
        mb.submit(np.zeros((2, 3, 8, 8, 4), np.float32))  # batched input
    pred.fail_next = True
    with pytest.raises(RuntimeError, match="device lost"):
        mb.submit(_burst(1))
    # the batcher survives a failed batch
    np.testing.assert_allclose(mb.submit(_burst(2)), [_burst(2).mean()],
                               rtol=1e-6)
    mb.close()


def _session(daemon):
    """One scripted session against ``daemon`` with a fake predictor: what
    a client sees (codes, responses, ``/stats``, ``/healthz``) and the
    device calls' occupancies."""
    pred = FakePredictor(batch_size=2)
    rec = {"codes": [], "responses": []}
    b = _burst(3)
    with _Serving(daemon, pred) as s:
        for body in (_npy(b), _npy(np.rint(b * 2 ** 14).astype(np.uint16)),
                     b"not an npy", _npy(np.zeros((2, 3, 8, 8, 4))),
                     None, _npy(b)):
            if body is None:  # a prediction that fails on the device
                pred.fail_next = True
                body = _npy(b)
            code, out = _post(s.port, body)
            rec["codes"].append(code)
            rec["responses"].append(np.load(io.BytesIO(out)).tolist()
                                    if code == 200 else
                                    sorted(json.loads(out)))
        rec["codes"].append(_post(s.port, _npy(b), "/other")[0])
        rec["codes"].append(_get(s.port, "/nowhere")[0])
        code, health = _get(s.port, "/healthz")
        rec["healthz"] = (code, health)
        code, stats = _get(s.port, "/stats")
        rec["stats"] = {k: stats[k] for k in ("requests", "errors",
                                              "mean_batch_occupancy")}
        rec["stats_keys"] = sorted(stats)
        rec["occupancies"] = list(s.server.batcher.batch_occupancies)
    rec["calls"] = pred.calls
    return rec


@DAEMONS
def test_http_round_trip_with_fake_predictor(daemon):
    rec = _session(daemon)
    b = _burst(3)
    # float32 and uint16 bodies, then a malformed body and a wrong shape
    # (400: the sender's fault), a failed prediction (503: retryable), the
    # server up after each, unknown routes 404
    assert rec["codes"] == [200, 200, 400, 400, 503, 200, 404, 404]
    np.testing.assert_allclose(rec["responses"][0], [b.mean()], rtol=1e-6)
    np.testing.assert_allclose(rec["responses"][1], rec["responses"][0],
                               atol=1e-4)
    assert rec["responses"][2] == rec["responses"][4] == ["error"]
    assert rec["healthz"] == (200, {"status": "ok",
                                    "input_shape": [2, 3, 8, 8, 4],
                                    "compile_seconds": 0.01,
                                    "flops_per_batch": 123.0})
    assert rec["stats"] == {"requests": 3, "errors": 3,
                            "mean_batch_occupancy": 1.0}
    assert "latency_p95_ms" in rec["stats_keys"]


def test_port_daemon_answers_as_jax_daemon():
    """The same session on both daemons: the same occupancies, responses,
    status codes, ``/stats`` counts and keys, and ``/healthz``; the port's
    ``/stats`` adds the p50 and p95 of its operators' counters."""
    jax_rec, port_rec = _session(jax_daemon), _session(port_daemon)
    port_keys = port_rec.pop("stats_keys")
    jax_keys = jax_rec.pop("stats_keys")
    assert port_rec == jax_rec
    assert port_keys == sorted(jax_keys + [
        f"{name}_{p}_ms" for name in ("queue_wait", "device_call", "decode",
                                      "encode") for p in ("p50", "p95")])
    assert port_rec["occupancies"] == port_rec["calls"] == [1, 1, 1, 1]


# -- a real tiny checkpoint ---------------------------------------------------

@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A tiny AlignLite DBSRNet with the port's seeded init, in the JAX
    package's checkpoint format."""
    net = dbsrnet_tiny(upsample_factor=4)
    init_params(net, make_generator("cpu", 0))
    return ckpt.save_checkpoint(str(tmp_path_factory.mktemp("ck")), "tiny",
                                1, make_optimizer().init(net))


@pytest.fixture(scope="module")
def bursts():
    rng = np.random.RandomState(7)
    shape = (TINY["burst_size"],) + TINY["burst_hw"] + (4,)
    return [rng.rand(*shape).astype(np.float32) for _ in range(3)]


@pytest.fixture(scope="module")
def jax_f32(tiny_ckpt):
    """JAX's float32 predictor of the tiny checkpoint (compiled once)."""
    return jax_load_predictor(tiny_ckpt, dtype=None, **TINY)


def _port_predictor(path, dtype):
    return load_predictor(path, device="cpu", dtype=dtype, **TINY)


def _serve_bursts(daemon, pred, bursts):
    """Each burst posted from its own thread (one uint16 body), and the
    outputs in order; plus the device calls' occupancies."""
    outs = [None] * len(bursts)

    def post(i):
        body = bursts[i] if i else np.rint(bursts[i] * 2 ** 14).astype(
            np.uint16)
        code, raw = _post(s.port, _npy(body))
        assert code == 200, raw
        outs[i] = np.load(io.BytesIO(raw))

    with _Serving(daemon, pred, linger_ms=50.0) as s:
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(bursts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        occupancies = list(s.server.batcher.batch_occupancies)
    return outs, occupancies


def _quantized(b):
    return np.rint(b * 2 ** 14).astype(np.uint16).astype(np.float32) / 2 ** 14


@DAEMONS
def test_http_serving_real_predictor(daemon, tiny_ckpt, bursts, jax_f32):
    """JAX's fifth test on both daemons, each with its own package's
    predictor (float32): the HTTP prediction equals a direct predictor
    call."""
    if daemon is jax_daemon:
        pred = jax_f32
    else:
        pred = _port_predictor(tiny_ckpt, None)
        assert pred.compile_seconds is None  # make_server warms it up
    outs, occupancies = _serve_bursts(daemon, pred, bursts)
    assert sum(occupancies) == len(bursts)
    for i, (b, out) in enumerate(zip(bursts, outs)):
        np.testing.assert_allclose(out, pred(_quantized(b) if i == 0 else b)[0],
                                   atol=1e-6)
    if daemon is port_daemon:
        assert pred.compile_seconds > 0 and pred.flops_per_batch > 0


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_port_http_matches_jax_load_predictor(tiny_ckpt, bursts, dtype,
                                              jax_f32):
    """The port's daemon on the CPU against JAX's ``load_predictor`` on the
    same checkpoint and bursts: float32 within 2e-4, bf16 within relative
    L2 2e-2."""
    jax_pred = jax_f32 if dtype is None else jax_load_predictor(
        tiny_ckpt, dtype=jnp.bfloat16, **TINY)
    outs, _ = _serve_bursts(port_daemon, _port_predictor(tiny_ckpt, dtype),
                            bursts)
    want = np.concatenate([jax_pred(b) for b in
                           [_quantized(bursts[0])] + bursts[1:]])
    got = np.stack(outs)
    assert got.shape == want.shape == (3, 64, 64, 3)
    if dtype is None:
        np.testing.assert_allclose(got, want, atol=F32_ABS)
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= BF16_REL_L2, rel


# -- run_serving and the predictor's counters ---------------------------------

def test_run_serving_parses_jax_flags_and_device():
    args = parse_args(["--checkpoint", "c.ckpt", "--f32", "--device", "cpu",
                       "--burst_hw", "40,72", "--port", "0",
                       "--linger_ms", "2.5", "--batch_size", "4",
                       "--burst_size", "8"])
    assert predictor_kwargs(args) == dict(batch_size=4, burst_size=8,
                                          burst_hw=(40, 72), device="cpu",
                                          dtype=None)
    assert (args.checkpoint, args.host, args.port, args.linger_ms) == \
        ("c.ckpt", "127.0.0.1", 0, 2.5)


def test_run_serving_defaults_bf16_on_the_card():
    args = parse_args(["--checkpoint", "c.ckpt"])
    assert predictor_kwargs(args) == dict(batch_size=8, burst_size=14,
                                          burst_hw=(48, 48), device="cuda",
                                          dtype="bfloat16")
    assert (args.port, args.linger_ms) == (8000, 5.0)
    if not torch.cuda.is_available():
        from dbsr_tpu_torch.run_serving import main
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--checkpoint", ckpt.__file__])


def test_flops_per_batch_counts_the_convs(tiny_ckpt, jax_f32, capsys):
    """``flops_per_batch``: 2 x the multiply-adds of the convs, which
    torch's own counter of ``aten.convolution`` gives for the fine decoder;
    the s2d decoder computes the same convs (its CPU route, the
    structured-dense conv, runs more multiply-adds than it counts). JAX's
    figure, XLA's cost analysis of the whole program, is printed beside
    it."""
    fine = load_predictor(tiny_ckpt, device="cpu", dtype=None,
                          fused_s2d=False, **TINY)
    assert fine.flops_per_batch is None and fine.compile_seconds is None
    fine.warm_up()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fine.net(torch.zeros(fine.in_shape))
    counts = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    assert counts == {"aten.convolution": fine.flops_per_batch}
    s2d = _port_predictor(tiny_ckpt, None).warm_up()
    assert s2d.flops_per_batch == fine.flops_per_batch
    with capsys.disabled():
        print(f"\nflops_per_batch: port {fine.flops_per_batch:.6g} (convs), "
              f"JAX {jax_f32.flops_per_batch} (XLA cost analysis)")
