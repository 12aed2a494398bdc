"""The port's spans on the CPU: ``annotate`` is a shared null context with
no profiler running and a ``record_function`` span under one; each of the
eleven kernel entries opens its ``op.<entry>`` span on the CPU path; a
trainer step, a predictor call, the prefetch worker (through
``maybe_trace``, which records every thread) and the serving daemon open
theirs; the daemon's counters reach ``/stats``.
"""

import glob
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dbsr_tpu_torch import serving_daemon
from dbsr_tpu_torch.data.pipeline import DevicePrefetcher
from dbsr_tpu_torch.data.procedural import (ProceduralImagePool,
                                            ProceduralPoolBatcher,
                                            make_generator,
                                            make_pool_prepare_fn)
from dbsr_tpu_torch.data.synthetic import BurstConfig
from dbsr_tpu_torch.models.dbsr import dbsrnet_tiny
from dbsr_tpu_torch.models.layers import init_params
from dbsr_tpu_torch.ops import conv_s2d, correlation, merge, resample, warp
from dbsr_tpu_torch.serving import Predictor
from dbsr_tpu_torch.training.actors import make_synthetic_actor
from dbsr_tpu_torch.training.state import make_optimizer
from dbsr_tpu_torch.training.trainer import LoaderSpec, Trainer
from dbsr_tpu_torch.utils import profiling
from dbsr_tpu_torch.utils.profiling import annotate, maybe_trace


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _span_names(fn, all_threads=False):
    """The names of the host events recorded while ``fn()`` ran under the
    profiler, and what it returned."""
    kw = {}
    if all_threads:
        kw["experimental_config"] = torch.profiler._ExperimentalConfig(
            profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
        out = fn()
    return {e.name for e in prof.events()}, out


# -- annotate -----------------------------------------------------------------

def test_annotate_is_one_shared_null_context_without_a_profiler():
    a, b = annotate("train.step"), annotate("op.warp_forward")
    assert a is b
    with a as entered:
        assert entered is None


def test_annotate_opens_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a span {name!r} was opened")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for _ in range(3):
        with annotate("serve.forward"):
            pass


def test_annotate_records_its_span_under_the_profiler():
    def body():
        with annotate("probe.span"):
            return torch.ones(4).sum()

    names, _ = _span_names(body)
    assert "probe.span" in names
    # and it is the null context again once the profiler has stopped
    assert annotate("probe.span") is annotate("other")


# -- the eleven kernel entries ------------------------------------------------

def _flow(B, H, W):
    return torch.rand(B, H, W, 2, generator=torch.Generator().manual_seed(1))


def _entry_args(name):
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.rand(*s, generator=g)  # noqa: E731
    feat, flow, g3 = r(1, 4, 4, 2), _flow(1, 4, 4), r(1, 4, 4, 2)
    first, second, gc = r(1, 5, 5, 2), r(1, 5, 5, 2), r(1, 5, 5, 81)
    mfeat, logits, mg = r(1, 3, 2, 2, 4), r(1, 3, 2, 2, 4), r(1, 2, 2, 4)
    eye = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    return {
        "warp_forward": (warp, (feat, flow)),
        "warp_dfeat": (warp, (flow, g3)),
        "warp_dflow": (warp, (feat, flow, g3)),
        "correlation_forward": (correlation, (first, second)),
        "correlation_dfirst": (correlation, (second, gc)),
        "correlation_dsecond": (correlation, (first, gc)),
        "merge_forward": (merge, (mfeat, logits)),
        "merge_backward": (merge, (mfeat, logits, mg)),
        "affine_resample": (resample, (r(1, 12, 12, 3),
                                       eye.expand(1, 2, 2, 3).contiguous(),
                                       (4, 4), 2, 2)),
        "conv3x3_s2d_forward": (conv_s2d, (r(1, 3, 3, 8), r(3, 2, 3, 3))),
        "conv3x3_s2d_dweight": (conv_s2d, (r(1, 3, 3, 8), r(1, 3, 3, 12),
                                           (3, 2, 3, 3))),
    }[name]


ENTRIES = ("warp_forward", "warp_dfeat", "warp_dflow", "correlation_forward",
           "correlation_dfirst", "correlation_dsecond", "merge_forward",
           "merge_backward", "affine_resample", "conv3x3_s2d_forward",
           "conv3x3_s2d_dweight")


@pytest.mark.parametrize("entry", ENTRIES)
def test_kernel_entry_opens_its_op_span_on_the_cpu_path(entry):
    module, args = _entry_args(entry)
    fn = getattr(module, entry)
    # the entry is its module's own function, found by name (the
    # benchmark's bound recorder wraps it there), not a wrapper
    assert fn.__module__ == module.__name__ and fn.__name__ == entry
    names, out = _span_names(lambda: fn(*args))
    assert f"op.{entry}" in names
    assert not {n for n in names if n.startswith("op.")} - {f"op.{entry}"}
    # the span leaves the result as the plain path gives it
    again = fn(*args)
    for a, b in zip(out if isinstance(out, tuple) else (out,),
                    again if isinstance(again, tuple) else (again,)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- the trainer, the feed, the network ---------------------------------------

CFG = BurstConfig(burst_size=3, crop_sz=(32, 32), border_crop=4,
                  max_translation=3.0, fused_resample=True)


def _tiny_trainer(workspace, steps=2):
    net = dbsrnet_tiny()
    pool = ProceduralPoolBatcher(ProceduralImagePool(4, CFG.pre_crop_sz,
                                                     seed=0, device="cpu",
                                                     num_leaves=20),
                                 2, steps)
    return Trainer(net, make_synthetic_actor(net, boundary_ignore=4),
                   make_optimizer(base_lr=1e-3, steps_per_epoch=steps),
                   [LoaderSpec("train", pool)], make_pool_prepare_fn(CFG, 2),
                   str(workspace), net_name="tiny", print_interval=1, seed=3,
                   device="cpu")


def test_a_trainer_step_opens_the_step_and_feed_spans(tmp_path):
    trainer = _tiny_trainer(tmp_path)
    state = trainer.init_state()
    trainer.epoch = 1
    names, _ = _span_names(
        lambda: trainer._cycle(state, trainer.loaders[0]))
    assert {"train.step", "train.prepare", "train.forward", "train.backward",
            "train.optimizer", "train.flush", "feed.wait"} <= names
    assert {"dbsr.align", "dbsr.encode", "dbsr.merge", "dbsr.decode"} <= names
    # the kernel entries of the step: the synthesis' resample, the warp,
    # the cost volume, the merge and their backward
    assert {"op.affine_resample", "op.warp_forward", "op.correlation_forward",
            "op.merge_forward", "op.merge_backward",
            "op.warp_dfeat"} <= names


def test_maybe_trace_records_the_prefetch_workers_spans(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("DBSR_TPU_TRACE_DIR", str(tmp_path))
    main = threading.get_ident()
    workers = []

    def batch():
        workers.append(threading.get_ident())
        time.sleep(0.002)
        return torch.ones(2)

    feed = DevicePrefetcher(batch, 12, device_put=lambda b: b * 2)
    for i, b in enumerate(feed):
        with maybe_trace(i):
            with annotate("probe.step"):
                (b + 1).sum()
    files = glob.glob(str(tmp_path / "trace_steps5-9_*.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    tids = {}
    for e in events:
        tids.setdefault(e.get("name"), set()).add(e.get("tid"))
    assert {"feed.render", "feed.put", "probe.step"} <= set(tids)
    # the render is the worker's, not the main thread's
    assert not tids["feed.render"] & tids["probe.step"]
    assert set(workers) and main not in workers


# -- the predictor ------------------------------------------------------------

def _tiny_predictor():
    net = dbsrnet_tiny()
    init_params(net, make_generator("cpu", 5))
    return Predictor(net.eval(), 2, 3, (8, 8), torch.device("cpu"))


def test_a_predictor_call_opens_the_serve_and_network_spans():
    pred = _tiny_predictor()
    burst = np.random.default_rng(0).random((1, 3, 8, 8, 4), np.float32)
    names, out = _span_names(lambda: pred(burst))
    assert {"serve.stage_in", "serve.forward", "serve.stage_out"} <= names
    assert {"dbsr.align", "dbsr.encode", "dbsr.merge", "dbsr.decode"} <= names
    assert {"op.warp_forward", "op.correlation_forward",
            "op.merge_forward"} <= names
    assert out.shape == (1, 64, 64, 3)
    np.testing.assert_array_equal(out, pred(burst))


# -- the serving daemon -------------------------------------------------------

class _FakePredictor:
    batch_size = 2
    in_shape = (2, 3, 8, 8, 4)
    compile_seconds, flops_per_batch = 0.01, 1.0

    def __call__(self, stacked):
        time.sleep(0.002)
        return stacked.mean(axis=(1, 2, 3, 4))


def test_the_batcher_counts_queue_waits_and_device_calls():
    mb = serving_daemon.MicroBatcher(_FakePredictor(), linger_ms=20.0)
    try:
        bursts = [np.full((3, 8, 8, 4), i, np.float32) for i in range(4)]
        outs = [None] * 4

        def ask(i):
            outs[i] = mb.submit(bursts[i])

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        mb.close()
    assert [float(o) for o in outs] == [0.0, 1.0, 2.0, 3.0]
    assert len(mb.queue_waits) == 4
    assert len(mb.call_seconds) == len(mb.batch_occupancies)
    assert all(s >= 0.002 for s in mb.call_seconds)
    assert all(w >= 0 for w in mb.queue_waits)
    stats = serving_daemon.ServingStats()
    stats.record_codec(decode_s=0.001)
    stats.record_codec(decode_s=0.003, encode_s=0.002)
    out = stats.summary(mb.batch_occupancies, mb.queue_waits,
                        mb.call_seconds)
    for name in ("queue_wait", "device_call", "decode", "encode"):
        assert out[f"{name}_p50_ms"] <= out[f"{name}_p95_ms"]
    assert out["decode_p95_ms"] == pytest.approx(3.0)
    assert out["encode_p50_ms"] == pytest.approx(2.0)
    assert out["device_call_p50_ms"] >= 2.0


def test_the_daemon_spans_show_in_an_all_thread_trace():
    import http.client
    import io

    server = serving_daemon.make_server(_FakePredictor(), port=0,
                                        linger_ms=1.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    buf = io.BytesIO()
    np.save(buf, np.ones((3, 8, 8, 4), np.float32))

    def session():
        conn = http.client.HTTPConnection("127.0.0.1",
                                          server.server_address[1],
                                          timeout=30)
        try:
            conn.request("POST", "/predict", body=buf.getvalue())
            assert conn.getresponse().read()
            conn.request("GET", "/stats")
            return json.loads(conn.getresponse().read())
        finally:
            conn.close()

    try:
        names, stats = _span_names(session, all_threads=True)
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.close()
        thread.join(timeout=30)
    assert {"http.decode", "http.encode", "batcher.linger",
            "batcher.call"} <= names
    assert stats["requests"] == 1
    assert {"queue_wait_p95_ms", "device_call_p95_ms", "decode_p95_ms",
            "encode_p95_ms"} <= set(stats)


def test_the_profiling_module_is_the_ports_one_span_helper():
    # the trainer, the feed, the network, the predictor, the daemon and the
    # kernel entries all take the same helper
    from dbsr_tpu_torch import serving
    from dbsr_tpu_torch.data import pipeline
    from dbsr_tpu_torch.models import dbsr
    from dbsr_tpu_torch.training import trainer
    for mod in (trainer, pipeline, dbsr, serving, serving_daemon, warp,
                correlation, merge, resample, conv_s2d):
        assert mod.annotate is profiling.annotate
