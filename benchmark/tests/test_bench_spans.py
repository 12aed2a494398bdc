"""The readers of the program's spans (``spans.py`` and the seven
``metrics/*`` that use it) on a hand-built trace: which launches count
under a span, from which threads, and None, never 0, where the trace
holds no such span."""

import pytest

from benchmark import harness, spans

MAIN, AUTOGRAD, WORKER = 1, 2, 3
ms = 1_000_000  # ns


def _run(trace, **counters):
    return harness.Run(trace=trace, counters=counters)


def _train_trace():
    """Two steps on the main thread: forward [0, 10) ms, backward
    [10, 30), optimizer [30, 32); autograd's thread launches inside the
    backward, the prefetch worker launches throughout."""
    t = harness.Trace()
    t.window_s = 0.1
    t.host = []
    for k in range(2):
        o = 50 * ms * k
        t.host += [("train.forward", o, o + 10 * ms, MAIN),
                   ("train.backward", o + 10 * ms, o + 30 * ms, MAIN),
                   ("train.optimizer", o + 30 * ms, o + 32 * ms, MAIN),
                   ("op.warp_forward", o + 2 * ms, o + 3 * ms, MAIN),
                   ("op.merge_backward", o + 12 * ms, o + 13 * ms, AUTOGRAD),
                   (spans.AUTOGRAD_EVENT + ": ConvolutionBackward0",
                    o + 11 * ms, o + 20 * ms, AUTOGRAD)]
    # (name, start, end, launching thread, launch time): device times 1, 2,
    # 4, 8, 16, 32 us so that each sum names its parts
    us = 1000
    t.ops = [("fwd", 1 * ms, 1 * ms + 1 * us, MAIN, 1 * ms),
             ("bwd_main", 12 * ms, 12 * ms + 2 * us, MAIN, 11 * ms),
             ("bwd_autograd", 14 * ms, 14 * ms + 4 * us, AUTOGRAD, 13 * ms),
             ("render", 15 * ms, 15 * ms + 8 * us, WORKER, 14 * ms),
             ("adam", 31 * ms, 31 * ms + 16 * us, MAIN, 30 * ms + 5),
             ("flush", 40 * ms, 40 * ms + 32 * us, MAIN, 40 * ms),
             ("unlinked", 41 * ms, 41 * ms + 64 * us, None, None)]
    t.host.sort(key=lambda h: h[1])
    return t


def _read(name, run):
    return harness.metric_reader(name)(run)


def test_forward_and_optimizer_count_their_own_threads_launches():
    run = _run(_train_trace(), **{"train.traced_steps": 2})
    assert _read("train.forward_ms", run) == pytest.approx(1e-3 / 2)
    assert _read("train.optimizer_ms", run) == pytest.approx(16e-3 / 2)


def test_backward_counts_autograds_thread_and_not_the_workers():
    run = _run(_train_trace(), **{"train.traced_steps": 2})
    # the main thread's 2 us and autograd's 4 us; the worker's 8 us, launched
    # inside the same span, are left out
    assert _read("train.backward_ms", run) == pytest.approx(6e-3 / 2)
    assert spans.autograd_threads(run.trace) == {AUTOGRAD}
    seconds, n = spans.launched_device_s(run.trace, "train.backward")
    assert (seconds, n) == (pytest.approx(2e-6), 2)


def test_op_host_time_is_every_threads_op_spans_a_step():
    run = _run(_train_trace(), **{"train.traced_steps": 2})
    # 1 ms on the main thread and 1 ms on autograd's, twice, over 2 steps
    assert _read("train.op_host_ms", run) == pytest.approx(2.0)


def test_overlapping_spans_of_one_thread_count_once():
    t = harness.Trace()
    t.host = [("op.a", 0, 10, MAIN), ("op.b", 5, 20, MAIN),
              ("op.c", 5, 20, AUTOGRAD), ("serve.forward", 0, 100, MAIN)]
    assert spans.host_s(t, spans.is_op_span) == (pytest.approx(35e-9), 3)


def _serve_trace():
    t = harness.Trace()
    t.window_s = 0.05
    t.host = []
    t.ops = []
    for k in range(3):
        o = 10 * ms * k
        t.host += [("serve.stage_in", o, o + 1 * ms, MAIN),
                   ("serve.forward", o + 1 * ms, o + 7 * ms, MAIN),
                   ("op.conv3x3_s2d_forward", o + 2 * ms, o + 2 * ms + 500,
                    MAIN),
                   ("serve.stage_out", o + 7 * ms, o + 9 * ms, MAIN)]
        t.ops += [("Memcpy HtoD", o + 1 * ms, o + 1 * ms + 3000, MAIN,
                   o + 500),
                  ("conv", o + 2 * ms, o + 5 * ms, MAIN, o + 2 * ms),
                  ("clamp", o + 8 * ms, o + 8 * ms + 1000, MAIN,
                   o + 7 * ms + 1),
                  ("Memcpy DtoH", o + 9 * ms, o + 9 * ms + 2000, MAIN,
                   o + 7 * ms + 2)]
    t.host.sort(key=lambda h: h[1])
    return t


def test_serving_readers_a_call():
    run = _run(_serve_trace(), **{"serve.traced_calls": 3})
    assert _read("serve.launch_ms", run) == pytest.approx(6.0)
    # the copy in, the clamp and the copy out: 3 + 1 + 2 us a call
    assert _read("serve.transfer_ms", run) == pytest.approx(6e-3)
    assert _read("serve.op_host_ms", run) == pytest.approx(500e-6)


NEW = ("train.forward_ms", "train.backward_ms", "train.optimizer_ms",
       "train.op_host_ms", "serve.launch_ms", "serve.transfer_ms",
       "serve.op_host_ms")


@pytest.mark.parametrize("name", NEW)
def test_a_reader_without_its_spans_reads_none(name):
    counters = {"train.traced_steps": 2, "serve.traced_calls": 3}
    assert _read(name, _run(None, **counters)) is None
    assert _read(name, _run(harness.Trace(), **counters)) is None
    # the other cell's spans only
    other = _serve_trace() if name.startswith("train.") else _train_trace()
    other.host = [h for h in other.host if not h[0].startswith("op.")]
    assert _read(name, _run(other, **counters)) is None


@pytest.mark.parametrize("name", NEW)
def test_each_new_reader_is_declared_for_the_cell_it_reads(name):
    m = next(m for m in harness.load_manifest()["per_layer"]
             if m["name"] == name)
    assert m["source"] == "program_span" and m["better"] == "lower"
    cell = "lite.train.b16" if name.startswith("train.") else "pwc.serve.b8"
    assert m["workloads"] == [cell]
