"""The last line's schema, and the trace's reduction to busy time, idle
gaps and labelled device time, on a made-up trace."""

import json

from benchmark import harness, yardstick


def _trace():
    t = harness.Trace()
    t.window_s = 1e-5
    # (name, start_ns, end_ns, launching thread, launch_ns)
    t.ops = [("conv", 0, 1000, 1, 0), ("warp_kernel<1>", 500, 2000, 1, 10),
             ("resample_kernel", 5000, 6000, 2, 4000),
             ("nccl_allreduce", 9000, 9500, 1, 8000)]
    t.host = [("bench.prepare", 3500, 4500, 2), ("aten::add", 2500, 4900, 1),
              ("aten::mul", 6100, 8900, 1)]
    t.launches = [("warp_forward", 0.5e-6), ("affine_resample", 0.25e-6)]
    return t


def test_trace_reductions():
    t = _trace()
    assert t.busy_intervals() == [(0, 2000), (5000, 6000), (9000, 9500)]
    assert t.busy_s == 3500e-9
    assert t.labelled_device_s("bench.prepare") == (1000e-9, 1)
    # the innermost host span open at each gap's middle names it
    assert t.idle_gaps() == [["aten::mul", 3000e-9],
                             ["bench.prepare", 3000e-9]]
    assert t.top_ops(2) == [["warp_kernel<1>", 1500e-9], ["conv", 1000e-9]]
    assert yardstick.idle_share(t) == 100 * (1 - 3500e-9 / 1e-5)
    # bounds 0.75 us over the own kernels' 2.5 us
    assert abs(yardstick.kernel_roofline(t) - 30.0) < 1e-9


def test_an_empty_trace_reads_nothing():
    t = harness.Trace()
    assert yardstick.idle_share(t) is None
    assert yardstick.kernel_roofline(t) is None
    assert yardstick.idle_share(None) is None


def _run(trace=None):
    run = harness.Run(metrics={"setup_s": 12.5, "http_p95_ms": 80.25},
                      attempted=400, failed=0, trace=trace,
                      device={"platform": "gpu", "kind": "card", "count": 1,
                              "memory_peak_bytes": 123})
    run.checks["worst_rel_l2"] = (0.01, 0.05)
    return run


def test_last_line_untraced():
    line = harness.result_line(_run(), 0, {"setup_s": 12.5}, {"setup_s": "s"})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["attempted"] == 400
    assert line["metrics"] == {"setup_s": {"value": 12.5, "unit": "s"}}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["checks"] == {"worst_rel_l2": {"value": 0.01, "limit": 0.05}}
    json.dumps(line)


def test_last_line_traced_carries_the_trace():
    line = harness.result_line(_run(_trace()), 1, {"x": 1.0}, {"x": "%"})
    assert line["device"]["busy_s"] == 3500e-9
    assert line["device"]["window_s"] == 1e-5
    assert len(line["breakdown"]["device_ops"]) <= 10
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    assert list(line)[-1] == "checks"


def test_correct_needs_every_check_within_its_limit():
    run = _run()
    assert run.correct()
    run.checks["loss_gap"] = (0.2, 0.1)
    assert not run.correct()
    run.checks["loss_gap"] = (float("nan"), 0.1)
    assert not run.correct()
    assert not harness.Run().correct()  # nothing compared
    run = _run()
    run.errors.append("a request got no answer")
    assert not run.correct()
