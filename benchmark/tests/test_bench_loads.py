"""Each load driven on the CPU at a tiny size, past the harness's look for a
card: a sound run comes out correct, and a run with the timed path broken
underneath comes out not correct, once for each fault the cells can have:
a training step that returns its state unchanged, half of the batch left
out (the mean taken over the rest), a pool that is not rendered again each
epoch, an answer altered where it is produced. The tiny program computes in float32 here, so that only the
faults, and not bf16 at a tiny width, meet the configuration's limits."""

import numpy as np
import pytest

from benchmark import harness
from benchmark.loads import direct, http, train
from benchmark.tests import tiny


@pytest.fixture
def tiny_train(monkeypatch, tmp_path):
    tiny.tiny_trainer_net(monkeypatch)
    cell = tiny.tiny_cell("dbsr_lite", "train.b16", "lite.train.b16",
                          tmp_path, batch_size=2)
    cell.config["compute_dtype"] = "float32"
    return cell


def _alter_answers(monkeypatch):
    from dbsr_tpu_torch import serving

    call = serving.Predictor.__call__

    def altered(self, burst):
        out = call(self, burst)
        return out * 0.9

    monkeypatch.setattr(serving.Predictor, "__call__", altered)


def test_train_sound_run_is_correct(tiny_train, tmp_path):
    run = train.run(tiny.context(tiny_train, tmp_path / "run"))
    assert run.correct(), run.checks
    assert run.metrics["train_samples_per_s"] > 0
    assert run.attempted == run.counters["train.steps"] > 0
    assert run.metrics["setup_s"] > 0


def test_train_state_left_unchanged_is_caught(tiny_train, tmp_path,
                                              monkeypatch):
    from dbsr_tpu_torch.training import state

    monkeypatch.setattr(state.TrainState, "apply_gradients",
                        lambda self: None)
    run = train.run(tiny.context(tiny_train, tmp_path / "run"))
    assert not run.correct()
    assert run.checks["change_gap"][0] == pytest.approx(1.0)


def test_train_half_batch_is_caught(tiny_train, tmp_path, monkeypatch):
    from dbsr_tpu_torch.data import procedural

    make = procedural.make_pool_prepare_fn

    def half(cfg, batch_size):
        prepare = make(cfg, batch_size)

        def cut(generator, pool):
            out = prepare(generator, pool)
            n = out["burst"].shape[0] // 2
            return dict(out, burst=out["burst"][:n],
                        frame_gt=out["frame_gt"][:n])
        return cut

    monkeypatch.setattr(procedural, "make_pool_prepare_fn", half)
    run = train.run(tiny.context(tiny_train, tmp_path / "run"))
    assert not run.correct()


def test_train_stale_pool_is_caught(tiny_train, tmp_path, monkeypatch):
    """The window's epochs train on the first epoch's pool: the last
    epoch's pool and first batch differ from the reference's."""
    from dbsr_tpu_torch.data import procedural

    refresh = procedural.ProceduralImagePool.refresh
    monkeypatch.setattr(procedural.ProceduralImagePool, "refresh",
                        lambda self, round_idx: refresh(self, 0))
    run = train.run(tiny.context(tiny_train, tmp_path / "run"))
    assert not run.correct()
    assert run.checks["pool_gap"][0] > 0.1
    assert run.checks["pred_gap"][0] <= run.checks["pred_gap"][1]


def test_train_network_that_moves_no_leaf_is_not_correct(
        tiny_train, tmp_path, monkeypatch):
    """Where the reference's network takes no gradient at all (its output
    dead on both sides), nothing can be compared: the run says so and is
    not correct."""
    from benchmark import oracle

    def dead(net):
        import torch

        with torch.no_grad():
            dict(net.named_parameters())[oracle.OUTPUT_CONV[1]].fill_(-10.0)

    monkeypatch.setattr(oracle, "live_output", dead)
    run = train.run(tiny.context(tiny_train, tmp_path / "run"))
    assert not run.correct()
    assert any("moved no leaf" in e for e in run.errors)
    assert run.checks["grad_gap"][0] == float("inf")


def test_live_output_makes_the_output_conv_positive():
    """Its input is a ReLU's output: with the output conv's weights and
    bias positive, the output's pre-activation is positive everywhere."""
    import torch

    from benchmark import oracle
    from benchmark.reference.dbsr import DBSRNet
    from benchmark.reference.layers import init_params
    from benchmark.reference.procedural import make_generator

    net = DBSRNet(**tiny.TINY_NET, flow_net="lite")
    init_params(net, make_generator("cpu", 3))
    params = dict(net.named_parameters())
    before = [params[k].detach().clone() for k in oracle.OUTPUT_CONV]
    oracle.live_output(net)
    for k, b in zip(oracle.OUTPUT_CONV, before):
        assert torch.equal(params[k].detach(), b.abs())
    seen = {}
    net.decoder.ConvBlock_1.register_forward_hook(
        lambda m, a, o: seen.update(x=a[0]))
    net(torch.rand(1, 3, 8, 8, 4))
    w, bias = (params[k].detach() for k in oracle.OUTPUT_CONV)
    pre = torch.einsum("bhwc,oc->bhwo", seen["x"], w[:, :, 0, 0]) + bias
    assert bool((pre > 0).all())


@pytest.fixture
def tiny_direct(tmp_path):
    cell = tiny.tiny_cell("dbsr_pwc", "direct.b8", "pwc.serve.b8", tmp_path,
                          batch_size=2, distinct_bursts=4, sample_calls=3)
    cell.config["compute_dtype"] = None
    return cell


def test_direct_sound_run_is_correct(tiny_direct, tmp_path):
    run = direct.run(tiny.context(tiny_direct, tmp_path / "run"))
    assert run.correct(), run.checks
    assert run.attempted == 2 * run.counters["serve.calls"]


def test_direct_altered_answer_is_caught(tiny_direct, tmp_path, monkeypatch):
    _alter_answers(monkeypatch)
    run = direct.run(tiny.context(tiny_direct, tmp_path / "run"))
    assert not run.correct()


@pytest.fixture
def tiny_http(tmp_path):
    # the HTTP loop's files, ready for a cell (PERF.md: not listed yet)
    cell = tiny.tiny_cell("dbsr_lite", "http.poisson", "lite.serve.http",
                          tmp_path, rate_per_s=6.0, distinct_bursts=3,
                          sample_requests=4, warmup_requests=2,
                          warmup_s=0.5, batch_size=2)
    cell.config["compute_dtype"] = None
    return cell


def test_http_sound_run_is_correct(tiny_http, tmp_path):
    run = http.run(tiny.context(tiny_http, tmp_path / "run", seconds=1.0))
    assert run.correct(), (run.checks, run.errors)
    assert run.attempted == 6 and run.failed == 0  # the window's alone
    assert run.metrics["http_p95_ms"] > 0
    assert run.counters["http.occupancy"] >= 1


def test_http_altered_answer_is_caught(tiny_http, tmp_path, monkeypatch):
    _alter_answers(monkeypatch)
    run = http.run(tiny.context(tiny_http, tmp_path / "run", seconds=1.0))
    assert not run.correct()


def test_http_arrivals_are_the_same_set_for_every_seed():
    a = http.plan_arrivals(50.0, 20.0, np.random.default_rng(1))
    b = http.plan_arrivals(50.0, 20.0, np.random.default_rng(2))
    assert len(a) == len(b) == 1000 and a != b
    assert sorted(np.diff([0.0] + a)) == pytest.approx(
        sorted(np.diff([0.0] + b)))
    assert a[-1] == pytest.approx(20.0, rel=0.02)


def test_p95_is_the_nearest_rank():
    assert http.p95(list(range(1, 101))) == 95
    assert http.p95([1.0, http.FAILED_MS]) == http.FAILED_MS


def test_the_training_control_fails_where_bf16_passes(monkeypatch, tmp_path):
    """At a tiny size: the port's bf16 training steps and the reference in
    float8 put in the program's place, each against the float32 reference;
    the first step's prediction separates them (``pred_gap``, the number
    that the control fails at the cell's size)."""
    from benchmark import oracle

    tiny.tiny_trainer_net(monkeypatch)
    cell = tiny.tiny_cell("dbsr_lite", "train.b16", "lite.train.b16",
                          tmp_path, batch_size=2)
    run = train.run(tiny.context(cell, tmp_path / "run"))  # bf16
    ref = oracle.train_reference(cell.config, 2 ** 31 + 11, 2, "cpu")
    ctl = oracle.train_reference(cell.config, 2 ** 31 + 11, 2, "cpu",
                                 quant=oracle.fp8_round)
    control = oracle.compare_train(ctl, ref)["pred_gap"]
    assert control > 3 * run.checks["pred_gap"][0]
    assert control > cell.limits["pred_gap"]
