"""The plain reference against the port at a tiny size on the CPU: the same
initial parameters from a seed, the same forward (both aligners, the s2d
decoder against the reference's fine one), the same pool, synthesis and
serving bursts, the same checkpoint reading; and the control in float8
falls farther from the reference than the port's bf16 does."""

import numpy as np
import pytest
import torch

from benchmark import harness, inputs, oracle
from benchmark.reference import procedural as rp
from benchmark.reference import synthetic as rs
from benchmark.reference.dbsr import DBSRNet as RefNet
from benchmark.reference.layers import init_params as ref_init
from benchmark.tests.tiny import TINY_NET


@pytest.mark.parametrize("flow_net", ["lite", "pwc"])
def test_init_and_forward_match_the_port(flow_net):
    from dbsr_tpu_torch.data.procedural import make_generator
    from dbsr_tpu_torch.models.dbsr import DBSRNet
    from dbsr_tpu_torch.models.layers import init_params

    port = DBSRNet(**TINY_NET, flow_net=flow_net, fused_s2d_decoder=True)
    ref = RefNet(**TINY_NET, flow_net=flow_net)
    init_params(port, make_generator("cpu", 3))
    ref_init(ref, rp.make_generator("cpu", 3))
    a, b = port.state_dict(), ref.state_dict()
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    x = torch.rand(2, 5, 16, 16, 4, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got, want = port(x)[0], ref(x)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_pool_and_synthesis_match_the_port():
    from dbsr_tpu_torch.configs.dbsr.default_synthetic import burst_config
    from dbsr_tpu_torch.data.procedural import (ProceduralImagePool,
                                                make_generator,
                                                make_pool_prepare_fn)

    class S:
        fused_resample = True

    cfg = burst_config(S())
    pool = ProceduralImagePool(3, cfg.pre_crop_sz, seed=2 ** 31 + 5,
                               device="cpu", num_leaves=20).refresh(0)
    ref_pool = rp.render_pool(3, cfg.pre_crop_sz, 2 ** 31 + 5, 0, "cpu",
                              num_leaves=20)
    assert torch.equal(pool, ref_pool)
    got = make_pool_prepare_fn(cfg, 2)(make_generator("cpu", 9, 131), pool)
    g = rp.make_generator("cpu", 9, 131)
    rcfg = rs.BurstConfig(**cfg._asdict())
    crops = rp.draw_crops(g, 2, 3)
    want = rs.rgb2rawburst_from_draws(rp.crops_from_draws(ref_pool, crops),
                                      rs.sample_draws(g, 2, rcfg), rcfg)
    for k in ("burst", "frame_gt"):
        assert torch.equal(got[k], want[k])


def test_serving_bursts_are_the_val_protocols_on_the_raw_grid():
    b = inputs.serving_bursts(11, 2, 14, "cpu")
    assert b.shape == (2, 14, 48, 48, 4) and b.dtype == torch.float32
    q = b * inputs.RAW_SCALE
    assert torch.equal(q, torch.round(q))
    assert torch.equal(b, inputs.serving_bursts(11, 2, 14, "cpu"))
    assert not torch.equal(b, inputs.serving_bursts(12, 2, 14, "cpu"))


def test_checkpoint_reader_matches_the_ports():
    from dbsr_tpu_torch.training.checkpoint import read_checkpoint
    from dbsr_tpu_torch.utils.convert import params_from_flax

    from benchmark.reference.checkpoint import (params_from_flax as ref_pf,
                                                read_checkpoint as ref_read)

    path = harness.repo_path("dbsr_tpu/artifacts/align_lite_params.ckpt")
    (h1, t1), (h2, t2) = read_checkpoint(path), ref_read(path)
    assert h1 == h2
    a, b = params_from_flax(t1["params"]), ref_pf(t2["params"])
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_fp8_rounding_keeps_the_scale_and_three_mantissa_bits():
    x = torch.linspace(-3.0, 3.0, 1001, requires_grad=True)
    y = oracle.fp8_round(x)
    assert y.abs().max() == 3.0
    rel = ((y - x).abs() / x.abs().clamp_min(1e-2)).max()
    assert 0.01 < rel <= 2 ** -4 + 1e-6
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))  # 1 is exact in e4m3


def test_the_control_falls_farther_than_the_ports_bf16(tmp_path):
    """At a tiny size: the reference in float8 against float32 differs by
    several times what the port's bf16 forward does."""
    from dbsr_tpu_torch.serving import load_predictor

    from benchmark.tests.tiny import tiny_config

    cfg = tiny_config("dbsr_lite", tmp_path)
    bursts = inputs.serving_bursts(5, 4, 14, "cpu")
    ref = oracle.serve_reference(cfg["serve_checkpoint"], bursts, "cpu")
    ctl = oracle.serve_reference(cfg["serve_checkpoint"], bursts, "cpu",
                                 quant=oracle.fp8_round)
    pred = load_predictor(cfg["serve_checkpoint"], batch_size=4,
                          device="cpu", dtype="bfloat16")
    got = pred(bursts.numpy())
    prog = max(oracle.rel_l2(g, r.numpy()) for g, r in zip(got, ref))
    control = max(oracle.rel_l2(c.numpy(), r.numpy())
                  for c, r in zip(ctl, ref))
    assert control > 3 * prog
    assert np.isfinite(control)


@pytest.mark.card
def test_the_control_fails_the_limit_on_the_card(card):
    """At the cell's own size on the card: the reference in float8 in the
    program's place comes out over the serving limit."""
    from benchmark import control

    cell = harness.find_cell("pwc.serve.b8")
    rec = control.serving_readings(cell, 2 ** 31 + 99, card, bursts=8)
    assert rec["control"]["worst_rel_l2"] > cell.limits["worst_rel_l2"]
