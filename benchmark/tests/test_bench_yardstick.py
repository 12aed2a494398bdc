"""The benchmark's arithmetic: the FLOP count against the program's own
conv count, and each kernel's bound against the kernel table's bound
column in ``PERF.md`` (``chip_smoke.py``'s arithmetic)."""

import json

import pytest
import torch

from benchmark import harness, yardstick
from benchmark.tests import tiny


@pytest.mark.parametrize("config", ["dbsr_lite", "dbsr_pwc"])
def test_conv_count_matches_the_programs_hooks(config, tmp_path):
    from dbsr_tpu_torch.profile_serving import conv_flops
    from dbsr_tpu_torch.serving import load_predictor

    cfg = tiny.tiny_config(config, tmp_path)
    pred = load_predictor(cfg["serve_checkpoint"], batch_size=2,
                          device="cpu", dtype=None)
    x = torch.rand(2, 14, 48, 48, 4)
    want = conv_flops(pred, x)
    got = yardstick.model_macs(cfg["net"], 2, 14, (48, 48), training=False)
    assert 2 * got["conv"] == want
    assert (got["transposed"] > 0) == (config == "dbsr_pwc")
    assert got["cost_volume"] > 0 and got["merge"] == 2 * 14 * 48 * 48 * 16


def test_the_frozen_aligner_counts_its_forward_only():
    with open(harness.HERE / "configs" / "dbsr_lite.json") as f:
        net = json.load(f)["net"]
    fwd = yardstick.model_macs(net, 2, 8, (48, 48), training=False)
    step = yardstick.model_macs(net, 2, 8, (48, 48), training=True)
    assert step["cost_volume"] == fwd["cost_volume"]  # the aligner's alone
    assert step["merge"] == 3 * fwd["merge"]
    # every conv but the aligner's and the encoder's first (its input, the
    # burst, takes no gradient) counts three times
    assert 2.9 * fwd["conv"] < step["conv"] < 3 * fwd["conv"]


def test_flagship_forward_count_is_healthz_figure_plus_the_rest():
    with open(harness.HERE / "configs" / "dbsr_lite.json") as f:
        net = json.load(f)["net"]
    parts = yardstick.model_macs(net, 8, 14, (48, 48), training=False)
    # /healthz's flops_per_batch, the convs alone (PR 16): 1.703e12
    assert 2 * parts["conv"] == pytest.approx(1.703e12, rel=1e-3)


def _t(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


BF = torch.bfloat16
# (entry, arguments, the table's bound in ms, PERF.md's kernel table)
TABLE = [
    ("merge_forward", (_t(8, 14, 48, 48, 512), _t(8, 14, 48, 48, 512)), 0.327),
    ("merge_forward", (_t(8, 14, 48, 48, 512, dtype=BF),
               _t(8, 14, 48, 48, 512, dtype=BF)), 0.1634),
    ("warp_dfeat", (_t(112, 48, 48, 2), _t(112, 48, 48, 512)), 0.316),
    ("warp_dfeat", (_t(112, 48, 48, 2), _t(112, 48, 48, 512, dtype=BF)),
     0.1584),
    ("merge_backward", (_t(16, 8, 48, 48, 512), _t(16, 8, 48, 48, 512),
                        _t(16, 48, 48, 512)), 0.744),
    ("merge_backward", (_t(16, 8, 48, 48, 512, dtype=BF),
                        _t(16, 8, 48, 48, 512, dtype=BF),
                        _t(16, 48, 48, 512, dtype=BF)), 0.3719),
    ("affine_resample", (_t(16, 432, 432, 3), _t(16, 8, 2, 3), (96, 96), 4,
                         24), 0.015),
    ("conv3x3_s2d_forward", (_t(8, 192, 192, 128), _t(32, 32, 3, 3)), 0.132),
    ("conv3x3_s2d_forward", (_t(16, 192, 192, 128), _t(32, 32, 3, 3)), 0.264),
    ("conv3x3_s2d_forward", (_t(8, 192, 192, 128, dtype=BF),
                             _t(32, 32, 3, 3, dtype=BF)), 0.0451),
    ("conv3x3_s2d_forward", (_t(16, 192, 192, 128, dtype=BF),
                             _t(32, 32, 3, 3, dtype=BF)), 0.0901),
]
# the warp's and d_flow's rows sum the feature warp and AlignLite's two
# backwarps, the cost volume's rows AlignLite's three levels
WARPS = ((48, 512), (24, 48), (48, 24))
TABLE_WARPS = [("warp_forward", 104, torch.float32, 0.315),
               ("warp_forward", 104, BF, 0.1581),
               ("warp_dflow", 112, torch.float32, 0.341),
               ("warp_dflow", 112, BF, 0.1716)]
LEVELS = ((104, 12, 96), (104, 24, 48), (104, 48, 24))
TABLE_LEVELS = [("correlation_forward", torch.float32, 0.055),
                ("correlation_forward", BF, 0.0289)]
BWD_LEVELS = ((112, 12, 96), (112, 24, 48), (112, 48, 24))
TABLE_BWD = [("correlation_dfirst", torch.float32, 0.059),
             ("correlation_dsecond", torch.float32, 0.059),
             ("correlation_dfirst", BF, 0.0311)]

ENTRIES = {fn: bound for (_, fn), bound in yardstick.KERNEL_ENTRIES.items()}


def _close(ms, want):
    # the table keeps three or four significant digits
    assert ms == pytest.approx(want, rel=6e-3, abs=6e-4)


@pytest.mark.parametrize("entry,args,want", TABLE,
                         ids=[f"{e}-{i}" for i, (e, _, _) in
                              enumerate(TABLE)])
def test_kernel_bound_matches_the_table(entry, args, want):
    _close(1e3 * ENTRIES[entry](*args), want)


@pytest.mark.parametrize("entry,dtype,want", TABLE_LEVELS + TABLE_BWD)
def test_cost_volume_bounds_match_the_table(entry, dtype, want):
    levels = LEVELS if entry == "correlation_forward" else BWD_LEVELS
    total = 0.0
    for b, s, c in levels:
        a = _t(b, s, s, c, dtype=dtype)
        other = _t(b, s, s, 81, dtype=dtype) \
            if entry != "correlation_forward" else a
        total += ENTRIES[entry](a, other)
    _close(1e3 * total, want)


@pytest.mark.parametrize("entry,frames,dtype,want", TABLE_WARPS)
def test_warp_bounds_match_the_table(entry, frames, dtype, want):
    total = 0.0
    for s, c in WARPS:
        feat, flow = _t(frames, s, s, c, dtype=dtype), _t(frames, s, s, 2)
        args = (feat, flow) if entry == "warp_forward" else (feat, flow, feat)
        total += ENTRIES[entry](*args)
    _close(1e3 * total, want)


def test_every_entry_is_a_function_of_the_program():
    import importlib

    for mod, fn in yardstick.KERNEL_ENTRIES:
        assert callable(getattr(importlib.import_module(mod), fn))


def test_recording_bounds_wraps_and_restores_every_holder():
    from dbsr_tpu_torch.data import synthetic
    from dbsr_tpu_torch.ops import resample

    before = (resample.affine_resample, synthetic.affine_resample)
    seen = []
    with yardstick.recording_bounds(seen):
        assert resample.affine_resample is not before[0]
        assert synthetic.affine_resample is resample.affine_resample
        # the entry counts its launches through its module's name
        assert resample.affine_resample.launches == before[0].launches
        # a CPU call runs the plain version and records nothing
        resample.affine_resample(torch.rand(1, 8, 8, 3),
                                 torch.eye(3)[:2].expand(1, 2, 2, 3),
                                 (2, 2), 4, 0)
    assert seen == []
    assert (resample.affine_resample, synthetic.affine_resample) == before
