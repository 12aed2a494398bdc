"""The port's PWC-Net (``dbsr_tpu_torch/models/pwcnet.py``) and the banked
model that runs it, ``dbsr_campaign_r3d``, against the JAX package on the
CPU, float32: the transposed conv and its kernel's conversion, the
extractor, decoders 6 and 5, the core network, the wrapper, the burst
wrapper from the banked ``pwcnet_synth_params.ckpt``, r3d at full width and
its predictor.

Inputs are made from a numpy seed. Random parameters are the port's seeded
init (``init_params``) carried to the JAX package by ``params_to_flax``, so
every parity test with them also holds the converter's transposed-conv rule
by value. On the CPU the JAX package runs its XLA formulations (the
shifted-window cost volume, the gather ``backwarp``) and the port its plain
PyTorch versions.

Tolerances: raw flows and features atol 1e-5 (float32 sums in another
order); flows in pixels after the x20 atol 1e-4; r3d's output 2e-4, as the
flagship's test (``tests/test_torch_port_models.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbsr_tpu.models import pwcnet as jpwc
from dbsr_tpu.models.layers import TorchConvTranspose as JaxConvTranspose
from dbsr_tpu.training.checkpoint import load_network as jax_load_network
from dbsr_tpu_torch.data.procedural import make_generator
from dbsr_tpu_torch.models import pwcnet
from dbsr_tpu_torch.models.dbsr import DBSRNet
from dbsr_tpu_torch.models.layers import TorchConvTranspose, init_params
from dbsr_tpu_torch.serving import load_predictor
from dbsr_tpu_torch.training.checkpoint import load_network, read_checkpoint
from dbsr_tpu_torch.utils.convert import params_from_flax, params_to_flax

PWC_SYNTH = "dbsr_tpu/artifacts/pwcnet_synth_params.ckpt"
R3D = "dbsr_tpu/artifacts/campaigns/dbsr_campaign_r3d_best_params.ckpt"
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this module runs (the suite runs
    in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).rand(*shape)).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=msg)


def _seeded(module, seed):
    """``(module, flax params)``: the port's seeded init and its flax tree."""
    init_params(module, make_generator("cpu", seed))
    return module.eval(), params_to_flax(module.state_dict())


@pytest.fixture(scope="module")
def flownet():
    """A seeded ``PWCFlowNet`` and its flax parameters."""
    return _seeded(pwcnet.PWCFlowNet(), 3)


@pytest.fixture(scope="module")
def banked():
    """The banked pretrained ``BurstFlowNet`` tree (``alignment_net``)."""
    _, tree = read_checkpoint(PWC_SYNTH)
    return tree["params"]["params"]


# ---------------------------------------------------------------------------
# the transposed conv and its kernel's conversion


@pytest.mark.parametrize("cin,cout,hw", [(2, 2, (3, 5)), (7, 2, (4, 4)),
                                         (5, 3, (1, 1))])
def test_torch_conv_transpose_matches_jax_and_torch(cin, cout, hw):
    """The port's NHWC module against the JAX package's (its kernel through
    the converter, under the name ``upflow`` that selects the transposed
    rule) and against ``nn.ConvTranspose2d`` on the NCHW view."""
    m = TorchConvTranspose(cin, cout)
    init_params(m, make_generator("cpu", 10 + cin))
    tree = params_to_flax({f"upflow.{k}": v
                           for k, v in m.state_dict().items()})["upflow"]
    x = _rand((2,) + hw + (cin,), cin, 2.0) - 1.0
    want = JaxConvTranspose(cout).apply({"params": tree}, jnp.asarray(x))
    with torch.no_grad():
        got = m(_t(x))
        ref = torch.nn.functional.conv_transpose2d(
            _t(x).permute(0, 3, 1, 2), m.weight, m.bias, stride=2,
            padding=1).permute(0, 2, 3, 1)
    assert got.shape == (2, 2 * hw[0], 2 * hw[1], cout)
    _close(got, want, 1e-6)
    _close(got, ref, 0.0)


def test_torch_conv_transpose_init_bounds():
    """Weight and bias uniform within +-1/sqrt(out*k*k), as the JAX module
    draws them, and spread over that range."""
    m = TorchConvTranspose(40, 8)
    init_params(m, make_generator("cpu", 0))
    bound = 1.0 / np.sqrt(8 * 16)
    for p in (m.weight, m.bias):
        a = p.detach().abs()
        assert a.max() <= bound and a.max() > 0.8 * bound


def test_upflow_kernel_converts_by_value_both_ways():
    """``upflow`` maps 2 channels to 2: its kernel has the same shape in the
    two layouts, so only values tell the rule apart. Every entry lands where
    ``W[in, out, kh, kw] = K[kh, kw, in, out]`` says, the same array under a
    conv's name takes the conv rule ``W[out, in, kh, kw]``, and both go
    back unchanged."""
    k = np.arange(64, dtype=np.float32).reshape(4, 4, 2, 2)
    tree = {"dec5": {"upflow": {"kernel": k, "bias": np.ones(2, np.float32)},
                     "dense0": {"Conv_0": {"kernel": k,
                                           "bias": np.ones(2, np.float32)}}}}
    sd = params_from_flax(tree)
    up = sd["dec5.upflow.weight"].numpy()
    conv = sd["dec5.dense0.Conv_0.weight"].numpy()
    assert up.shape == conv.shape == (2, 2, 4, 4)
    for kh, kw, i, o in np.ndindex(k.shape):
        assert up[i, o, kh, kw] == k[kh, kw, i, o]
        assert conv[o, i, kh, kw] == k[kh, kw, i, o]
    assert not np.array_equal(up, conv)
    back = params_to_flax(sd)
    np.testing.assert_array_equal(back["dec5"]["upflow"]["kernel"], k)
    np.testing.assert_array_equal(back["dec5"]["dense0"]["Conv_0"]["kernel"],
                                  k)


def test_converter_round_trip_on_the_pwc_tree(banked):
    """Every tensor of the banked tree through ``params_from_flax`` and back
    is unchanged, and loads strictly into the port's ``BurstFlowNet``."""
    sd = params_from_flax(banked)
    pwcnet.BurstFlowNet().load_state_dict(sd, strict=True)
    assert sd["alignment_net.net.dec4.upfeat.weight"].shape == (661, 2, 4, 4)
    back = jax.tree_util.tree_leaves_with_path(params_to_flax(sd))
    want = dict(jax.tree_util.tree_leaves_with_path(banked))
    assert len(back) == len(want)
    for path, a in back:
        np.testing.assert_array_equal(a, want[path], err_msg=str(path))


def test_channel_counts_match_the_banked_tree(banked):
    """The input channels torch needs, derived from the constants, against
    the banked kernels' shapes."""
    net = banked["alignment_net"]["net"]
    for lvl in pwcnet.LEVELS:
        dec = net[f"dec{lvl}"]
        assert dec["dense0"]["Conv_0"]["kernel"].shape[2] == \
            pwcnet.decoder_in_channels(lvl)
        assert dec["flow_head"]["Conv_0"]["kernel"].shape[2] == \
            pwcnet.decoder_feat_channels(lvl)
        if lvl < 6:
            assert dec["upfeat"]["kernel"].shape[2] == \
                pwcnet.decoder_feat_channels(lvl + 1)
    assert [pwcnet.decoder_in_channels(l) for l in pwcnet.LEVELS] == \
        [81, 213, 181, 149, 117]
    assert net["refiner"]["ctx0"]["Conv_0"]["kernel"].shape[2] == 565


# ---------------------------------------------------------------------------
# the network's parts and the whole


def test_extractor_pyramid_matches_jax(flownet):
    net, tree = flownet
    x = _rand((2, 64, 128, 3), 20)
    want = jpwc.Extractor().apply({"params": tree["extractor"]},
                                  jnp.asarray(x))
    with torch.no_grad():
        got = net.extractor(_t(x))
    assert [tuple(f.shape) for f in got] == [
        (2, 64 >> l, 128 >> l, c)
        for l, c in zip(range(1, 7), pwcnet.PYRAMID_CH)]
    for lvl, (g, w) in enumerate(zip(got, want), start=1):
        _close(g, w, msg=f"level {lvl}")


def test_decoders_6_and_5_match_jax(flownet):
    """Level 6 (the cost volume of 1x1 planes, 80 of 81 taps outside) and
    level 5 (the up-convs, a backwarp of a 2x2 plane by the flow x0.625)."""
    net, tree = flownet
    f1 = [_rand((3, s, s, c), 30 + s, 2.0) - 1.0
          for s, c in ((1, 196), (2, 128))]
    f2 = [_rand((3, s, s, c), 40 + s, 2.0) - 1.0
          for s, c in ((1, 196), (2, 128))]
    want6 = jpwc.Decoder(6).apply({"params": tree["dec6"]},
                                  jnp.asarray(f1[0]), jnp.asarray(f2[0]), None)
    with torch.no_grad():
        got6 = net.dec6(_t(f1[0]), _t(f2[0]), None)
    for k in ("flow", "feat"):
        _close(got6[k], want6[k], msg=k)
    prev = {k: np.asarray(v) for k, v in want6.items()}
    # a larger flow than the random net's, so that taps leave the plane
    prev["flow"] = prev["flow"] * 8.0
    want5 = jpwc.Decoder(5).apply(
        {"params": tree["dec5"]}, jnp.asarray(f1[1]), jnp.asarray(f2[1]),
        {k: jnp.asarray(v) for k, v in prev.items()})
    with torch.no_grad():
        got5 = net.dec5(_t(f1[1]), _t(f2[1]),
                        {k: _t(v) for k, v in prev.items()})
    assert got5["feat"].shape == (3, 2, 2, 661)
    for k in ("flow", "feat"):
        _close(got5[k], want5[k], msg=k)


@pytest.mark.parametrize("params", ["random", "banked"])
def test_pwcflownet_matches_jax(params, flownet, banked):
    """Raw level-2 flows and the whole pyramid, with the first image's
    pyramid repeated (``first_repeat``)."""
    net, tree = flownet
    if params == "banked":
        tree = banked["alignment_net"]["net"]
        net = pwcnet.PWCFlowNet().eval()
        net.load_state_dict(params_from_flax(tree), strict=True)
    first = _rand((1, 64, 64, 3), 50)
    second = _rand((2, 64, 64, 3), 51)
    flow, pyr = jax.jit(lambda p, a, b: jpwc.PWCFlowNet().apply(
        {"params": p}, a, b, return_pyramid=True, first_repeat=2))(
            tree, jnp.asarray(first), jnp.asarray(second))
    with torch.no_grad():
        got, got_pyr = net(_t(first), _t(second), return_pyramid=True,
                           first_repeat=2)
    assert got.shape == (2, 16, 16, 2)
    _close(got, flow)
    assert list(got_pyr) == [6, 5, 4, 3, 2] and set(pyr) == set(got_pyr)
    for lvl in got_pyr:
        _close(got_pyr[lvl], pyr[lvl], msg=f"level {lvl}")


@pytest.mark.parametrize("hw", [(48, 48), (40, 72)])
def test_pwcnet_matches_jax(hw, flownet):
    """The wrapper at the serving size (resized to 64x64) and at a
    non-square size that is no multiple of 64 (resized to 64x128): flows in
    input pixels, the raw pyramid and ``preprocessed_hw``."""
    _, tree = flownet
    m = pwcnet.PWCNet().eval()
    m.net.load_state_dict(params_from_flax(tree), strict=True)
    src = _rand((2,) + hw + (3,), 60)
    tgt = _rand((2,) + hw + (3,), 61)
    flow, aux = jax.jit(lambda p, a, b: jpwc.PWCNet().apply(
        {"params": {"net": p}}, a, b, return_pyramid=True))(
            tree, jnp.asarray(src), jnp.asarray(tgt))
    with torch.no_grad():
        got, got_aux = m(_t(src), _t(tgt), return_pyramid=True)
    assert got.shape == (2,) + hw + (2,)
    _close(got, flow, 1e-4)
    assert got_aux["preprocessed_hw"] == tuple(aux["preprocessed_hw"])
    for lvl in got_aux["pyramid"]:
        _close(got_aux["pyramid"][lvl], aux["pyramid"][lvl])


def test_target_repeat_equals_broadcasting(flownet):
    """N-1 sources against one target each: the repeated target pyramid
    gives the flows of the explicitly broadcast targets."""
    _, tree = flownet
    m = pwcnet.PWCNet().eval()
    m.net.load_state_dict(params_from_flax(tree), strict=True)
    src = _t(_rand((6, 48, 48, 3), 70))
    tgt = _t(_rand((2, 48, 48, 3), 71))
    with torch.no_grad():
        once = m(src, tgt, target_repeat=3)
        each = m(src, tgt.repeat_interleave(3, dim=0))
    _close(once, each, 1e-6)
    with pytest.raises(ValueError, match="target_repeat 2"):
        m(src, tgt, target_repeat=2)


def test_burst_flow_net_banked_matches_jax():
    """The banked pretrained aligner through ``load_network`` in both
    packages: flows in packed-grid pixels within 1e-4."""
    net, header = load_network(PWC_SYNTH, device="cpu")
    assert isinstance(net, pwcnet.BurstFlowNet)
    assert header["net_name"] == "pwcnet_synth" and header["epoch"] == 15
    jnet, jparams, _ = jax_load_network(PWC_SYNTH)
    burst = _rand((2, 4, 24, 24, 4), 80)
    want = jax.jit(jnet.apply)(jparams, jnp.asarray(burst))
    with torch.no_grad():
        got = net(_t(burst))
    assert got.shape == (2, 3, 24, 24, 2)
    _close(got, want, 1e-4)


# ---------------------------------------------------------------------------
# r3d: the banked model with the PWC-Net aligner


def test_r3d_full_width_matches_jax():
    """r3d's parameters at full width, both in float32 with r3d's s2d
    decoder; output 2e-4 (observed ~9e-6), offsets 1e-4 px."""
    x = _rand((1, 3, 8, 8, 4), 90)
    jnet, jparams, _ = jax_load_network(R3D, dtype=None)
    want, waux = jax.jit(jnet.apply)(jparams, jnp.asarray(x))
    net, header = load_network(R3D, device="cpu", dtype=None)
    assert isinstance(net.encoder.alignment_net, pwcnet.PWCNet)
    assert net.decoder.s2d and header["epoch"] == 100
    with torch.no_grad():
        got, aux = net(_t(x))
    diff = np.abs(got.numpy() - np.asarray(want))
    assert diff.max() <= 2e-4, (diff.max(), int((diff > 2e-4).sum()))
    _close(aux["offsets"], waux["offsets"], 1e-4)


def test_load_predictor_serves_r3d_on_the_cpu():
    """``load_predictor`` rebuilds r3d from its header (PWC-Net, the s2d
    decoder), in bf16 by default, and serves a partial batch, padded and
    clipped."""
    pred = load_predictor(R3D, batch_size=2, burst_size=3, burst_hw=(8, 8),
                          device="cpu")
    assert isinstance(pred.net, DBSRNet) and pred.net.decoder.s2d
    assert isinstance(pred.net.encoder.alignment_net, pwcnet.PWCNet)
    bursts = _rand((2, 3, 8, 8, 4), 91)
    full = pred(bursts)
    assert full.shape == (2, 64, 64, 3) and np.isfinite(full).all()
    assert full.min() >= 0.0 and full.max() <= 1.0
    np.testing.assert_allclose(pred(bursts[:1]), full[:1], atol=1e-6)
