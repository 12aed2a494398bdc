"""The port's bfloat16 compute dtype against the JAX package's on the CPU,
inputs made from a seed with numpy and the same parameters on both sides.

* The four ops on the serving path, their plain bf16 versions against the
  Pallas bodies run in interpret mode at bf16 (the warp, the cost volume,
  the merge, the fine-patch conv): at least 99.9% of the elements bit-equal
  and none more than one bf16 ulp away. The ulp is bf16's spacing at the
  element's magnitude, floored at 2^-8 of the magnitude of its terms (the
  same op on the inputs' absolute values): below that, cancellation leaves
  the last bits to the float32 sum's rounding, which XLA's order of
  summation and the port's set differently.
* The modules at small widths, the port at bf16 against the JAX package at
  bf16 (the JAX package's CPU path: XLA's warp, cost volume and merge):
  relative L2 within 2e-2 (``util_scripts/tpu_parity_check.py``'s bf16
  limit), and the port no farther from JAX's float32 output than twice
  JAX bf16's own distance to it.
* Flax's bias: a bf16 conv's bias added to the rounded conv, bit-equal
  to JAX's ``ConvBlock`` and ``TorchConvTranspose``.
* What stays float32 under bf16: the offsets through their modulo, the
  backwarp's mask; the banked checkpoints' parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dbsr_tpu.models import dbsr as jdbsr
from dbsr_tpu.models import layers as jlayers
from dbsr_tpu.ops.conv_s2d_pallas import _conv3x3_block_impl
from dbsr_tpu.ops.conv_s2d_pallas import block_weight as jax_block_weight
from dbsr_tpu.ops.correlation import _correlation_pallas_fwd_impl
from dbsr_tpu.ops.merge_pallas import _merge_fwd_impl
from dbsr_tpu.ops.warp_pallas import _warp_pallas_impl
from dbsr_tpu.training.checkpoint import load_network as jax_load_network
from dbsr_tpu_torch.models import dbsr, layers
from dbsr_tpu_torch.models.layers import compute_dtype_of, set_compute_dtype
from dbsr_tpu_torch.ops import correlation, merge, warp
from dbsr_tpu_torch.ops.conv_s2d import FINE_PATCH_ENV, conv3x3_s2d_plain
from dbsr_tpu_torch.ops.interp import backwarp
from dbsr_tpu_torch.training.checkpoint import load_network, read_checkpoint
from dbsr_tpu_torch.utils.convert import params_from_flax

BF = torch.bfloat16
ALIGN_LITE = "dbsr_tpu/artifacts/align_lite_params.ckpt"
PWC_SYNTH = "dbsr_tpu/artifacts/pwcnet_synth_params.ckpt"
BANKED = ["dbsr_tpu/artifacts/campaigns/dbsr_campaign_r5_best_params.ckpt",
          "dbsr_tpu/artifacts/campaigns/dbsr_campaign_r4mix_best_params.ckpt",
          "dbsr_tpu/artifacts/campaigns/dbsr_campaign_r3d_best_params.ckpt"]
REL_L2 = 2e-2       # util_scripts/tpu_parity_check.py:259-270, bf16
BIT_EQUAL = 0.999   # share of an op's elements bit-equal to the Pallas body
MAX_ULPS = 1.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this module runs (the suite runs
    in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _tb(a):
    """numpy float32 -> the port's bf16 (round to nearest even)."""
    return torch.from_numpy(np.array(a, np.float32)).to(BF)


def _jb(a):
    """numpy float32 -> JAX bf16 (the same rounding)."""
    return jnp.asarray(np.array(a, np.float32)).astype(jnp.bfloat16)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _ulps(got, want, scale):
    """|got - want| in bf16 ulps at max(|want|, 2^-8 scale)."""
    mag = np.maximum(np.abs(want), np.abs(scale) * 2.0 ** -8)
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    return np.abs(got - want) / ulp


def _check_bits(got, want, scale):
    got, want, scale = _np(got), _np(want), _np(scale)
    assert got.shape == want.shape
    equal = float((got == want).mean())
    worst = float(_ulps(got, want, scale).max())
    assert equal >= BIT_EQUAL and worst <= MAX_ULPS, (equal, worst)


def _rel(a, b):
    a, b = np.asarray(_np(a), np.float64), np.asarray(_np(b), np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _check_bf16(got, want_bf16, want_f32, limit=REL_L2):
    """The port at bf16 against JAX at bf16 (within ``limit``; None: twice
    JAX bf16's distance to JAX float32) and, against JAX at float32, within
    twice JAX bf16's own distance."""
    rel = _rel(got, want_bf16)
    port, ref = _rel(got, want_f32), _rel(want_bf16, want_f32)
    limit = 2 * ref if limit is None else limit
    assert rel <= limit and port <= 2 * ref, (rel, port, ref)


# ---------------------------------------------------------------------------
# the four ops' plain bf16 versions against the Pallas bodies


@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (3, 6, 10, 24),
                                   (2, 8, 8, 5)])
def test_warp_plain_bf16_matches_pallas_interpret(shape):
    feat = _rand(shape, 0)
    flow = _rand(shape[:3] + (2,), 1, 2.5)
    want = _warp_pallas_impl(_jb(feat), jnp.asarray(flow), interpret=True)
    got = warp.warp_feat_plain(_tb(feat), torch.from_numpy(flow))
    assert got.dtype == BF
    scale = warp.warp_feat_plain(_tb(feat).float().abs(),
                                 torch.from_numpy(flow))
    _check_bits(got, want, scale)


@pytest.mark.parametrize("shape", [(2, 8, 8, 24), (2, 6, 6, 96),
                                   (1, 4, 5, 48)])
def test_correlation_plain_bf16_matches_pallas_interpret(shape):
    first, second = _rand(shape, 2), _rand(shape, 3)
    want = _correlation_pallas_fwd_impl(_jb(first), _jb(second),
                                        interpret=True)
    got = correlation.correlation_plain(_tb(first), _tb(second))
    assert got.dtype == BF
    scale = correlation.correlation_plain(_tb(first).float().abs(),
                                          _tb(second).float().abs())
    _check_bits(got, want, scale)


@pytest.mark.parametrize("shape", [(2, 5, 16, 8, 64), (1, 14, 8, 16, 128)])
def test_merge_plain_bf16_matches_pallas_interpret(shape):
    feat, logits = _rand(shape, 4), _rand(shape, 5, 3.0)
    want = _merge_fwd_impl(_jb(feat), _jb(logits), interpret=True)
    got = merge.fused_softmax_merge_plain(_tb(feat), _tb(logits))
    assert got.dtype == BF
    scale = merge.fused_softmax_merge_plain(_tb(feat).float().abs(),
                                            _tb(logits))
    _check_bits(got, want, scale)


@pytest.mark.parametrize("shape,O", [((2, 16, 16, 128), 32),
                                     ((2, 6, 10, 64), 24)])
def test_conv_s2d_plain_bf16_matches_pallas_interpret(shape, O):
    x = _rand(shape, 6)
    k = _rand((3, 3, shape[-1] // 4, O), 7, 0.1)  # HWIO
    want = _conv3x3_block_impl(
        _jb(x), jax_block_weight(jnp.asarray(k)).astype(jnp.bfloat16),
        interpret=True)
    w = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())  # OIHW
    got = conv3x3_s2d_plain(_tb(x), w)
    assert got.dtype == BF
    scale = conv3x3_s2d_plain(_tb(x).float().abs(), w.to(BF).float().abs())
    _check_bits(got, want, scale)


def test_kernel_wrappers_raise_for_a_type_without_a_kernel():
    """A tensor off the CPU of a type no kernel instantiates raises; no
    plain fallback."""
    meta = dict(device="meta")
    with pytest.raises(TypeError, match="float16"):
        warp.warp_forward(torch.empty(1, 4, 4, 8, dtype=torch.float16,
                                      **meta), torch.empty(1, 4, 4, 2, **meta))
    with pytest.raises(TypeError, match="float16"):
        correlation.correlation_forward(
            *[torch.empty(1, 4, 4, 8, dtype=torch.float16, **meta)] * 2)
    with pytest.raises(TypeError, match="float64"):
        merge.merge_forward(
            *[torch.empty(1, 2, 4, 4, 8, dtype=torch.float64, **meta)] * 2)


# ---------------------------------------------------------------------------
# flax's bias: added in bf16 to the conv's rounded output


def _bit_equal_share(a, b):
    return float((_np(a) == _np(b)).mean())


@pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (3, 2)])
def test_conv_block_bf16_adds_the_bias_after_the_rounding_as_jax(k, stride):
    """A bf16 ``ConvBlock`` rounds the conv's sum, then adds the bias in
    bf16, as flax's ``nn.Conv`` does: bit-equal to JAX's. The bias handed
    to the conv (oneDNN adds it before the one rounding) leaves a quarter
    of the outputs off by an ulp."""
    x = _rand((2, 8, 8, 16), 20)
    make = lambda dt: jlayers.ConvBlock(  # noqa: E731
        features=24, kernel_size=k, stride=stride, dtype=dt,
        activation="none")
    params = _random_params(jax.eval_shape(
        make(None).init, jax.random.key(0), _jb(x)), 21)
    want = jax.jit(make(jnp.bfloat16).apply)(params, _jb(x))
    m = layers.ConvBlock(16, 24, k, stride=stride, activation="none")
    m.load_state_dict(params_from_flax(params), strict=True)
    set_compute_dtype(m, "bfloat16")
    c = m.Conv_0
    with torch.no_grad():
        got = m(_tb(x))
        fused = F.conv2d(_tb(x).permute(0, 3, 1, 2), c.weight.to(BF),
                         c.bias.to(BF), c.stride, c.padding
                         ).permute(0, 2, 3, 1)
    assert got.dtype == BF
    assert _bit_equal_share(got, want) >= BIT_EQUAL
    assert _bit_equal_share(fused, want) < 0.9


def test_conv_transpose_bf16_adds_the_bias_after_the_rounding_as_jax():
    """PWC-Net's transposed conv in bf16, likewise: bit-equal to JAX's."""
    x = _rand((2, 6, 6, 8), 22)
    jm = jlayers.TorchConvTranspose(features=2)
    params = _random_params(jax.eval_shape(
        jm.init, jax.random.key(0), _jb(x)), 23)
    want = jax.jit(jm.apply)(params, _jb(x))
    m = layers.TorchConvTranspose(8, 2)
    p = params["params"]
    m.load_state_dict({"weight": torch.from_numpy(
        np.asarray(p["kernel"]).transpose(2, 3, 0, 1).copy()),
        "bias": torch.from_numpy(np.asarray(p["bias"]))})
    with torch.no_grad():
        got = m(_tb(x))
    assert got.dtype == BF and got.shape == (2, 12, 12, 2)
    assert _bit_equal_share(got, want) >= BIT_EQUAL


# ---------------------------------------------------------------------------
# the modules at small widths, port bf16 against JAX bf16


def _random_params(shapes, seed):
    """A flax tree of ``shapes`` filled with U[-1/sqrt(fan_in), +] draws."""
    rng = np.random.RandomState(seed)

    def fill(node):
        out = {}
        kernel = node.get("kernel")
        fan_in = (np.prod(kernel.shape[:-1]) if kernel is not None
                  else None)
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            else:
                b = 1.0 / np.sqrt(fan_in)
                out[k] = rng.uniform(-b, b, v.shape).astype(np.float32)
        return out

    return fill(shapes)


def _jax_pair(make, params, *args):
    """The JAX module's outputs at bf16 and at float32."""
    return [jax.jit(make(dt).apply)(params, *args)
            for dt in (jnp.bfloat16, None)]


@pytest.mark.parametrize("ckpt", [ALIGN_LITE, PWC_SYNTH])
def test_banked_aligners_bf16_match_jax(ckpt):
    """AlignLite and PWC-Net, the banked aligners, at bf16: flows (float32)
    in packed-grid pixels."""
    burst = np.random.RandomState(8).rand(2, 4, 24, 24, 4).astype(np.float32)
    net, _ = load_network(ckpt, device="cpu", dtype="bfloat16")
    assert compute_dtype_of(net) == BF
    with torch.no_grad():
        got = net(torch.from_numpy(burst))
    assert got.dtype == torch.float32
    want = []
    for dt in (jnp.bfloat16, None):
        jnet, jparams, _ = jax_load_network(ckpt, dtype=dt)
        want.append(jax.jit(jnet.apply)(jparams, jnp.asarray(burst)))
    _check_bf16(got, *want)


TINY_MERGE = dict(input_dim=16, project_dim=4, offset_feat_dim=4,
                  num_weight_predictor_res=1)


def _merge_inputs(seed, B=2, N=3, hw=(8, 8), C=16):
    feat = _rand((B, N) + hw + (C,), seed)
    offsets = _rand((B, N - 1) + hw + (2,), seed + 1, 3.0)
    return feat, offsets


def _merge_bf16_vs_jax(softmax, logit_bias):
    """The tiny merge's bf16 output, the port's and JAX's at bf16 and at
    float32, the same random parameters with ``logit_bias`` added to the
    logits' bias."""
    feat, offsets = _merge_inputs(10)
    jin = {"ref_feat": _jb(feat[:, :1]), "oth_feat": _jb(feat[:, 1:]),
           "offsets": jnp.asarray(offsets)}
    make = lambda dt: jdbsr.WeightedSumMerge(  # noqa: E731
        softmax=softmax, dtype=dt, **TINY_MERGE)
    params = _random_params(jax.eval_shape(
        make(None).init, jax.random.key(0), jin), 11)
    out = params["params"]["weight_out"]["Conv_0"]
    out["bias"] = out["bias"] + np.float32(logit_bias)
    want = [o["fused_enc"] for o in _jax_pair(make, params, jin)]
    m = dbsr.WeightedSumMerge(16, 4, 4, 1, 1, softmax=softmax)
    m.load_state_dict(params_from_flax(params), strict=True)
    set_compute_dtype(m.eval(), "bfloat16")
    with torch.no_grad():
        got = m({"ref_feat": _tb(feat[:, :1]), "oth_feat": _tb(feat[:, 1:]),
                 "offsets": torch.from_numpy(offsets)})["fused_enc"]
    assert got.dtype == BF
    return got, want


@pytest.mark.parametrize("softmax", [True, False])
def test_weighted_sum_merge_bf16_matches_jax(softmax):
    """The merge with its softmax and with ReLU weights (``softmax=False``),
    the logits' bias raised by 1 so that the ReLU weights' sum over the
    frames stays away from 0 (a sum near 0 amplifies every rounding before
    the normalisation; see the next test)."""
    got, want = _merge_bf16_vs_jax(softmax, 1.0)
    _check_bf16(got, *want)


def test_relu_weight_merge_near_a_zero_sum_bf16_matches_jax():
    """ReLU weights at the random parameters as drawn: their sum over the
    frames comes near 0 and the normalisation amplifies the roundings
    before it, so that JAX bf16 sits 8.4e-2 from JAX float32 (observed);
    the port stays within REL_L2 of JAX bf16 all the same."""
    got, (bf16, f32) = _merge_bf16_vs_jax(False, 0.0)
    assert _rel(bf16, f32) > 2 * REL_L2  # the ill-conditioned case
    _check_bf16(got, bf16, f32)


@pytest.mark.parametrize("form", ["fine", "s2d_dense", "s2d_kernel"])
def test_decoder_bf16_matches_jax(form, monkeypatch):
    monkeypatch.setenv(FINE_PATCH_ENV, "1" if form == "s2d_kernel" else "0")
    x = _rand((2, 6, 6, 16), 12)
    kw = dict(init_conv_dim=8, num_pre_res_blocks=1, post_conv_dim=8,
              num_post_res_blocks=1, upsample_factor=8)
    s2d = form != "fine"
    make = lambda dt: jdbsr.PixShuffleDecoder(  # noqa: E731
        dtype=dt, fused_s2d=s2d, **kw)
    params = _random_params(jax.eval_shape(
        make(None).init, jax.random.key(0), _jb(x)), 13)
    want = _jax_pair(make, params, _jb(x))
    m = dbsr.PixShuffleDecoder(16, fused_s2d=s2d, **kw)
    m.load_state_dict(params_from_flax(params), strict=True)
    set_compute_dtype(m.eval(), "bfloat16")
    with torch.no_grad():
        got = m(_tb(x))
    assert got.dtype == BF and got.shape == (2, 48, 48, 3)
    _check_bf16(got, *want)


@pytest.fixture(scope="module")
def tiny_problem():
    burst = np.random.RandomState(14).rand(2, 3, 16, 16, 4).astype(np.float32)
    jnet = jdbsr.dbsrnet_tiny(flow_net="lite")
    params = _random_params(jax.eval_shape(
        jnet.init, jax.random.key(0), jnp.asarray(burst)), 15)
    return burst, params


@pytest.mark.parametrize("form", ["fine", "s2d_dense", "s2d_kernel"])
def test_dbsrnet_tiny_bf16_matches_jax(form, tiny_problem, monkeypatch):
    """The whole network in each decoder form: the prediction (float32)
    and the offsets (float32, the aligner's flow)."""
    monkeypatch.setenv(FINE_PATCH_ENV, "1" if form == "s2d_kernel" else "0")
    burst, params = tiny_problem
    s2d = form != "fine"
    outs = []
    for dt in (jnp.bfloat16, None):
        jnet = jdbsr.dbsrnet_tiny(flow_net="lite", dtype=dt,
                                  fused_s2d_decoder=s2d)
        outs.append(jax.jit(jnet.apply)(params, jnp.asarray(burst)))
    net = dbsr.dbsrnet_tiny(dtype="bfloat16", fused_s2d_decoder=s2d)
    net.load_state_dict(params_from_flax(params), strict=True)
    with torch.no_grad():
        got, aux = net.eval()(torch.from_numpy(burst))
    assert got.dtype == aux["offsets"].dtype == torch.float32
    _check_bf16(got, outs[0][0], outs[1][0])
    _check_bf16(aux["offsets"], outs[0][1]["offsets"],
                outs[1][1]["offsets"])


# ---------------------------------------------------------------------------
# what stays float32


def test_offsets_reach_offset_conv_in_float32_mod_1():
    """The merge takes the offsets mod 1 px in float32 and hands them to
    ``offset_conv`` so, which casts them to bf16 only then: a bf16 modulo
    of a several-pixel offset would keep 1/32 px of it."""
    net = dbsr.dbsrnet_tiny(dtype="bfloat16").eval()
    seen = []
    net.merging.offset_conv.register_forward_pre_hook(
        lambda m, args: seen.append(args[0]))
    burst = torch.from_numpy(np.random.RandomState(16).rand(
        1, 3, 16, 16, 4).astype(np.float32))
    with torch.no_grad():
        _, aux = net(burst)
    offs = torch.cat([torch.zeros_like(aux["offsets"][:, :1]),
                      aux["offsets"]], dim=1).reshape(-1, 16, 16, 2)
    (got,) = seen
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.remainder(offs, 1.0))
    # a bf16 modulo would not be the same: 5.3 px -> 0.3125, not 0.3
    big = torch.tensor([5.3])
    assert torch.remainder(big.to(BF), 1.0).item() == 0.3125
    assert abs(torch.remainder(big, 1.0).item() - 0.3) < 1e-6


def test_backwarp_keeps_the_float32_mask_in_bf16():
    """The validity mask of a bf16 backwarp is the analytic float32 one: a
    pixel whose four taps lie inside is kept, where warping a bf16 ones
    image would give 0.9961 < 0.999 and zero it."""
    H = W = 8
    ones = torch.ones(1, H, W, 4, dtype=BF)
    # sampled at x + 0.06, y + 0.3 (the flow scaled by S/(S-1)): tap
    # weights whose bf16 roundings sum to 0.9974, 0.9961 once rounded
    flow = torch.tensor([0.06 * (W - 1) / W, 0.3 * (H - 1) / H]).expand(
        1, H, W, 2).contiguous()
    out = backwarp(ones, flow)
    assert out.dtype == BF
    inside = out[0, :H - 1, :W - 1, 0].float()
    assert (inside > 0.99).all()
    f = torch.stack([flow[..., 0] * W / (W - 1), flow[..., 1] * H / (H - 1)],
                    dim=-1)
    warped_ones = warp.warp_feat_plain(ones, f)[0, :H - 1, :W - 1, 0]
    assert (warped_ones.float() < 0.999).all()


@pytest.mark.parametrize("ckpt", BANKED)
def test_banked_checkpoints_keep_float32_params_in_a_bf16_net(ckpt):
    """The banked models record bf16 and hold float32 parameters (flax's
    params of a bf16 net): ``load_network`` builds the bf16 net and carries
    every parameter across unchanged, in float32."""
    header, tree = read_checkpoint(ckpt)
    assert header["net_spec"]["kwargs"]["dtype"] == {"__dtype__": "bfloat16"}
    want = params_from_flax(tree["params"] if "params" in tree else tree)
    net, _ = load_network(ckpt, device="cpu")
    assert compute_dtype_of(net) == BF
    got = net.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert v.dtype == got[k].dtype == torch.float32, k
        assert torch.equal(got[k], v), k
