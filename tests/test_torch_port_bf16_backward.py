"""The port's plain bf16 backwards against the Pallas backward bodies run in
interpret mode at bf16 on the CPU, inputs made from a seed with numpy.

* The warp's d_feat (``_warp_bwd_pallas``), the merge's backward
  (``_merge_bwd_impl``), the cost volume's d_first and d_second
  (``_correlation_pallas_bwd_impl``) and the fine-patch conv's d_input
  (``_conv3x3_block_impl`` on ``block_weight(k_rot)`` rounded to bf16, as
  the JAX package's backward takes it), each a bf16 output: at least 99.9%
  of the elements bit-equal and none more than one bf16 ulp away, the ulp
  floored at 2^-8 of the magnitude of the element's terms (the same op on
  the inputs' absolute values), the limits of ``test_torch_port_bf16.py``.
* The warp's d_flow, a float32 output summed over the channels: within
  1e-5 of the magnitude of its terms (the sum of their absolute values),
  as the order of a float32 sum of up to 512 products moves it.
* The fine-patch conv's d_kernel, float32 on bf16-valued operands, against
  the JAX package's formula for it: within 1e-5 of the largest element
  (float32 sums of 2048 terms in another order).
* The plain d_feat in bf16 sums each input pixel's terms in ascending
  source order and rounds once: a pile-up of many sources on one pixel
  gives the float32 sum of the rounded weights' products, rounded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbsr_tpu.ops.conv_s2d_pallas import _conv3x3_block_impl, _unfold
from dbsr_tpu.ops.conv_s2d_pallas import block_weight as jax_block_weight
from dbsr_tpu.ops.correlation import _correlation_pallas_bwd_impl
from dbsr_tpu.ops.merge_pallas import _merge_bwd_impl
from dbsr_tpu.ops.warp_pallas import _warp_bwd_pallas
from dbsr_tpu_torch.ops import correlation, merge, warp
from dbsr_tpu_torch.ops.conv_s2d import conv3x3_s2d

BF = torch.bfloat16
BIT_EQUAL = 0.999   # share of an op's elements bit-equal to the Pallas body
MAX_ULPS = 1.0
DFLOW_RTOL = 1e-5   # of the magnitude of d_flow's terms


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
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _check_bits(got, want, scale):
    """At least BIT_EQUAL of ``got`` bit-equal to ``want`` (both bf16), none
    more than MAX_ULPS bf16 ulps away at max(|want|, 2^-8 |scale|)."""
    assert got.dtype == BF
    got, want, scale = _np(got), _np(want), _np(scale)
    assert got.shape == want.shape
    mag = np.maximum(np.abs(want), np.abs(scale) * 2.0 ** -8)
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    equal = float((got == want).mean())
    worst = float((np.abs(got - want) / ulp).max())
    assert equal >= BIT_EQUAL and worst <= MAX_ULPS, (equal, worst)


def _flow(shape, seed):
    """Flows up to +-5 px (taps out of range at the borders), a third of
    the rows on exact pixel centres (the one-sided derivative)."""
    f = np.random.RandomState(seed).uniform(-5, 5, shape).astype(np.float32)
    f[:, ::3] = np.round(f[:, ::3])
    return f


WARP_SHAPES = [(1, 8, 8, 512), (2, 8, 8, 48), (2, 6, 10, 24), (2, 5, 7, 5)]


@pytest.mark.parametrize("shape", WARP_SHAPES)
def test_warp_dfeat_plain_bf16_matches_pallas_interpret(shape):
    feat, g = _rand(shape, 0), _rand(shape, 1)
    flow = _flow(shape[:3] + (2,), 2)
    want, _ = _warp_bwd_pallas(_jb(feat), jnp.asarray(flow), _jb(g),
                               interpret=True)
    fl = torch.from_numpy(flow)
    got = warp.warp_dfeat_plain(fl, _tb(g))
    scale = warp.warp_dfeat_plain(fl, _tb(g).float().abs())
    _check_bits(got, want, scale)


@pytest.mark.parametrize("shape", WARP_SHAPES)
def test_warp_dflow_plain_bf16_matches_pallas_interpret(shape):
    feat, g = _rand(shape, 3), _rand(shape, 4)
    flow = _flow(shape[:3] + (2,), 5)
    _, want = _warp_bwd_pallas(_jb(feat), jnp.asarray(flow), _jb(g),
                               interpret=True)
    fl = torch.from_numpy(flow)
    got = warp.warp_dflow_plain(_tb(feat), fl, _tb(g))
    assert got.dtype == torch.float32
    # the terms' magnitude: sum_c |g| sum_tap (|dw/dx| + |dw/dy|) |feat|
    # (a derivative weight is nonzero where the tap's weight is 0)
    coords = warp.base_grid(*shape[1:3]) + fl
    flat = _tb(feat).float().abs().reshape(shape[0], -1, shape[3])
    terms = sum(warp._gather(flat, idx) * (dx.abs() + dy.abs())[..., None]
                for idx, _, dx, dy in warp._taps(coords, *shape[1:3]))
    terms = (terms * _tb(g).float().abs()).sum(-1, keepdim=True)
    assert (np.abs(_np(got) - _np(want)) <= DFLOW_RTOL * _np(terms)).all()


def test_warp_dflow_plain_rounds_the_derivative_weights_to_bf16():
    """At a fractional coordinate whose weight 1 - w is not a bf16 value,
    d_flow in bf16 takes the rounded weight, as the TPU kernel's bf16
    operator does; float32 keeps it."""
    feat = torch.zeros(1, 1, 3, 1)
    feat[0, 0, 1, 0] = 1.0  # the second tap along x
    flow = torch.zeros(1, 1, 3, 2)
    flow[0, 0, 0, 1] = 0.3  # pixel 0 sampled at (0, 0.3): dw01/dx = 1 - 0.3
    g = torch.zeros(1, 1, 3, 1)
    g[0, 0, 0, 0] = 1.0
    f32 = warp.warp_dflow_plain(feat, flow, g)[0, 0, 0, 0].item()
    bf = warp.warp_dflow_plain(feat.to(BF), flow, g.to(BF))[0, 0, 0, 0].item()
    w = 1 - np.float32(0.3)
    assert f32 == w
    assert bf == torch.tensor(w).to(BF).item() != w


def test_warp_dfeat_plain_bf16_sums_a_pile_up_once_in_source_order():
    """Every source of a 6x6 frame pulled onto one pixel's neighbourhood:
    d_feat there is the float32 sum, in ascending source order, of the
    bf16-rounded weights times g, rounded to bf16 once (a scatter-add in
    bf16 would round after every term)."""
    H = W = 6
    rng = np.random.RandomState(6)
    target = np.array([2.25, 3.5], np.float32)  # (x, y): 4 taps each
    base = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1)
    flow = (target - base).astype(np.float32)[None]
    g = rng.randn(1, H, W, 3).astype(np.float32)
    got = warp.warp_dfeat_plain(torch.from_numpy(flow), _tb(g))
    wx, wy = 0.25, 0.5
    acc = np.zeros(3, np.float32)
    gq = _np(_tb(g)).reshape(H * W, 3)
    w00 = np.float32(_np(torch.tensor((1 - wy) * (1 - wx)).to(BF)))
    for p in range(H * W):  # tap 00 of every source lands on (3, 2)
        acc = (acc + w00 * gq[p]).astype(np.float32)
    assert np.array_equal(_np(got)[0, 3, 2], _np(_tb(acc)))


@pytest.mark.parametrize("shape", [(2, 5, 16, 8, 64), (1, 8, 8, 16, 512)])
def test_merge_backward_plain_bf16_matches_pallas_interpret(shape):
    feat, logits = _rand(shape, 7), _rand(shape, 8, 3.0)
    g = _rand(shape[:1] + shape[2:], 9)
    want_df, want_dl = _merge_bwd_impl(_jb(feat), _jb(logits), _jb(g),
                                       interpret=True)
    got_df, got_dl = merge.fused_softmax_merge_backward_plain(
        _tb(feat), _tb(logits), _tb(g))
    # the terms' magnitudes: |w g| and |w g| (|f| + sum_n w |f|)
    l, f, gg = (_tb(a).float().numpy() for a in (logits, feat, g))
    e = np.exp(l - l.max(1, keepdims=True))
    w = e / e.sum(1, keepdims=True)
    wg = np.abs(w * gg[:, None])
    fused_mag = (w * np.abs(f)).sum(1, keepdims=True)
    _check_bits(got_df, want_df, wg)
    _check_bits(got_dl, want_dl, wg * (np.abs(f) + fused_mag))


@pytest.mark.parametrize("shape", [(2, 8, 8, 24), (2, 6, 6, 96),
                                   (1, 4, 5, 48), (2, 5, 7, 5)])
def test_correlation_backward_plain_bf16_matches_pallas_interpret(shape):
    first, second = _rand(shape, 10), _rand(shape, 11)
    g = _rand(shape[:3] + (81,), 12)
    want_df, want_ds = _correlation_pallas_bwd_impl(
        _jb(first), _jb(second), _jb(g), interpret=True)
    a, b, gt = _tb(first), _tb(second), _tb(g)
    got_df = correlation.correlation_dfirst_plain(b, gt)
    got_ds = correlation.correlation_dsecond_plain(a, gt)
    _check_bits(got_df, want_df, correlation.correlation_dfirst_plain(
        b.float().abs(), gt.float().abs()))
    _check_bits(got_ds, want_ds, correlation.correlation_dsecond_plain(
        a.float().abs(), gt.float().abs()))
    # d_second as the kernel computes it, from the shifted gradient: in
    # bf16 the shift is a permutation, so the same bits
    assert torch.equal(
        correlation.correlation_dsecond_shifted_plain(a, gt), got_ds)


@pytest.mark.parametrize("shape,O", [((2, 16, 16, 128), 32),
                                     ((2, 6, 10, 64), 24)])
def test_conv_s2d_backward_bf16_matches_pallas_interpret(shape, O):
    """The conv's ``Function`` on CPU tensors: d_input in bf16 against the
    Pallas body on the rotated block weight rounded to bf16, d_kernel in
    float32 against the JAX package's fine-resolution formula."""
    x = _rand(shape, 13)
    g = _rand(shape[:3] + (4 * O,), 14)
    k = _rand((3, 3, shape[-1] // 4, O), 15, 0.1)  # HWIO
    k_rot = jnp.flip(jnp.asarray(k), axis=(0, 1)).transpose(0, 1, 3, 2)
    want_dx = _conv3x3_block_impl(
        _jb(g), jax_block_weight(k_rot).astype(jnp.bfloat16), interpret=True)

    def fine_conv(kk):
        return jax.lax.conv_general_dilated(
            _unfold(_jb(x)).astype(jnp.float32), kk, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=jax.lax.Precision.HIGHEST)

    (want_dk,) = jax.vjp(fine_conv, jnp.asarray(k))[1](
        _unfold(_jb(g)).astype(jnp.float32))

    xt = _tb(x).requires_grad_(True)
    w = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
    conv3x3_s2d(xt, w).backward(_tb(g))
    assert xt.grad.dtype == BF and w.grad.dtype == torch.float32
    rot = torch.from_numpy(np.asarray(k_rot).transpose(3, 2, 0, 1).copy())
    scale = conv3x3_s2d(_tb(g).float().abs(), rot.to(BF).float().abs())
    _check_bits(xt.grad, want_dx, scale)
    want_dk = np.asarray(want_dk)
    np.testing.assert_allclose(w.grad.numpy().transpose(2, 3, 1, 0), want_dk,
                               rtol=0, atol=1e-5 * np.abs(want_dk).max())


def test_backward_wrappers_pick_the_bf16_entry_and_raise_for_others():
    """A tensor off the CPU of a type no backward kernel instantiates
    raises a TypeError naming it; bf16 goes on to the device check (no
    plain fallback)."""
    meta = dict(device="meta")
    f2 = torch.empty(1, 8, 8, 2, **meta)
    for dt, err, match in ((torch.float16, TypeError, "float16"),
                           (BF, ValueError, "CUDA or CPU")):
        m4 = torch.empty(1, 8, 8, 8, dtype=dt, **meta)
        m5 = torch.empty(1, 3, 8, 8, 8, dtype=dt, **meta)
        g81 = torch.empty(1, 8, 8, 81, dtype=dt, **meta)
        for call in (lambda: warp.warp_dfeat(f2, m4),
                     lambda: warp.warp_dflow(m4, f2, m4),
                     lambda: merge.merge_backward(m5, m5, m4),
                     lambda: correlation.correlation_dfirst(m4, g81),
                     lambda: correlation.correlation_dsecond(m4, g81)):
            with pytest.raises(err, match=match):
                call()
