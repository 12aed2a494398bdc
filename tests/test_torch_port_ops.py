"""The port's ops (``dbsr_tpu_torch.ops``) against the JAX package on CPU.

Each kernel's plain PyTorch version is held against the JAX Pallas body run
in interpret mode, and the other ops of the serving path against their JAX
functions, on the same float32 inputs made from a seed with numpy.
Tolerance for the kernels: rtol 1e-5 / atol 1e-6 (sums run in another
order). The wrappers run the plain version only for CPU tensors; a tensor
elsewhere that is not CUDA raises (no hidden fallback).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dbsr_tpu.models.layers import pixel_shuffle as jax_pixel_shuffle
from dbsr_tpu.ops import camera as jcamera
from dbsr_tpu.ops import correlation as jcorr
from dbsr_tpu.ops import filtering as jfilt
from dbsr_tpu.ops import interp as jinterp
from dbsr_tpu.ops.merge_pallas import _merge_fwd_impl
from dbsr_tpu.ops.warp_pallas import _warp_pallas_impl
from dbsr_tpu_torch import resolve_device
from dbsr_tpu_torch.models.layers import pixel_shuffle
from dbsr_tpu_torch.ops import camera, filtering, interp
from dbsr_tpu_torch.ops.correlation import correlation_plain, cost_volume
from dbsr_tpu_torch.ops.merge import (fused_softmax_merge,
                                      fused_softmax_merge_plain)
from dbsr_tpu_torch.ops.warp import warp_feat, warp_feat_plain

RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _flow(kind, rng, shape):
    if kind == "random":  # out-of-range taps at the borders
        return (rng.rand(*shape) * 10 - 5).astype(np.float32)
    if kind == "integer":  # taps on exact pixel centres
        return rng.randint(-5, 6, size=shape).astype(np.float32)
    if kind == "out_of_range":
        return np.full(shape, 20.0, np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["random", "integer", "out_of_range"])
def test_warp_plain_matches_pallas_interpret(kind):
    rng = np.random.RandomState(0)
    feat = rng.randn(3, 16, 8, 32).astype(np.float32)
    flow = _flow(kind, rng, (3, 16, 8, 2))
    want = _warp_pallas_impl(jnp.asarray(feat), jnp.asarray(flow),
                             interpret=True)
    _close(warp_feat_plain(_t(feat), _t(flow)), want)
    # and exactly the gather warp of the JAX package (same arithmetic)
    np.testing.assert_array_equal(
        warp_feat_plain(_t(feat), _t(flow)).numpy(),
        np.asarray(jinterp.warp(jnp.asarray(feat), jnp.asarray(flow))))


@pytest.mark.parametrize("hw,c", [((16, 16), 24), ((12, 12), 48),
                                  ((6, 10), 96)])
def test_correlation_plain_matches_pallas_interpret(hw, c):
    rng = np.random.RandomState(1)
    first = rng.randn(2, *hw, c).astype(np.float32)
    second = rng.randn(2, *hw, c).astype(np.float32)
    want = jcorr._correlation_pallas_fwd_impl(
        jnp.asarray(first), jnp.asarray(second), interpret=True)
    _close(correlation_plain(_t(first), _t(second)), want)


@pytest.mark.parametrize("n", [3, 14])
def test_merge_plain_matches_pallas_interpret(n):
    rng = np.random.RandomState(2)
    feat = rng.randn(2, n, 16, 8, 16).astype(np.float32)
    logits = (3 * rng.randn(2, n, 16, 8, 16)).astype(np.float32)
    want = _merge_fwd_impl(jnp.asarray(feat), jnp.asarray(logits),
                           interpret=True)
    _close(fused_softmax_merge_plain(_t(feat), _t(logits)), want)


def test_wrappers_take_plain_version_on_cpu():
    rng = np.random.RandomState(3)
    feat = _t(rng.randn(2, 8, 8, 8).astype(np.float32))
    flow = _t(_flow("random", rng, (2, 8, 8, 2)))
    f5 = _t(rng.randn(1, 3, 8, 8, 8).astype(np.float32))
    l5 = _t(rng.randn(1, 3, 8, 8, 8).astype(np.float32))
    counts = (warp_feat.launches, cost_volume.launches,
              fused_softmax_merge.launches)
    assert torch.equal(warp_feat(feat, flow), warp_feat_plain(feat, flow))
    assert torch.equal(cost_volume(feat, feat), correlation_plain(feat, feat))
    assert torch.equal(fused_softmax_merge(f5, l5),
                       fused_softmax_merge_plain(f5, l5))
    assert counts == (warp_feat.launches, cost_volume.launches,
                      fused_softmax_merge.launches)


@pytest.mark.parametrize("op", ["warp", "correlation", "merge"])
def test_wrappers_raise_off_cpu_without_cuda(op):
    """A tensor that is not on the CPU never reaches the plain version: it
    must be a CUDA tensor for the kernel, else the wrapper raises."""
    m4 = torch.empty(1, 8, 8, 8, device="meta")
    m5 = torch.empty(1, 3, 8, 8, 8, device="meta")
    call = {"warp": lambda: warp_feat(m4, torch.empty(1, 8, 8, 2,
                                                      device="meta")),
            "correlation": lambda: cost_volume(m4, m4),
            "merge": lambda: fused_softmax_merge(m5, m5)}[op]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        call()


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the request is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")


@pytest.mark.parametrize("in_hw,out_hw", [((6, 6), (12, 12)),
                                          ((12, 12), (24, 24)),
                                          ((16, 12), (8, 5))])
def test_resize_bilinear_matches_jax(in_hw, out_hw):
    x = np.random.RandomState(4).randn(3, *in_hw, 2).astype(np.float32)
    want = jinterp.resize_bilinear(jnp.asarray(x), out_hw)
    _close(interp.resize_bilinear(_t(x), out_hw), want)


@pytest.mark.parametrize("kind", ["random", "integer", "out_of_range"])
def test_backwarp_matches_jax_including_mask(kind):
    rng = np.random.RandomState(5)
    im = rng.randn(2, 12, 12, 24).astype(np.float32)
    flow = _flow(kind, rng, (2, 12, 12, 2))
    want = np.asarray(jinterp.backwarp(jnp.asarray(im), jnp.asarray(flow)))
    got = interp.backwarp(_t(im), _t(flow)).numpy()
    _close(got, want)
    # the mask zeroes the same pixels
    np.testing.assert_array_equal(np.all(got == 0, -1), np.all(want == 0, -1))


def test_backwarp_mask_edges():
    """Flows that land a tap exactly on the last pixel or just past it: the
    analytic warped-ones mask keeps the first and zeroes the second."""
    im = np.ones((1, 8, 8, 4), np.float32)
    flow = np.zeros((1, 8, 8, 2), np.float32)
    flow[0, :, 0, 0] = 7.0 * 7.0 / 8.0    # x -> exactly 7 after the S/(S-1) scale
    flow[0, :, 1, 0] = 6.6                 # x -> past the right edge
    want = np.asarray(jinterp.backwarp(jnp.asarray(im), jnp.asarray(flow)))
    got = interp.backwarp(_t(im), _t(flow)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, :, 0].min() > 0 and got[0, :, 1].max() == 0


def test_demosaic_naive_matches_jax():
    x = np.random.RandomState(6).rand(2, 3, 8, 8, 4).astype(np.float32)
    np.testing.assert_array_equal(
        camera.demosaic_naive(_t(x)).numpy(),
        np.asarray(jcamera.demosaic_naive(jnp.asarray(x))))


@pytest.mark.parametrize("sz,sigma,density", [(3, 1.0, True), (5, 0.7, False),
                                              ((3, 5), (1.0, 2.0), True)])
def test_gauss_2d_matches_jax(sz, sigma, density):
    want = jfilt.gauss_2d(sz, sigma, (0.0, 0.0), density=density)
    _close(filtering.gauss_2d(sz, sigma, (0.0, 0.0), density=density), want,
           rtol=1e-6, atol=0)


def test_pixel_shuffle_matches_torch_and_jax():
    x = np.random.RandomState(7).randn(2, 3, 5, 32).astype(np.float32)
    got = pixel_shuffle(_t(x), 4)
    want_t = F.pixel_shuffle(_t(x).permute(0, 3, 1, 2), 4).permute(0, 2, 3, 1)
    assert torch.equal(got, want_t)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_pixel_shuffle(jnp.asarray(x), 4)))
