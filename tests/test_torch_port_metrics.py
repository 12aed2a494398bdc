"""The port's image-quality metrics (``dbsr_tpu_torch/ops/metrics.py``)
against the JAX package's (``dbsr_tpu/ops/metrics.py``) on the CPU, from
the same seeded numpy inputs of shape [2, 64, 64, 3].

Tolerances: the pixel errors, SSIM and MS-SSIM within 1e-5 relative to the
largest magnitude of the JAX result (float32 sums in another order; the
SSIM map's variances ``E[x^2] - mu^2`` cancel, which is where the largest
differences sit, ~5e-6 observed on the map); PSNR within 1e-4 dB (observed
<= 2e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbsr_tpu.ops import metrics as JM
from dbsr_tpu_torch.ops import metrics as M

REL = 1e-5
PSNR_DB = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this module runs (the suite runs
    in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    pred = rng.random((2, 64, 64, 3), dtype=np.float32)
    gt = np.clip(pred + 0.05 * rng.standard_normal(pred.shape), 0, 1)
    valid = (rng.random((2, 64, 64, 1)) > 0.3).astype(np.float32)
    return pred, gt.astype(np.float32), valid


def _both(a):
    return jnp.asarray(a), torch.from_numpy(a)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("boundary", [0, 5])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", ["l1", "l2", "l2_sqrt", "charbonnier"])
def test_pixel_error_matches_jax(metric, masked, boundary):
    pred, gt, valid = _inputs()
    (jp, tp), (jg, tg), (jv, tv) = _both(pred), _both(gt), _both(valid)
    want = JM.pixel_error(jp, jg, metric, boundary, jv if masked else None)
    got = M.pixel_error(tp, tg, metric, boundary, tv if masked else None)
    assert _rel(got, want) <= REL


def test_pixel_error_unknown_metric_raises():
    pred, gt, _ = _inputs()
    with pytest.raises(ValueError, match="unknown metric"):
        M.pixel_error(torch.from_numpy(pred), torch.from_numpy(gt), "l3")


@pytest.mark.parametrize("masked", [False, True])
def test_psnr_matches_jax(masked):
    pred, gt, valid = _inputs(1)
    (jp, tp), (jg, tg), (jv, tv) = _both(pred), _both(gt), _both(valid)
    want = float(JM.psnr(jp, jg, boundary_ignore=5,
                         valid=jv if masked else None))
    got = float(M.psnr(tp, tg, boundary_ignore=5,
                       valid=tv if masked else None))
    assert abs(got - want) <= PSNR_DB


def test_psnr_skips_a_sample_that_is_not_finite():
    """A sample equal to its ground truth has an infinite PSNR: both
    packages average over the finite samples only."""
    pred, gt, _ = _inputs(2)
    gt[1] = pred[1]
    (jp, tp), (jg, tg) = _both(pred), _both(gt)
    want = float(JM.psnr(jp, jg, boundary_ignore=4))
    got = float(M.psnr(tp, tg, boundary_ignore=4))
    alone = float(M.psnr(tp[:1], tg[:1], boundary_ignore=4))
    assert np.isfinite(got) and abs(got - want) <= PSNR_DB
    assert got == alone
    # none finite: 0, as in JAX
    assert float(M.psnr(tp[1:], tg[1:])) == float(JM.psnr(jp[1:], jg[1:])) \
        == 0.0


@pytest.mark.parametrize("mode", ["scalar", "spatial_out", "full"])
def test_ssim_matches_jax(mode):
    pred, gt, _ = _inputs(3)
    (jp, tp), (jg, tg) = _both(pred), _both(gt)
    kw = {"spatial_out": mode == "spatial_out", "full": mode == "full"}
    want, got = JM.ssim(jp, jg, **kw), M.ssim(tp, tg, **kw)
    if mode == "full":
        assert _rel(got[0], want[0]) <= REL
        assert _rel(got[1], want[1]) <= REL
    else:
        if mode == "spatial_out":
            assert got.shape == (2, 54, 54, 3)
        assert _rel(got, want) <= REL


@pytest.mark.parametrize("use_for_loss", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_ssim_metric_matches_jax(masked, use_for_loss):
    pred, gt, valid = _inputs(4)
    (jp, tp), (jg, tg), (jv, tv) = _both(pred), _both(gt), _both(valid)
    want = JM.ssim_metric(jp, jg, boundary_ignore=5,
                          valid=jv if masked else None,
                          use_for_loss=use_for_loss)
    got = M.ssim_metric(tp, tg, boundary_ignore=5,
                        valid=tv if masked else None,
                        use_for_loss=use_for_loss)
    if use_for_loss:
        # the loss is 1 - SSIM: the limit is on the SSIM it comes from
        # (the loss itself is ~0.014 here, so 1e-5 of it is ~1e-7 absolute)
        ssim = M.ssim_metric(tp, tg, 5, tv if masked else None)
        assert abs(float(got) + float(ssim) - 1.0) <= 1e-7
        got, want = 1.0 - got, 1.0 - want
    assert _rel(got, want) <= REL


def test_msssim_matches_jax():
    pred, gt, _ = _inputs(5)
    (jp, tp), (jg, tg) = _both(pred), _both(gt)
    want, got = JM.msssim(jp, jg), M.msssim(tp, tg)
    assert np.isfinite(float(got))
    assert _rel(got, want) <= REL
