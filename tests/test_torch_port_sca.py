"""The port's spatial-and-colour alignment and what it stands on, against
the JAX package on the CPU, float32: ``get_gaussian_kernel`` and
``apply_kernel``, the packed-RAW conversions, AlignLite's
``coarse_to_fine_flow`` with the banked ``align_lite_params.ckpt``,
``match_colors``, ``make_sca`` with the banked AlignLite (coarse to fine)
and the banked PWC-Net (``pwcnet_synth_params.ckpt``), and the four cases
of ``tests/test_sca.py`` run on the port.

Inputs are made from numpy seeds. On the CPU the JAX package's warp and
backwarp are its gather formulations and the port's are the plain PyTorch
versions of its kernels.

Tolerances: the Gaussian kernel and the filtered image 1e-6 (float32 sums
in another order); the packed-RAW conversions exact; flows 1e-4 px;
``match_colors``' transformed image 1e-4, and no farther from the float64
solution of its least squares than JAX's (the float32 normal equations'
conditioning, see the test); SCA's output 1e-4 where the colour fit's
cond(AᵀA) is up to 1e3, scaled by cond / 1e3 above (a float32 solve's
error grows with it). The validity mask is equal except where it is decided at a
threshold: a pixel whose fit error lies within 0.05 of 20 (of 255), or
whose resized mask lies within 1e-3 of 0.9, may fall on the two sides in
the two packages (float32 rounding); every other pixel must agree, and
fewer than 2% of the pixels may be such threshold pixels.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbsr_tpu.models import align_lite as jax_align_lite
from dbsr_tpu.models import pwcnet as jax_pwcnet
from dbsr_tpu.models import sca as jax_sca
from dbsr_tpu.ops import filtering as jax_filtering
from dbsr_tpu.ops import raw as jax_raw
from dbsr_tpu_torch.models import sca
from dbsr_tpu_torch.models.align_lite import AlignLiteNet, coarse_to_fine_flow
from dbsr_tpu_torch.models.pwcnet import PWCNet
from dbsr_tpu_torch.ops import filtering, raw
from dbsr_tpu_torch.training.checkpoint import read_checkpoint
from dbsr_tpu_torch.utils.convert import params_from_flax

ALIGN_LITE = "dbsr_tpu/artifacts/align_lite_params.ckpt"
PWC_SYNTH = "dbsr_tpu/artifacts/pwcnet_synth_params.ckpt"
# the planted misregistration of the BurstSR fixtures
SHIFT = (7.3, -5.1)
COLOR_M = np.array([[0.90, 0.08, 0.02], [0.05, 0.90, 0.05],
                    [0.02, 0.08, 0.90]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this module runs (the suite runs
    in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=msg)


def _smooth(seed, shape, sd=2.0):
    """A smooth image in [0.2, 0.7] from a numpy seed (the port's filter on
    uniform noise): float32 numpy."""
    img = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    k, _ = filtering.get_gaussian_kernel(sd)
    out = filtering.apply_kernel(_t(img), k).numpy()
    lo, hi = out.min(), out.max()
    return (0.2 + 0.5 * (out - lo) / (hi - lo)).astype(np.float32)


def _scene(seed, hw):
    """A textured scene with edges at several scales (sums of sinusoids and
    a few discs), float32 ``[1, H, W, 3]`` in [0.05, 0.95]."""
    rng = np.random.RandomState(seed)
    H, W = hw
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.zeros((H, W, 3), np.float32)
    for _ in range(6):
        f = rng.uniform(0.02, 0.15, 2)
        ph = rng.uniform(0, 2 * np.pi)
        img += rng.rand(3) * np.sin(f[0] * x + f[1] * y + ph)[..., None]
    for _ in range(8):
        cy, cx, r = rng.rand() * H, rng.rand() * W, rng.uniform(4, H / 4)
        img += (rng.rand(3) - 0.5) * ((y - cy) ** 2 + (x - cx) ** 2
                                      < r * r)[..., None]
    img = (img - img.min()) / (img.max() - img.min())
    return (0.05 + 0.9 * img)[None].astype(np.float32)


def _misregistered(pred, burst_hw):
    """``(gt, burst)``: ``pred`` shifted by SHIFT and colour-transformed by
    COLOR_M (the port's plain warp), and a burst whose base frame is the
    prediction's block mean at the burst's size (channels R, G, G, B)."""
    from dbsr_tpu_torch.ops.warp import warp_feat_plain

    p = _t(pred)
    flow = torch.tensor(SHIFT).expand(p.shape[:3] + (2,))
    gt = (warp_feat_plain(p, flow).numpy() @ COLOR_M.T).clip(0, 1)
    H, W = pred.shape[1:3]
    h, w = burst_hw
    base = pred.reshape(1, h, H // h, w, W // w, 3).mean(axis=(2, 4))
    frame = base[..., [0, 1, 1, 2]]
    rng = np.random.RandomState(5)
    burst = np.stack([frame[0]] + [
        np.roll(frame[0], rng.randint(-1, 2, 2), (0, 1)) for _ in range(3)])
    return gt.astype(np.float32), burst[None].astype(np.float32)


def _threshold_pixels(im_ref, im_q, out_hw, err_thresh=20.0):
    """Output pixels whose validity ``match_colors`` decides within a
    margin of one of its thresholds, from the port's own inputs: a fit
    error within 0.05 of ``err_thresh`` among a pixel's bilinear taps, or
    a resized mask within 1e-3 of 0.9 (the fit in float64)."""
    k, _ = filtering.get_gaussian_kernel(1.5)
    bi = 5
    ref = filtering.apply_kernel(im_ref, k)[:, bi:-bi, bi:-bi].double()
    q = filtering.apply_kernel(im_q, k)[:, bi:-bi, bi:-bi].double()
    B = ref.shape[0]
    qf, rf = q.reshape(B, -1, 3), ref.reshape(B, -1, 3)
    ata = qf.transpose(1, 2) @ qf + 1e-6 * torch.eye(3, dtype=qf.dtype)
    c = torch.linalg.solve(ata, qf.transpose(1, 2) @ rf)
    err = torch.linalg.vector_norm(((qf @ c).reshape(ref.shape) - ref)
                                   * 255.0, dim=-1)
    pad = (im_q.shape[-2] - err.shape[-1]) // 2
    near = torch.nn.functional.pad((err - err_thresh).abs() < 0.05,
                                   (pad, pad, pad, pad))
    soft = torch.nn.functional.pad((err < err_thresh).double(),
                                   (pad, pad, pad, pad))
    h, w = near.shape[-2:]
    H, W = out_hw

    def taps(n_in, n_out):
        s = (np.arange(n_out) + 0.5) * n_in / n_out - 0.5
        i0 = np.floor(s).astype(int)
        return np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1), s - i0

    (r0, r1, wy), (c0, c1, wx) = taps(h, H), taps(w, W)
    n, sf = near.numpy(), soft.numpy()
    out = (n[:, r0][:, :, c0] | n[:, r0][:, :, c1] | n[:, r1][:, :, c0]
           | n[:, r1][:, :, c1])
    wy, wx = wy[None, :, None], wx[None, None, :]
    resized = ((1 - wy) * ((1 - wx) * sf[:, r0][:, :, c0]
                           + wx * sf[:, r0][:, :, c1])
               + wy * ((1 - wx) * sf[:, r1][:, :, c0]
                       + wx * sf[:, r1][:, :, c1]))
    return out | (np.abs(resized - 0.9) < 1e-3)


def _valid_equal_off_threshold(got, want, near):
    got = np.asarray(got)[..., 0]
    want = np.asarray(want)[..., 0]
    assert near.mean() < 0.02, f"{near.mean():.3%} threshold pixels"
    bad = (got != want) & ~near
    assert not bad.any(), f"{bad.sum()} pixels disagree off the thresholds"


# ---------------------------------------------------------------------------
# filtering and packed RAW


@pytest.mark.parametrize("sd,ksz", [(1.5, None), (1.0, None), (2.0, 5)])
def test_gaussian_kernel_and_apply_kernel_match_jax(sd, ksz):
    k, n = filtering.get_gaussian_kernel(sd, ksz)
    jk, jn = jax_filtering.get_gaussian_kernel(sd, ksz)
    assert n == jn
    _close(k, jk, 1e-6)
    im = np.random.RandomState(int(sd * 10)).rand(2, 3, 19, 23, 3).astype(
        np.float32)
    _close(filtering.apply_kernel(_t(im), k),
           jax_filtering.apply_kernel(jnp.asarray(im), jk), 1e-6)


def test_gaussian_kernel_refuses_even_size():
    with pytest.raises(ValueError, match="odd"):
        filtering.get_gaussian_kernel(1.0, 4)


@pytest.mark.parametrize("pattern", ["rggb", "grbg", "gbrg", "bggr"])
def test_packed_raw_conversions_match_jax_exactly(pattern):
    packed = np.random.RandomState(0).rand(3, 6, 10, 14, 4).astype(np.float32)
    flat = raw.flatten_raw_image(packed)
    np.testing.assert_array_equal(
        flat, np.asarray(jax_raw.flatten_raw_image(jnp.asarray(packed))))
    np.testing.assert_array_equal(
        raw.pack_raw_image(flat),
        np.asarray(jax_raw.pack_raw_image(jnp.asarray(flat))))
    np.testing.assert_array_equal(raw.pack_raw_image(flat), packed)
    np.testing.assert_array_equal(
        raw.bayer_crop_to_rggb(flat, pattern),
        np.asarray(jax_raw.bayer_crop_to_rggb(jnp.asarray(flat), pattern)))


# ---------------------------------------------------------------------------
# coarse-to-fine flow


def _banked(path, cls):
    """A banked aligner's ``alignment_net``: the port's module and its flax
    parameters."""
    _, tree = read_checkpoint(path)
    sub = tree["params"]["params"]["alignment_net"]
    net = cls().eval()
    net.load_state_dict(params_from_flax(sub), strict=True)
    return net, sub


@pytest.fixture(scope="module")
def pair():
    """A 128^2 scene and its planted misregistration."""
    pred = _scene(0, (128, 128))
    gt, burst = _misregistered(pred, (16, 16))
    return pred, gt, burst


def _normalised(pair):
    """SCA's aligner inputs: the prediction and the ground truth divided by
    their maxima."""
    pred, gt, _ = pair
    return pred / (pred.max() + 1e-6), gt / (gt.max() + 1e-6)


@pytest.fixture(scope="module")
def lite(pair):
    """The banked AlignLite: the port's module and the JAX package's flow
    of SCA's inputs, coarse to fine (one jitted call: its compile is the
    JAX side's cost here, not its arithmetic)."""
    net, sub = _banked(ALIGN_LITE, AlignLiteNet)
    jnet = jax_align_lite.AlignLiteNet()
    flow = jax.jit(lambda s, t: jax_align_lite.coarse_to_fine_flow(
        lambda a, b: jnet.apply({"params": sub}, a, b), s, t))(
        *map(jnp.asarray, _normalised(pair)))
    return net, np.asarray(flow)


@pytest.fixture(scope="module")
def pwc(pair):
    """The banked PWC-Net (``pwcnet_synth_params.ckpt``): the port's module
    and the JAX package's flow of SCA's inputs."""
    net, sub = _banked(PWC_SYNTH, PWCNet)
    jnet = jax_pwcnet.PWCNet()
    flow = jax.jit(lambda s, t: jnet.apply({"params": sub}, s, t))(
        *map(jnp.asarray, _normalised(pair)))
    return net, np.asarray(flow)


def _given(flow):
    """An aligner that returns the JAX package's flow of SCA's inputs, for
    the JAX package's SCA (whose aligner call is then computed once, in
    the fixture)."""
    return lambda s, t: jnp.asarray(flow)


def test_coarse_to_fine_flow_matches_jax_and_recovers_the_shift(lite, pair):
    net, want = lite
    with torch.no_grad():
        got = coarse_to_fine_flow(net, *map(_t, _normalised(pair)))
    _close(got, want, 1e-4)
    # target(p) ~= source(p + flow), and gt(p) = pred(p + SHIFT): the
    # flow is SHIFT in the interior
    mid = got[0, 32:-32, 32:-32].reshape(-1, 2).median(dim=0).values
    assert abs(mid[0] - SHIFT[0]) < 1.5 and abs(mid[1] - SHIFT[1]) < 1.5, mid


# ---------------------------------------------------------------------------
# match_colors and SCA


def _solve64(im_ref, im_q, im_test):
    """``match_colors``' transformed image with the fit solved in float64
    (from the port's float32 smoothing): the yardstick of both packages'
    float32 solves."""
    k, _ = filtering.get_gaussian_kernel(1.5)
    bi = 5
    ref = filtering.apply_kernel(im_ref, k)[:, bi:-bi, bi:-bi].double()
    q = filtering.apply_kernel(im_q, k)[:, bi:-bi, bi:-bi].double()
    B = ref.shape[0]
    qf, rf = q.reshape(B, -1, 3), ref.reshape(B, -1, 3)
    ata = qf.transpose(1, 2) @ qf + 1e-6 * torch.eye(3, dtype=qf.dtype)
    c = torch.linalg.solve(ata, qf.transpose(1, 2) @ rf)
    return (im_test.double().reshape(B, -1, 3) @ c).reshape(im_test.shape), \
        torch.linalg.cond(ata)


def test_match_colors_matches_jax():
    """The transformed image within 1e-4 of JAX's and no farther from the
    float64 solution than JAX's is; the mask equal off the thresholds. The
    normal equations of smooth images with correlated channels have
    cond(AᵀA) ~ 250-650 here, so JAX's float32 sums and solve move the
    transformed image by up to ~cond x 1.2e-7 ~ 7e-5 (observed: 2.2e-5
    from the float64 solution, which the port's float64 fit matches to
    float32 rounding): 1e-5 between the two packages is below float32's
    reach at this conditioning."""
    ref = _smooth(0, (2, 32, 32, 3))
    q = np.einsum("bhwc,cd->bhwd", ref, COLOR_M)
    q[0, 8:16, 8:16] += 0.5  # a region the transform cannot explain
    test = _smooth(1, (2, 64, 64, 3))
    k, _ = filtering.get_gaussian_kernel(1.5)
    jk, _ = jax_filtering.get_gaussian_kernel(1.5)
    got, valid = sca.match_colors(_t(ref), _t(q), _t(test), k)
    want, jvalid = jax_sca.match_colors(jnp.asarray(ref), jnp.asarray(q),
                                        jnp.asarray(test), jk)
    _close(got, want, 1e-4)
    exact, cond = _solve64(_t(ref), _t(q), _t(test))
    assert cond.max() < 1e3
    port_err = (got.double() - exact).abs().max().item()
    jax_err = (_t(want).double() - exact).abs().max().item()
    assert port_err <= jax_err + 1e-6, (port_err, jax_err)
    assert valid.dtype == torch.bool and valid.shape == (2, 64, 64, 1)
    _valid_equal_off_threshold(valid, jvalid, _threshold_pixels(
        _t(ref), _t(q), (64, 64)))


def _sca_tol(cond):
    """SCA's output tolerance against JAX: 1e-4, scaled up where the colour
    fit's normal equations are worse conditioned than cond(AᵀA) = 1e3 (a
    float32 solve moves its result by ~cond x 1.2e-7)."""
    return 1e-4 * max(1.0, float(cond.max()) / 1e3)


def _port_sca(net, pair):
    """The port's SCA of ``pair``, the aligner bound as
    ``evaluation/burstsr.py`` binds it (AlignLite coarse to fine, PWC-Net
    directly), with ``match_colors``' inputs captured."""
    from dbsr_tpu_torch.evaluation.burstsr import _alignment_apply_from

    pred, gt, burst = pair
    seen = {}
    real = sca.match_colors

    def spy(im_ref, im_q, im_test, k, *a):
        seen.update(im_ref=im_ref, im_q=im_q, im_test=im_test)
        return real(im_ref, im_q, im_test, k, *a)

    with mock.patch.object(sca, "match_colors", spy), torch.no_grad():
        got, valid = sca.make_sca(_alignment_apply_from(net), sr_factor=4)(
            _t(pred), _t(gt), _t(burst))
    return got, valid, seen


@pytest.mark.parametrize("aligner", ["lite", "pwc"])
def test_make_sca_matches_jax(aligner, pair, request):
    """SCA end to end against the JAX package's SCA on its own flow of the
    same inputs: the output within 1e-4 (scaled by the colour fit's
    conditioning: cond(AᵀA) ~ 9e3 for this pair's 36 fit pixels), the mask
    equal off the thresholds."""
    net, jflow = request.getfixturevalue(aligner)
    pred, gt, burst = pair
    got, valid, seen = _port_sca(net, pair)
    want, jvalid = jax_sca.make_sca(_given(jflow), sr_factor=4)(
        jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(burst))
    assert got.shape == gt.shape
    _, cond = _solve64(seen["im_ref"], seen["im_q"], seen["im_test"])
    _close(got, want, _sca_tol(cond))
    _valid_equal_off_threshold(valid, jvalid, _threshold_pixels(
        seen["im_ref"], seen["im_q"], gt.shape[1:3]))


def test_make_aligned_l2_matches_jax(lite, pair):
    """The masked MSE after SCA: within what SCA's output tolerance moves
    it, ``2 sqrt(mse) tol + tol^2``."""
    from dbsr_tpu_torch.evaluation.burstsr import _alignment_apply_from

    net, jflow = lite
    pred, gt, burst = pair
    _, _, seen = _port_sca(net, pair)
    with torch.no_grad():
        got = float(sca.make_aligned_l2(_alignment_apply_from(net),
                                        boundary_ignore=16)(
            _t(pred), _t(gt), _t(burst)))
    want = float(jax_sca.make_aligned_l2(_given(jflow), boundary_ignore=16)(
        jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(burst)))
    tol = _sca_tol(_solve64(seen["im_ref"], seen["im_q"],
                            seen["im_test"])[1])
    assert abs(got - want) <= 2 * np.sqrt(want) * tol + tol ** 2, (got, want)


# ---------------------------------------------------------------------------
# tests/test_sca.py on the port (the two SCA cases at 128^2, where the
# colour fit has 6x6 pixels: at 64^2 it has none, and its output is 0)


def test_match_colors_recovers_linear_transform():
    """im_q = im_ref @ M: the fit recovers M^-1, so the transformed im_q
    matches im_ref on the valid interior."""
    kernel, _ = filtering.get_gaussian_kernel(1.5)
    ref = _t(_smooth(0, (1, 32, 32, 3)))
    M = _t(COLOR_M)
    q = torch.einsum("bhwc,cd->bhwd", ref, M)
    out, valid = sca.match_colors(ref, q, q, kernel)
    v = valid[0, :, :, 0].numpy()
    assert v[8:-8, 8:-8].all()
    err = (out - ref).abs()[0].numpy()[v]
    assert err.mean() < 0.01


def test_match_colors_flags_mismatched_regions():
    kernel, _ = filtering.get_gaussian_kernel(1.5)
    ref = _t(_smooth(1, (1, 32, 32, 3)))
    q = ref.clone()
    q[:, 8:16, 8:16] += 0.5  # corrupt a region
    _, valid = sca.match_colors(ref, q, q, kernel)
    assert valid[0, 9:15, 9:15, 0].float().mean() < 0.5


def _base_burst(pred):
    """A burst whose base frame is ``pred``'s 8x8 block mean as (R, G, G,
    B): colours that match ``pred``'s."""
    B, H, W, _ = pred.shape
    base = pred.reshape(B, H // 8, 8, W // 8, 8, 3).mean(dim=(2, 4))
    return base[..., [0, 1, 1, 2]][:, None].repeat(1, 3, 1, 1, 1)


def test_sca_identity_alignment():
    """A zero-flow aligner and matched colours (a scene smooth at the base
    frame's 8 px pitch): SCA returns ~pred where it is valid (at most
    the 6x6 interior of the 16x16 fit grid, ~11% of the pixels)."""
    def zero_flow(src, tgt):
        return torch.zeros(src.shape[:-1] + (2,))

    pred = _t(_smooth(2, (1, 128, 128, 3), sd=8.0))
    out, valid = sca.make_sca(zero_flow, sr_factor=4)(pred, pred,
                                                       _base_burst(pred))
    assert out.shape == pred.shape and valid.shape == (1, 128, 128, 1)
    assert torch.isfinite(out).all() and valid.float().mean() > 0.05
    v = valid[..., 0]
    assert (out - pred).abs()[v].mean() < 0.01


def test_sca_grad_does_not_flow_to_flow_net():
    """The flow is computed without gradient: d(sca)/d(pred) is finite and
    non-zero though pred feeds the aligner, and the aligner's output has
    no gradient history."""
    flows = []

    def shifty_flow(src, tgt):
        flows.append(torch.ones(src.shape[:-1] + (2,)) * src.mean())
        return flows[-1]

    gt = _t(_smooth(3, (1, 128, 128, 3), sd=8.0))
    pred = (gt + 0.01).requires_grad_(True)
    out, _ = sca.make_sca(shifty_flow, sr_factor=4)(pred, gt, _base_burst(gt))
    ((out - gt) ** 2).mean().backward()
    assert not flows[0].requires_grad
    assert torch.isfinite(pred.grad).all() and pred.grad.abs().sum() > 0
