"""The port's burst synthesis (``dbsr_tpu_torch.data``, ``ops.resample``,
``ops.camera``, ``ops.augment``) against the JAX package on CPU, float32.

The random draws of the JAX package are made with ``jax.random`` by walking
its own key tree (the helpers below) and handed to the port's
``..._from_draws`` functions, so both sides apply the same numbers.
Tolerances: the resample's plain version equals the JAX gather oracle
bit for bit; against the Pallas band kernel (interpret mode, HIGHEST) it
agrees to rtol 1e-4 / atol 2e-5, the JAX package's own bound for that
kernel (the band kernel sums the taps as two contractions). Whole
synthesis agrees to a few float32 ulps: XLA's and PyTorch's float32
sin/asin/cos/pow and the 3x3 LU inverse differ in the last bit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbsr_tpu.data import procedural as jproc
from dbsr_tpu.data import synthetic as jsyn
from dbsr_tpu.ops import augment as jaug
from dbsr_tpu.ops import camera as jcam
from dbsr_tpu.ops import interp as jinterp
from dbsr_tpu.ops.resample_pallas import (_xla_oracle,
                                          affine_resample_interpret,
                                          band_rows_needed)
from dbsr_tpu_torch.data import procedural, synthetic
from dbsr_tpu_torch.ops import augment, camera, interp
from dbsr_tpu_torch.ops.resample import affine_resample, affine_resample_plain

# [0, 1] images and bursts; flows in LR pixels (a few ulps of ~30 px)
IMG_ATOL, FLOW_ATOL = 5e-6, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this module runs: the suite runs
    in parallel worker processes, and torch's many small CPU ops slow down
    several-fold when every worker spins a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _j(a):
    """A JAX array of its own copy of ``a``: JAX on the CPU may alias a
    numpy buffer, and PyTorch reading the same buffer meanwhile was seen to
    get values off by ~1e-4 relative."""
    return jnp.array(np.array(a))


def _rot_invs(n, max_rot_deg, max_trans, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        th = math.radians(rng.uniform(-max_rot_deg, max_rot_deg))
        tx, ty = rng.uniform(-max_trans, max_trans, size=2)
        c, s = math.cos(th), math.sin(th)
        out.append([[c, -s, tx], [s, c, ty]])
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("d,border", [(4, 4), (1, 0)])
def test_resample_plain_matches_pallas_interpret(d, border):
    H = W = 48
    out_hw = ((H - 2 * border) // d, (W - 2 * border) // d)
    rng = np.random.RandomState(0)
    images = rng.rand(2, H, W, 3).astype(np.float32)
    invs = np.stack([_rot_invs(3, 1.0, 6.0, s) for s in (1, 2)])
    got = affine_resample_plain(_t(images), _t(invs), out_hw, d, border)
    band = band_rows_needed(1.0, d, out_hw[1])
    for b in range(2):
        want = affine_resample_interpret(_j(images[b]),
                                         _j(invs[b]), out_hw, d,
                                         border, band, precision="highest")
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   rtol=1e-4, atol=2e-5)


def test_resample_plain_equals_gather_oracle_for_any_affine():
    """Shear, scale and taps outside the image: the same gather arithmetic
    as the JAX package's ``_xla_oracle``, bit for bit."""
    rng = np.random.RandomState(3)
    images = rng.rand(2, 20, 24, 3).astype(np.float32)
    invs = (np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
            + rng.uniform(-0.3, 0.3, (2, 4, 2, 3)).astype(np.float32)
            * np.array([1, 1, 20], np.float32))
    got = affine_resample_plain(_t(images), _t(invs), (8, 9), 2, 2)
    for b in range(2):
        want = _xla_oracle(_j(images[b]), _j(invs[b]),
                           (8, 9), 2, 2)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


def test_resample_wrapper_takes_plain_on_cpu_and_raises_elsewhere():
    rng = np.random.RandomState(4)
    images, invs = _t(rng.rand(1, 16, 16, 3)), _t(_rot_invs(2, 1.0, 2.0, 5)[None])
    count = affine_resample.launches
    assert torch.equal(affine_resample(images, invs, (4, 4), 4, 0),
                       affine_resample_plain(images, invs, (4, 4), 4, 0))
    assert affine_resample.launches == count
    with pytest.raises(ValueError, match="CUDA or CPU"):
        affine_resample(images.to("meta"), invs.to("meta"), (4, 4), 4, 0)


def test_get_tmat_and_invert_2x3_match_jax():
    rng = np.random.RandomState(5)
    n = 64
    t = rng.uniform(-24, 24, (n, 2)).astype(np.float32)
    th = rng.uniform(-1, 1, n).astype(np.float32)
    sh = rng.uniform(-0.05, 0.05, (n, 2)).astype(np.float32)
    sc = np.exp(rng.uniform(-0.1, 0.1, (n, 2))).astype(np.float32)
    want = np.stack([np.asarray(jaug.get_tmat(
        (432, 400), (t[i, 0], t[i, 1]), th[i], (sh[i, 0], sh[i, 1]),
        (sc[i, 0], sc[i, 1]))) for i in range(n)])
    got = augment.get_tmat((432, 400), _t(t), _t(th), _t(sh), _t(sc)).numpy()
    # entries up to ~400 px: a few ulps (XLA's and torch's cos/sin)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * 432)
    inv = interp.invert_2x3(_t(want)).numpy()
    np.testing.assert_allclose(inv, np.asarray(jinterp.invert_2x3(
        _j(want))), rtol=1e-6, atol=1e-6 * 432)
    pts = rng.uniform(0, 100, (5, 6, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        interp.apply_affine_to_points(_t(want), _t(pts)).numpy(),
        np.asarray(jinterp.apply_affine_to_points(_j(want),
                                                  _j(pts))))


def jax_synthesis_draws(key, batch, cfg):
    """The draws of ``jsyn.synthesize_batch(key, ...)``, by its key tree."""
    N = cfg.burst_size
    tp = cfg.transform_params()
    out = {k: [] for k in ("ccm_weights", "gain_normal", "red_gain",
                           "blue_gain", "log_shot", "read_normal", "noise",
                           "translation", "theta", "shear", "log_ar",
                           "log_scale")}
    for k in jax.random.split(key, batch):
        k_isp, k_burst, k_noiselvl, k_noise = jax.random.split(k, 4)
        k_ccm, k_gain = jax.random.split(k_isp)
        out["ccm_weights"].append(jax.random.uniform(k_ccm, (4, 1, 1))
                                  .reshape(4))
        k1, k2, k3 = jax.random.split(k_gain, 3)
        out["gain_normal"].append(jax.random.normal(k1))
        out["red_gain"].append(jax.random.uniform(k2, minval=1.9, maxval=2.4))
        out["blue_gain"].append(jax.random.uniform(k3, minval=1.5,
                                                   maxval=1.9))
        frames = {n: [] for n in ("translation", "theta", "shear", "log_ar",
                                  "log_scale")}
        for kk in jax.random.split(k_burst, N - 1):
            kt, kr, ks, ka, kc = jax.random.split(kk, 5)
            T, R = tp["max_translation"], tp["max_rotation"]
            S, A, K = tp["max_shear"], tp["max_ar_factor"], tp["max_scale"]
            frames["translation"].append(
                jax.random.uniform(kt, (2,), minval=-T, maxval=T)
                if T > 0.01 else jnp.zeros(2))
            frames["theta"].append(jax.random.uniform(kr, minval=-R,
                                                      maxval=R))
            frames["shear"].append(jax.random.uniform(ks, (2,), minval=-S,
                                                      maxval=S))
            frames["log_ar"].append(jax.random.uniform(ka, minval=-A,
                                                       maxval=A))
            frames["log_scale"].append(jax.random.uniform(kc, minval=-K,
                                                          maxval=K))
        for name, v in frames.items():
            out[name].append(jnp.stack(v))
        k1, k2 = jax.random.split(k_noiselvl)
        out["log_shot"].append(jax.random.uniform(
            k1, minval=jcam.LOG_MIN_SHOT_NOISE, maxval=jcam.LOG_MAX_SHOT_NOISE))
        out["read_normal"].append(jax.random.normal(k2))
        out["noise"].append(jax.random.normal(
            k_noise, (N,) + cfg.burst_hw + (4,), jnp.float32))
    return {k: _t(jnp.stack(v)) for k, v in out.items()}


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("affine", ["rotation", "general"])
def test_synthesis_matches_jax_from_its_draws(fused, affine):
    extra = ({} if affine == "rotation" else
             dict(max_shear=0.02, max_scale=0.05, max_ar_factor=0.03))
    cfg = jsyn.BurstConfig(burst_size=4, crop_sz=(32, 32), border_crop=4,
                           max_translation=3.0, max_rotation=1.0,
                           fused_resample=fused, **extra)
    crops = np.random.RandomState(6).rand(2, 40, 40, 3).astype(np.float32)
    key = jax.random.key(7)
    want = jsyn.synthesize_batch(key, _j(crops), cfg)
    got = synthetic.rgb2rawburst_from_draws(
        _t(crops), jax_synthesis_draws(key, 2, cfg),
        synthetic.BurstConfig(**cfg._asdict()))
    for k, atol in (("burst", IMG_ATOL), ("frame_gt", IMG_ATOL),
                    ("burst_rgb", IMG_ATOL), ("flow", FLOW_ATOL)):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=atol, err_msg=k)
    for k in ("rgb_gain", "red_gain", "blue_gain", "shot_noise_level",
              "read_noise_level"):
        np.testing.assert_allclose(got["meta"][k].numpy(),
                                   np.asarray(want["meta"][k]), rtol=1e-6)


def test_samplers_apply_their_own_draws():
    """Each sampler that takes a generator is its draw, then its apply:
    ``random_ccm``, ``random_gains``, ``random_noise_levels`` and
    ``sample_burst_transform`` (reference frame: the centring shift only)."""
    def gens():
        return (procedural.make_generator("cpu", 6),
                procedural.make_generator("cpu", 6))

    g1, g2 = gens()
    assert torch.equal(camera.random_ccm(g1, 3), camera.ccm_from_weights(
        camera.uniform(g2, (3, 4))))
    g1, g2 = gens()
    got = camera.random_gains(g1, 3)
    want = camera.gains_from_draws(camera.normal(g2, (3,)),
                                   camera.uniform(g2, (3,), 1.9, 2.4),
                                   camera.uniform(g2, (3,), 1.5, 1.9))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    g1, g2 = gens()
    got = camera.random_noise_levels(g1, 3)
    want = camera.noise_levels_from_draws(
        camera.uniform(g2, (3,), camera.LOG_MIN_SHOT_NOISE,
                       camera.LOG_MAX_SHOT_NOISE), camera.normal(g2, (3,)))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    params = {"max_translation": 24.0, "max_rotation": 1.0}
    g1, g2 = gens()
    assert torch.equal(
        augment.sample_burst_transform(g1, 5, (64, 64), 4, params, False),
        augment.transforms_from_draws(augment.draw_transforms(g2, (5,), params),
                                      (64, 64), 4, params))
    ref = augment.sample_burst_transform(g1, 2, (64, 64), 4, params, True)
    np.testing.assert_allclose(ref.numpy(), np.broadcast_to(
        [[1, 0, 1.5], [0, 1, 1.5]], (2, 2, 3)), atol=1e-6)


def test_sample_draws_are_seeded_and_shaped():
    cfg = synthetic.BurstConfig(burst_size=5, crop_sz=(32, 32),
                                border_crop=4)
    d1 = synthetic.sample_draws(procedural.make_generator("cpu", 1), 3, cfg)
    d2 = synthetic.sample_draws(procedural.make_generator("cpu", 1), 3, cfg)
    assert d1["noise"].shape == (3, 5, 4, 4, 4)
    assert d1["translation"].shape == (3, 4, 2)
    for k in d1:
        assert torch.equal(d1[k], d2[k]), k
    assert d1["red_gain"].min() >= 1.9 and d1["red_gain"].max() < 2.4
    assert d1["translation"].abs().max() <= 24.0
    assert d1["theta"].abs().max() <= 1.0
    assert d1["shear"].abs().max() == 0.0
    image = torch.from_numpy(
        np.random.RandomState(8).rand(40, 40, 3).astype(np.float32))
    out = synthetic.rgb2rawburst(procedural.make_generator("cpu", 2), image,
                                 cfg)
    assert out["burst"].shape == (5, 4, 4, 4)
    assert out["flow"][0].abs().max() == 0  # the base frame's own flow


def jax_dead_leaves_draws(key, num_leaves, palette_size=4,
                          sigma_range=(0.2, 1.1),
                          bases=(7, 14, 28, 56, 112)):
    """The draws of ``jproc.dead_leaves_image(key, ...)``, by its key tree."""
    k_pal, k_bg, k_leaves, k_tex, k_illum, k_blur = jax.random.split(key, 6)
    leaf_u, leaf_c, leaf_g = [], [], []
    for i in range(num_leaves):
        k = jax.random.fold_in(k_leaves, i)
        leaf_u.append(jax.random.uniform(k, (8,), jnp.float32))
        kc, kg = jax.random.split(jax.random.fold_in(k, 1))
        leaf_c.append(jax.random.normal(kc, (3,)))
        leaf_g.append(jax.random.normal(kg, (2,)))
    ki1, ki2 = jax.random.split(k_illum)
    d = {"palette": jax.random.uniform(k_pal, (palette_size, 3), jnp.float32,
                                       0.05, 0.95),
         "bg_normal": jax.random.normal(k_bg, (3,)),
         "leaf_u": jnp.stack(leaf_u), "leaf_color_normal": jnp.stack(leaf_c),
         "leaf_grad": jnp.stack(leaf_g),
         "illum_dir": jax.random.normal(ki1, (2,)),
         "illum_u": jax.random.uniform(ki2, ()),
         "sigma": jax.random.uniform(k_blur, (), jnp.float32, *sigma_range)}
    d = {k: _t(v)[None] for k, v in d.items()}
    d["octaves"] = [_t(jax.random.uniform(jax.random.fold_in(k_tex, o),
                                          (b, b, 3), jnp.float32))[None]
                    for o, b in enumerate(bases)]
    return d


@pytest.mark.parametrize("seed,hw", [(0, (32, 32)), (1, (24, 40))])
def test_dead_leaves_matches_jax_from_its_draws(seed, hw):
    key = jax.random.key(seed)
    want = jproc.dead_leaves_image(key, hw, num_leaves=5)
    got = procedural.dead_leaves_from_draws(jax_dead_leaves_draws(key, 5), hw)
    assert got.shape == (1,) + hw + (3,)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0,
                               atol=IMG_ATOL)


def test_pool_batcher_and_prepare_on_cpu():
    pool = procedural.ProceduralImagePool(3, (40, 40), seed=5, chunk=2,
                                          device="cpu", num_leaves=4)
    batcher = procedural.ProceduralPoolBatcher(pool, batch_size=2,
                                               num_batches=2)
    p0 = batcher.next_batch()
    assert p0.dtype == torch.uint8 and p0.shape == (3, 40, 40, 3)
    assert batcher.next_batch() is p0          # same epoch, same pool
    p1 = batcher.next_batch()                  # next epoch: refreshed
    assert not torch.equal(p0, p1)
    again = procedural.ProceduralImagePool(3, (40, 40), seed=5, chunk=3,
                                           device="cpu", num_leaves=4)
    assert torch.equal(again.refresh(0), p0)   # chunking changes nothing
    cfg = synthetic.BurstConfig(burst_size=3, crop_sz=(32, 32),
                                border_crop=4, fused_resample=True)
    prepare = procedural.make_pool_prepare_fn(cfg, 2)
    batch = prepare(procedural.make_generator("cpu", 9), p0)
    assert batch["burst"].shape == (2, 3, 4, 4, 4)
    assert batch["frame_gt"].shape == (2, 32, 32, 3)
    draws = {"idx": torch.tensor([1, 1]), "flip": torch.tensor([False, True])}
    crops = procedural.crops_from_draws(p0, draws)
    assert torch.equal(crops[1], torch.flip(crops[0], dims=[1]))
    assert torch.equal(crops[0], p0[1].float() / 255.0)
