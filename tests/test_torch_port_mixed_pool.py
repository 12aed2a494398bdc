"""The port's mixed procedural corpus (``dbsr_tpu_torch.data.procedural``)
against the JAX package on CPU, float32.

Each generator's draws are made with ``jax.random`` by walking the JAX
generator's own key tree (the helpers below, as
``test_torch_port_synthesis.py`` does for dead leaves) and handed to the
port's ``..._from_draws``: both sides render from the same numbers. Limit:
``IMG_ATOL`` = 5e-6 on the [0, 1] image at two small sizes (XLA's float32
sin, cos, exp and pow against the port's float64-evaluated ones, a few
ulps). The plan of the mixed pool (``_mix_plan``, numpy) is bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbsr_tpu.data import procedural as jproc
from dbsr_tpu_torch.data import procedural

IMG_ATOL = 5e-6
SIZES = [(0, (32, 32)), (1, (24, 40))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this module runs (the suite runs
    in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _octaves(key, bases):
    return [_t(jax.random.uniform(jax.random.fold_in(key, o), (b, b, 3),
                                  jnp.float32))[None]
            for o, b in enumerate(bases)]


def jax_hard_edges_draws(key, num_shapes=procedural.NUM_SHAPES):
    """The draws of ``jproc.hard_edges_image(key, ...)``."""
    k_bg, k_shapes, k_blur = jax.random.split(key, 3)
    us, colors = [], []
    for i in range(num_shapes):
        k = jax.random.fold_in(k_shapes, i)
        us.append(jax.random.uniform(k, (9,), jnp.float32))
        colors.append(jax.random.uniform(jax.random.fold_in(k, 1), (3,),
                                         jnp.float32, 0.0, 1.0))
    return {"bg": _t(jax.random.uniform(k_bg, (3,), jnp.float32, 0.0,
                                        1.0))[None],
            "shape_u": _t(jnp.stack(us))[None],
            "shape_color": _t(jnp.stack(colors))[None],
            "sigma": _t(jax.random.uniform(k_blur, (), jnp.float32,
                                           *procedural.EDGES_SIGMA))[None]}


def jax_gratings_draws(key, num_components=procedural.NUM_COMPONENTS):
    """The draws of ``jproc.gratings_image(key, ...)``."""
    k_comp, k_dc, k_blur = jax.random.split(key, 3)
    us, colors = [], []
    for i in range(num_components):
        k = jax.random.fold_in(k_comp, i)
        us.append(jax.random.uniform(k, (6,), jnp.float32))
        colors.append(jax.random.uniform(jax.random.fold_in(k, 1), (3,),
                                         jnp.float32, -1.0, 1.0))
    return {"dc": _t(jax.random.uniform(k_dc, (3,), jnp.float32, 0.25,
                                        0.75))[None],
            "comp_u": _t(jnp.stack(us))[None],
            "comp_color": _t(jnp.stack(colors))[None],
            "sigma": _t(jax.random.uniform(k_blur, (), jnp.float32,
                                           *procedural.GRATINGS_SIGMA))[None]}


def jax_smooth_gradients_draws(key):
    """The draws of ``jproc.smooth_gradients_image(key, ...)``."""
    k_noise, k_illum, k_gamma = jax.random.split(key, 3)
    return {"octaves": _octaves(k_noise, procedural.GRADIENT_BASES),
            "illum_dir": _t(jax.random.normal(k_illum, (2,)))[None],
            "gamma_u": _t(jax.random.uniform(k_gamma, (3,), jnp.float32,
                                             -0.5, 0.5))[None]}


def jax_noise_texture_draws(key):
    """The draws of ``jproc.noise_texture_image(key, ...)``."""
    k_noise, k_con, k_blur = jax.random.split(key, 3)
    return {"octaves": _octaves(k_noise, procedural.NOISE_BASES),
            "contrast": _t(jax.random.uniform(k_con, (), jnp.float32, 0.6,
                                              1.6))[None],
            "sigma": _t(jax.random.uniform(k_blur, (), jnp.float32,
                                           *procedural.NOISE_SIGMA))[None]}


GENERATORS = {
    "edges": (jproc.hard_edges_image, jax_hard_edges_draws,
              procedural.hard_edges_from_draws),
    "gratings": (jproc.gratings_image, jax_gratings_draws,
                 procedural.gratings_from_draws),
    "gradients": (jproc.smooth_gradients_image, jax_smooth_gradients_draws,
                  procedural.smooth_gradients_from_draws),
    "noise": (jproc.noise_texture_image, jax_noise_texture_draws,
              procedural.noise_texture_from_draws),
}


@pytest.mark.parametrize("seed,hw", SIZES)
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_matches_jax_from_its_draws(name, seed, hw):
    jax_fn, jax_draws, from_draws = GENERATORS[name]
    key = jax.random.key(seed)
    want = np.asarray(jax.jit(jax_fn, static_argnums=1)(key, hw))
    got = from_draws(jax_draws(key), hw)
    assert got.shape == (1,) + hw + (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=IMG_ATOL)


@pytest.mark.parametrize("name", sorted(procedural.GENERATORS))
def test_port_draws_render_batched_and_in_range(name):
    """The port's own draws: a batch of 3 renders as its images one by one,
    within [0, 1], and the same generator seed gives the same draws."""
    draw, render = procedural.GENERATORS[name]
    kw = {"num_leaves": 5} if name == "dead_leaves" else {}
    draws = draw(procedural.make_generator("cpu", 3), 3, **kw)
    again = draw(procedural.make_generator("cpu", 3), 3, **kw)
    for k, v in draws.items():
        for a, b in zip(v if isinstance(v, list) else [v],
                        again[k] if isinstance(v, list) else [again[k]]):
            assert torch.equal(a, b), k
    imgs = render(draws, (20, 28))
    assert imgs.shape == (3, 20, 28, 3)
    assert imgs.min() >= 0.0 and imgs.max() <= 1.0
    for i in range(3):
        one = {k: [o[i:i + 1] for o in v] if isinstance(v, list)
               else v[i:i + 1] for k, v in draws.items()}
        torch.testing.assert_close(render(one, (20, 28))[0], imgs[i],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_chunks,seed", [
    (1, 0), (2, 5), (3, 1), (4, 7), (5, 0), (8, 3), (20, 11), (64, 12345),
    (100, 2 ** 31 - 1)])
def test_mix_plan_is_bit_equal_to_jax(n_chunks, seed):
    got = procedural._mix_plan(n_chunks, seed)
    assert got == jproc._mix_plan(n_chunks, seed)
    assert len(got) == n_chunks
    assert set(got) <= set(procedural.GENERATORS)
    assert procedural.MIXED_RECIPE == jproc.MIXED_RECIPE


def test_mixed_pool_assigns_generators_per_chunk_and_repeats_per_round():
    """Image i of round r is rendered by ``plan[i // chunk]`` from its own
    ``(seed, r, i)`` stream: the pool equals each chunk rendered alone with
    the plan's generator, a second pool repeats it, and the next round takes
    the next seed's plan."""
    hw, chunk, n = (24, 24), 2, 7
    pool = procedural.ProceduralImagePool(n, hw, seed=4, chunk=chunk,
                                          device="cpu", num_leaves=3,
                                          mix="mixed")
    plan = pool.plan(0)
    assert plan == jproc._mix_plan(4, 4) and pool.plan(1) == \
        jproc._mix_plan(4, 5)
    p0 = pool.refresh(0)
    assert p0.dtype == torch.uint8 and p0.shape == (n,) + hw + (3,)
    for c, name in enumerate(plan):
        draw, render = procedural.GENERATORS[name]
        kw = {"num_leaves": 3} if name == "dead_leaves" else {}
        for i in range(c * chunk, min((c + 1) * chunk, n)):
            img = render(draw(procedural.make_generator("cpu", 4, 0, i), 1,
                              **kw), hw)
            assert torch.equal(p0[i], (img[0] * 255.0 + 0.5).to(torch.uint8))
    again = procedural.ProceduralImagePool(n, hw, seed=4, chunk=chunk,
                                           device="cpu", num_leaves=3,
                                           mix="mixed")
    assert torch.equal(again.refresh(0), p0)
    assert pool.refresh(0) is p0
    p1 = pool.refresh(1)
    assert not torch.equal(p1, p0)
    assert torch.equal(again.refresh(1), p1)


def test_dead_leaves_pool_is_unchanged_by_the_mix_option():
    """Any ``mix`` but ``'mixed'`` is dead leaves, as in the JAX package:
    the pool equals the dead-leaves images of each image's own stream,
    whatever the chunking."""
    hw = (20, 20)
    pools = [procedural.ProceduralImagePool(5, hw, seed=9, chunk=chunk,
                                            device="cpu", num_leaves=4,
                                            **kw).refresh(2)
             for chunk, kw in ((32, {}), (2, {"mix": "deadleaves"}),
                               (3, {"mix": "anything"}))]
    for p in pools[1:]:
        assert torch.equal(p, pools[0])
    for i in range(5):
        img = procedural.dead_leaves_image(
            procedural.make_generator("cpu", 9, 2, i), 1, hw, num_leaves=4)
        assert torch.equal(pools[0][i],
                           (img[0] * 255.0 + 0.5).to(torch.uint8))
