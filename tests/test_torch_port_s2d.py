"""The port's space-to-depth ("s2d") decoder path against the JAX package on
CPU, float32, same inputs made from a seed with numpy.

* ``ops/conv_s2d.py``: ``block_weight`` bit for bit; ``conv3x3_s2d_plain``
  against ``_conv3x3_block_impl`` run in interpret mode (atol 2e-4, rtol
  1e-4, as the JAX package's own test); the d_input rule and the
  ``Conv3x3S2D`` gradients (the plain version on the CPU) against
  ``jax.grad`` of the fine-resolution conv (atol 2e-3, rtol 1e-4, as
  there); the dispatch with ``DBSR_FINE_PATCH_S2D`` on and off; what the
  ``Function`` keeps for the backward.
* ``models/layers.py``: ``s2d_conv_kernel``, ``s2d_shuffle_permutation`` and
  ``depth_to_space_phase_major`` equal to JAX's; ``ConvBlock``,
  ``ResBlock`` and ``PixShuffleUpsampler`` in s2d form against their flax
  counterparts (atol 1e-5), the blur included.
* ``models/dbsr.py``: the tiny network and the banked flagship with the s2d
  decoder against JAX's (2e-4), a fresh s2d network equal to a fresh fine
  one, and one tiny train step against ``jax.value_and_grad`` (rtol 1e-4 /
  atol 1e-6 per tensor) with the switch on and off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbsr_tpu.models import layers as jlayers
from dbsr_tpu.models.dbsr import dbsrnet_tiny as jax_dbsrnet_tiny
from dbsr_tpu.ops.conv_s2d_pallas import _conv3x3_block_impl
from dbsr_tpu.ops.conv_s2d_pallas import block_weight as jax_block_weight
from dbsr_tpu.training import actors as jactors
from dbsr_tpu.training.checkpoint import load_network as jax_load_network
from dbsr_tpu_torch.data.procedural import make_generator
from dbsr_tpu_torch.models import layers
from dbsr_tpu_torch.models.dbsr import dbsrnet_tiny
from dbsr_tpu_torch.ops import conv_s2d
from dbsr_tpu_torch.ops.conv_s2d import (FINE_PATCH_ENV, Conv3x3S2D,
                                         block_weight, conv3x3_s2d,
                                         conv3x3_s2d_auto, conv3x3_s2d_plain,
                                         rotate_weight)
from dbsr_tpu_torch.training.actors import make_synthetic_actor
from dbsr_tpu_torch.training.checkpoint import load_network
from dbsr_tpu_torch.utils.convert import params_from_flax, params_to_flax

FLAGSHIP = "dbsr_tpu/artifacts/campaigns/dbsr_campaign_r5_best_params.ckpt"
FWD = dict(atol=2e-4, rtol=1e-4)    # tests/test_conv_s2d_pallas.py:49-50
GRAD = dict(atol=2e-3, rtol=1e-4)   # tests/test_conv_s2d_pallas.py:86-102


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
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _j(a):
    """A JAX array of its own copy of ``a`` (JAX may alias numpy buffers)."""
    return jnp.array(np.array(a))


def _oihw(k):
    """HWIO numpy kernel -> the port's OIHW tensor."""
    return _t(np.asarray(k).transpose(3, 2, 0, 1))


def _data(seed, shape=(2, 16, 16, 128), O=32):
    rng = np.random.RandomState(seed)
    C = shape[-1] // 4
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(3, 3, C, O) * 0.1).astype(np.float32)
    return x, k


def _space_to_depth_pm(x, r=2):
    B, H, W, c = x.shape
    x = x.reshape(B, H // r, r, W // r, r, c)
    x = jnp.moveaxis(x, (2, 4), (3, 4))
    return x.reshape(B, H // r, W // r, r * r * c)


def _fine_conv(x_fine, k):
    return jax.lax.conv_general_dilated(
        x_fine, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)


def _oracle(x, k):
    """The fine-resolution conv of the unfolded s2d input, folded back."""
    return _space_to_depth_pm(_fine_conv(
        jlayers.depth_to_space_phase_major(x, 2), k))


SHAPES = [((2, 16, 16, 128), 32),   # the decoder's C = O = 32
          ((2, 6, 10, 64), 24)]     # C = 16, O = 24; H2 != W2


# ---------------------------------------------------------------------------
# ops/conv_s2d.py


@pytest.mark.parametrize("C,O", [(32, 32), (5, 7)])
def test_block_weight_is_bit_equal_to_jax(C, O):
    k = np.random.RandomState(C).randn(3, 3, C, O).astype(np.float32)
    want = np.asarray(jax_block_weight(_j(k)))
    got = block_weight(_oihw(k)).numpy()
    assert got.shape == (16 * C, 4 * O)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,O", SHAPES)
def test_plain_matches_pallas_interpret_and_fine_conv(shape, O):
    x, k = _data(1, shape, O)
    want = _conv3x3_block_impl(_j(x), jax_block_weight(_j(k)), interpret=True)
    got = conv3x3_s2d_plain(_t(x), _oihw(k))
    assert got.shape == shape[:3] + (4 * O,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(got.numpy(), np.asarray(_oracle(_j(x), _j(k))),
                               **FWD)


@pytest.mark.parametrize("shape,O", SHAPES)
def test_gradients_match_jax_grad_of_fine_conv(shape, O):
    """d_input (the plain version with the rotated weight), and
    ``Conv3x3S2D``'s dx and dk on the CPU, against ``jax.grad`` of the
    fine-resolution conv."""
    x, k = _data(3, shape, O)
    cot = np.random.RandomState(4).randn(*shape[:3], 4 * O).astype(np.float32)
    dx_o, dk_o = jax.grad(lambda a, b: (_oracle(a, b) * _j(cot)).sum(),
                          argnums=(0, 1))(_j(x), _j(k))
    dx_rule = conv3x3_s2d_plain(_t(cot), rotate_weight(_oihw(k)))
    np.testing.assert_allclose(dx_rule.numpy(), np.asarray(dx_o), **GRAD)

    xt = _t(x).requires_grad_(True)
    kt = _oihw(k).requires_grad_(True)
    out = conv3x3_s2d(xt, kt)
    assert type(out.grad_fn).__name__ == "Conv3x3S2DBackward"
    out.backward(_t(cot))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_o), **GRAD)
    np.testing.assert_allclose(kt.grad.numpy(),
                               np.asarray(dk_o).transpose(3, 2, 0, 1), **GRAD)


def test_auto_gives_the_same_with_the_switch_on_and_off(monkeypatch):
    x, k = _data(5)
    want = np.asarray(_oracle(_j(x), _j(k)))
    outs = {}
    for env in ("1", "0", None):
        if env is None:
            monkeypatch.delenv(FINE_PATCH_ENV, raising=False)
        else:
            monkeypatch.setenv(FINE_PATCH_ENV, env)
        calls = []
        fn = conv_s2d.conv3x3_s2d_plain
        monkeypatch.setattr(conv_s2d, "conv3x3_s2d_plain",
                            lambda *a: calls.append(1) or fn(*a))
        outs[env] = conv3x3_s2d_auto(_t(x), _oihw(k)).numpy()
        assert len(calls) == int(env == "1"), env  # fine patch: plain on CPU
        monkeypatch.setattr(conv_s2d, "conv3x3_s2d_plain", fn)
        np.testing.assert_allclose(outs[env], want, **FWD)
    np.testing.assert_allclose(outs["1"], outs[None], atol=1e-5)
    np.testing.assert_array_equal(outs["0"], outs[None])
    np.testing.assert_allclose(
        conv3x3_s2d_auto(_t(x), _oihw(k), force=True).numpy(), outs["1"],
        atol=0)


@pytest.mark.parametrize("needs", [(True, True), (True, False),
                                   (False, True)])
def test_function_keeps_only_what_its_backward_reads(needs):
    x, k = _data(6, (1, 4, 4, 16), 4)
    xt = _t(x).requires_grad_(needs[0])
    kt = _oihw(k).requires_grad_(needs[1])
    out = conv3x3_s2d(xt, kt)
    x_saved, w_saved = out.grad_fn.saved_tensors
    assert (x_saved is None) == (not needs[1])  # d_kernel reads x
    assert (w_saved is None) == (not needs[0])  # d_input reads the weight
    out.sum().backward()
    assert (xt.grad is None) == (not needs[0])
    assert (kt.grad is None) == (not needs[1])


def test_function_saves_nothing_without_gradient(monkeypatch):
    x, k = _data(7, (1, 4, 4, 16), 4)
    xt, kt = _t(x).requires_grad_(True), _oihw(k).requires_grad_(True)
    applied = []
    apply = Conv3x3S2D.apply
    monkeypatch.setattr(Conv3x3S2D, "apply",
                        lambda *a: applied.append(1) or apply(*a))
    with torch.no_grad():
        out = conv3x3_s2d(xt, kt)
    assert out.grad_fn is None and not applied
    with torch.inference_mode():
        assert conv3x3_s2d(xt, kt).grad_fn is None and not applied
    assert conv3x3_s2d(xt.detach(), kt.detach()).grad_fn is None
    assert not applied
    conv3x3_s2d(xt, kt)
    assert applied == [1]


def test_cuda_requests_raise_without_falling_back():
    """A tensor off the CPU launches the kernel or raises: no dense
    fallback, with the switch forced or not."""
    x = torch.empty(1, 4, 4, 16, device="meta")
    w = torch.empty(8, 4, 3, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        conv3x3_s2d_auto(x, w, force=True)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        conv_s2d.conv3x3_s2d_forward(x, w)
    with pytest.raises(ValueError, match=r"\[O,C,3,3\]"):
        conv_s2d.conv3x3_s2d_forward(torch.zeros(1, 4, 4, 16),
                                     torch.zeros(8, 5, 3, 3))


# ---------------------------------------------------------------------------
# models/layers.py


@pytest.mark.parametrize("ksz", [1, 3])
def test_s2d_conv_kernel_is_bit_equal_to_jax(ksz):
    k = np.random.RandomState(ksz).randn(ksz, ksz, 6, 5).astype(np.float32)
    want = np.asarray(jlayers.s2d_conv_kernel(_j(k))).transpose(3, 2, 0, 1)
    got = layers.s2d_conv_kernel(_oihw(k)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c_out,r", [(32, 8), (3, 4), (2, 2)])
def test_s2d_shuffle_permutation_equals_jax(c_out, r):
    want = np.asarray(jlayers.s2d_shuffle_permutation(c_out, r))
    np.testing.assert_array_equal(
        layers.s2d_shuffle_permutation(c_out, r).numpy(), want)


@pytest.mark.parametrize("shape", [(2, 3, 5, 12), (3, 2, 4, 4, 8)])
def test_depth_to_space_phase_major_equals_jax(shape):
    x = np.random.RandomState(8).randn(*shape).astype(np.float32)
    want = np.asarray(jlayers.depth_to_space_phase_major(_j(x), 2))
    got = layers.depth_to_space_phase_major(_t(x))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        layers.space_to_depth_phase_major(got).numpy(), x)


def _random_params(shapes, seed):
    """Flax parameter tree of ``shapes`` with U[-1/sqrt(fan_in), +] draws."""
    rng = np.random.RandomState(seed)

    def fill(node, fan_in=None):
        out = {}
        kernel = node.get("kernel")
        if kernel is not None:
            kh, kw, cin, _ = kernel.shape
            fan_in = kh * kw * cin
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            else:
                b = 1.0 / np.sqrt(fan_in)
                out[k] = rng.uniform(-b, b, v.shape).astype(np.float32)
        return out

    return fill(shapes)


def _module_pair(jmod, mod, x, seed):
    params = _random_params(
        jax.eval_shape(jmod.init, jax.random.key(0), _j(x)), seed)
    want = jmod.apply(jax.tree.map(_j, params), _j(x))
    mod.load_state_dict(params_from_flax(params), strict=True)
    with torch.no_grad():
        got = mod(_t(x))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("ksz,act", [(3, "relu"), (1, "none")])
def test_s2d_conv_block_matches_jax(ksz, act, monkeypatch):
    monkeypatch.delenv(FINE_PATCH_ENV, raising=False)
    x = np.random.RandomState(9).randn(2, 6, 8, 4 * 6).astype(np.float32)
    got, want = _module_pair(
        jlayers.ConvBlock(5, ksz, activation=act, s2d=True),
        layers.ConvBlock(6, 5, ksz, activation=act, s2d=True), x, 10)
    assert got.shape == (2, 6, 8, 20)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("fine_patch", ["1", "0"])
def test_s2d_res_block_matches_jax(fine_patch, monkeypatch):
    monkeypatch.setenv(FINE_PATCH_ENV, fine_patch)
    x = np.random.RandomState(11).randn(2, 8, 8, 32).astype(np.float32)
    got, want = _module_pair(jlayers.ResBlock(8, s2d=True),
                             layers.ResBlock(8, s2d=True), x, 12)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("blur", [1.0, None])
def test_s2d_upsampler_matches_jax_with_its_blur(blur):
    """The JAX package blurs the s2d output with a dense block-diagonal
    conv; the port blurs depthwise at fine resolution."""
    x = np.random.RandomState(13).randn(2, 6, 5, 16).astype(np.float32)
    got, want = _module_pair(
        jlayers.PixShuffleUpsampler(4, 8, icnrinit=True, gauss_blur_sd=blur,
                                    s2d_output=True),
        layers.PixShuffleUpsampler(16, 4, 8, icnrinit=True,
                                   gauss_blur_sd=blur, s2d_output=True),
        x, 14)
    assert got.shape == (2, 24, 20, 16)
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------------------------------
# models/dbsr.py


def _burst(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.fixture(scope="module")
def tiny_forward():
    """The JAX tiny network with the s2d decoder: input, parameters and
    output (compiled once for the cases below)."""
    x = _burst((2, 3, 16, 16, 4), 0)
    jnet = jax_dbsrnet_tiny(flow_net="lite", fused_s2d_decoder=True)
    params = _random_params(
        jax.eval_shape(jnet.init, jax.random.key(0), _j(x)), 1)
    want, _ = jax.jit(jnet.apply)(jax.tree.map(_j, params), _j(x))
    return x, params, np.asarray(want)


@pytest.mark.parametrize("fine_patch", ["1", "0"])
def test_dbsrnet_tiny_s2d_matches_jax(fine_patch, tiny_forward, monkeypatch):
    monkeypatch.setenv(FINE_PATCH_ENV, fine_patch)
    x, params, want = tiny_forward
    net = dbsrnet_tiny(fused_s2d_decoder=True)
    net.load_state_dict(params_from_flax(params), strict=True)
    launches = conv3x3_s2d.launches
    with torch.no_grad():
        got, _ = net.eval()(_t(x))
    assert got.shape == (2, 128, 128, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    assert conv3x3_s2d.launches == launches  # the CPU runs no kernel


def test_flagship_banked_s2d_decoder_matches_jax(monkeypatch):
    """Full width, epoch-60 params, the decoder form the checkpoint's header
    records (``fused_s2d_decoder: true``) in both packages."""
    monkeypatch.delenv(FINE_PATCH_ENV, raising=False)
    x = _burst((1, 3, 16, 16, 4), 2)
    jnet, jparams, _ = jax_load_network(FLAGSHIP, dtype=None)
    assert jnet.fused_s2d_decoder
    want, _ = jax.jit(jnet.apply)(jparams, _j(x))
    net, header = load_network(FLAGSHIP, device="cpu", dtype=None)
    assert header["net_spec"]["kwargs"]["fused_s2d_decoder"]
    assert net.decoder.s2d
    with torch.no_grad():
        got, _ = net(_t(x))
    diff = np.abs(got.numpy() - np.asarray(want))
    assert diff.max() <= 2e-4, (diff.max(), int((diff > 2e-4).sum()))


def test_fresh_s2d_and_fine_networks_are_identical():
    nets = []
    for s2d in (True, False):
        net = dbsrnet_tiny(fused_s2d_decoder=s2d)
        layers.init_params(net, make_generator("cpu", 3))
        nets.append(net.eval())
    a, b = (n.state_dict() for n in nets)
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    x = _t(_burst((1, 3, 16, 16, 4), 4))
    with torch.no_grad():
        np.testing.assert_allclose(nets[0](x)[0].numpy(),
                                   nets[1](x)[0].numpy(), atol=1e-5)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def tiny_step():
    """One train step of the JAX tiny network with the s2d decoder: batch,
    parameters, loss and gradients by flax path (compiled once)."""
    rng = np.random.RandomState(14)
    batch = {"burst": rng.rand(2, 3, 16, 16, 4).astype(np.float32),
             "frame_gt": rng.rand(2, 128, 128, 3).astype(np.float32)}
    jbatch = {k: _j(v) for k, v in batch.items()}
    jnet = jax_dbsrnet_tiny(flow_net="lite", fused_s2d_decoder=True)
    params = _random_params(
        jax.eval_shape(jnet.init, jax.random.key(0), jbatch["burst"]), 15)
    actor = jactors.make_synthetic_actor(jnet, boundary_ignore=40)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: actor(p, jbatch), has_aux=True))(jax.tree.map(_j, params))
    return batch, params, float(jloss), _leaves(jgrads["params"])


@pytest.mark.parametrize("fine_patch", ["1", "0"])
def test_tiny_train_step_with_s2d_decoder_matches_jax(fine_patch, tiny_step,
                                                      monkeypatch):
    monkeypatch.setenv(FINE_PATCH_ENV, fine_patch)
    batch, params, jloss, want = tiny_step
    net = dbsrnet_tiny(fused_s2d_decoder=True)
    net.load_state_dict(params_from_flax(params), strict=True)
    loss, _ = make_synthetic_actor(net, boundary_ignore=40)(
        {k: _t(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    got = _leaves(params_to_flax({k: p.grad for k, p in net.named_parameters()
                                  if p.requires_grad}))
    aligner = {k for k in want if "alignment_net" in k}
    assert aligner and set(got) == set(want) - aligner
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
