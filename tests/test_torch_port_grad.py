"""The port's gradients against the JAX package on CPU, float32.

* The explicit plain backward of each kernel (``warp_feat_backward_plain``,
  ``fused_softmax_merge_backward_plain``) against the Pallas backward body
  in interpret mode, and against ``torch.autograd.grad`` of the plain
  forward. Tolerance rtol 1e-5 / atol 1e-6 for d_feat and the merge (sums in
  another order), atol 1e-5 for d_flow (a sum over the channels of
  products of order 1, as the JAX package's own test of the body).
* The ``autograd.Function`` of the warp and the merge on CPU tensors: the
  plain backward runs through the same ``Function`` the kernels use, and
  d_flow is computed only when the flow needs a gradient.
* One train step of the tiny DBSRNet (AlignLite aligner, frozen) against
  ``jax.value_and_grad`` of the JAX actor, by flax path (rtol 1e-4 /
  atol 1e-6), and three Adam steps against the JAX package's masked Adam
  (atol 1e-6), with the aligner's parameters unchanged.
* The step-indexed StepLR schedule against the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbsr_tpu.models.dbsr import dbsrnet_tiny as jax_dbsrnet_tiny
from dbsr_tpu.ops.merge_pallas import _merge_bwd_impl
from dbsr_tpu.ops.warp_pallas import _warp_bwd_pallas
from dbsr_tpu.training import actors as jactors
from dbsr_tpu.training import state as jstate
from dbsr_tpu_torch.models.dbsr import dbsrnet_tiny
from dbsr_tpu_torch.models.layers import init_params
from dbsr_tpu_torch.data.procedural import make_generator
from dbsr_tpu_torch.ops import merge as merge_ops
from dbsr_tpu_torch.ops import warp as warp_ops
from dbsr_tpu_torch.ops.merge import (fused_softmax_merge,
                                      fused_softmax_merge_backward_plain,
                                      fused_softmax_merge_plain)
from dbsr_tpu_torch.ops.warp import (warp_feat, warp_feat_backward_plain,
                                     warp_feat_plain)
from dbsr_tpu_torch.training.actors import make_synthetic_actor
from dbsr_tpu_torch.training.state import make_optimizer, step_lr_schedule
from dbsr_tpu_torch.utils.convert import params_from_flax, params_to_flax

RTOL, ATOL = 1e-5, 1e-6
DFLOW_ATOL = 1e-5


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
    """A JAX array of its own copy of ``a``: JAX on the CPU may alias a
    numpy buffer, and PyTorch reading the same buffer meanwhile was seen to
    get values off by ~1e-4 relative."""
    return jnp.array(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _flow(kind, rng, shape):
    if kind == "random":  # out-of-range taps at the borders
        return (rng.rand(*shape) * 10 - 5).astype(np.float32)
    if kind == "integer":  # taps on exact pixel centres
        return rng.randint(-5, 6, size=shape).astype(np.float32)
    if kind == "out_of_range":
        return np.full(shape, 20.0, np.float32)
    raise ValueError(kind)


def _autograd(fn, inputs, g):
    xs = [x.clone().requires_grad_(True) for x in inputs]
    return torch.autograd.grad(fn(*xs), xs, g)


@pytest.mark.parametrize("kind", ["random", "integer", "out_of_range"])
def test_warp_backward_plain_matches_pallas_interpret(kind):
    rng = np.random.RandomState(10)
    feat = rng.randn(2, 16, 8, 32).astype(np.float32)
    flow = _flow(kind, rng, (2, 16, 8, 2))
    g = rng.randn(2, 16, 8, 32).astype(np.float32)
    want_df, want_dfl = _warp_bwd_pallas(_j(feat), _j(flow),
                                         _j(g), interpret=True)
    df, dfl = warp_feat_backward_plain(_t(feat), _t(flow), _t(g))
    _close(df, want_df)
    _close(dfl, want_dfl, atol=DFLOW_ATOL)
    # the same two gradients as autograd through the plain forward
    adf, adfl = _autograd(warp_feat_plain, (_t(feat), _t(flow)), _t(g))
    _close(df, adf)
    _close(dfl, adfl, atol=DFLOW_ATOL)


def test_warp_dflow_is_the_one_sided_difference_at_integers():
    """At an integer coordinate the floor-tap derivative along x is
    ``feat[i+1] - feat[i]``, not 0 or a central difference."""
    feat = torch.arange(24, dtype=torch.float32).reshape(1, 2, 3, 4) ** 2
    flow = torch.zeros(1, 2, 3, 2)
    g = torch.zeros(1, 2, 3, 4)
    g[0, 0, 1, 0] = 1.0
    _, dflow = warp_feat_backward_plain(feat, flow, g)
    assert dflow[0, 0, 1, 0] == feat[0, 0, 2, 0] - feat[0, 0, 1, 0]
    assert dflow[0, 0, 1, 1] == feat[0, 1, 1, 0] - feat[0, 0, 1, 0]


@pytest.mark.parametrize("n", [3, 8])
def test_merge_backward_plain_matches_pallas_interpret(n):
    rng = np.random.RandomState(11)
    feat = rng.randn(2, n, 16, 8, 16).astype(np.float32)
    logits = (3 * rng.randn(2, n, 16, 8, 16)).astype(np.float32)
    g = rng.randn(2, 16, 8, 16).astype(np.float32)
    want_df, want_dl = _merge_bwd_impl(_j(feat), _j(logits),
                                       _j(g), interpret=True)
    df, dl = fused_softmax_merge_backward_plain(_t(feat), _t(logits), _t(g))
    _close(df, want_df)
    _close(dl, want_dl)
    adf, adl = _autograd(fused_softmax_merge_plain, (_t(feat), _t(logits)),
                         _t(g))
    _close(df, adf)
    _close(dl, adl)


@pytest.mark.parametrize("flow_grad", [False, True])
def test_warp_function_on_cpu_runs_plain_backward(monkeypatch, flow_grad):
    """The wrapper's ``Function`` on CPU tensors: d_feat always, d_flow only
    when the flow needs a gradient (as under the frozen aligner)."""
    rng = np.random.RandomState(12)
    feat = _t(rng.randn(2, 8, 8, 8)).requires_grad_(True)
    flow = _t(_flow("random", rng, (2, 8, 8, 2))).requires_grad_(flow_grad)
    g = _t(rng.randn(2, 8, 8, 8))
    calls = []
    dflow_fn = warp_ops.warp_dflow
    monkeypatch.setattr(warp_ops, "warp_dflow",
                        lambda *a: calls.append(1) or dflow_fn(*a))
    out = warp_feat(feat, flow)
    assert out.grad_fn is not None
    # feat is kept for the backward only when d_flow will read it
    assert (out.grad_fn.saved_tensors[0] is None) == (not flow_grad)
    out.backward(g)
    want_df, want_dfl = warp_feat_backward_plain(feat.detach(), flow.detach(),
                                                 g)
    assert torch.equal(feat.grad, want_df)
    assert len(calls) == int(flow_grad)
    if flow_grad:
        assert torch.equal(flow.grad, want_dfl)
    else:
        assert flow.grad is None


def test_merge_function_on_cpu_runs_plain_backward():
    rng = np.random.RandomState(13)
    feat = _t(rng.randn(1, 4, 6, 6, 8)).requires_grad_(True)
    logits = _t(rng.randn(1, 4, 6, 6, 8)).requires_grad_(True)
    g = _t(rng.randn(1, 6, 6, 8))
    counts = (fused_softmax_merge.launches, merge_ops.merge_backward.launches)
    out = fused_softmax_merge(feat, logits)
    assert torch.equal(out, fused_softmax_merge_plain(feat, logits))
    out.backward(g)
    want_df, want_dl = fused_softmax_merge_backward_plain(
        feat.detach(), logits.detach(), g)
    assert torch.equal(feat.grad, want_df)
    assert torch.equal(logits.grad, want_dl)
    assert counts == (fused_softmax_merge.launches,
                      merge_ops.merge_backward.launches)


@pytest.mark.parametrize("op", ["dfeat", "dflow", "merge_backward"])
def test_backward_wrappers_raise_off_cpu_without_cuda(op):
    m4 = torch.empty(1, 8, 8, 8, device="meta")
    f2 = torch.empty(1, 8, 8, 2, device="meta")
    m5 = torch.empty(1, 3, 8, 8, 8, device="meta")
    call = {"dfeat": lambda: warp_ops.warp_dfeat(f2, m4),
            "dflow": lambda: warp_ops.warp_dflow(m4, f2, m4),
            "merge_backward": lambda: merge_ops.merge_backward(m5, m5, m4)}
    with pytest.raises(ValueError, match="CUDA or CPU"):
        call[op]()


# ---------------------------------------------------------------------------
# one train step of the tiny network against the JAX package


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


def _tiny_problem():
    rng = np.random.RandomState(14)
    batch = {"burst": rng.rand(2, 3, 16, 16, 4).astype(np.float32),
             "frame_gt": rng.rand(2, 128, 128, 3).astype(np.float32)}
    jnet = jax_dbsrnet_tiny(flow_net="lite")
    shapes = jax.eval_shape(jnet.init, jax.random.key(0),
                            _j(batch["burst"]))
    params = _random_params(shapes, 15)
    net = dbsrnet_tiny()
    net.load_state_dict(params_from_flax(params), strict=True)
    return jnet, jax.tree.map(_j, params), net, batch


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_step(jnet, jbatch):
    actor = jactors.make_synthetic_actor(jnet, boundary_ignore=40)
    return jax.jit(jax.value_and_grad(lambda p: actor(p, jbatch),
                                      has_aux=True))


def test_train_step_loss_and_gradients_match_jax():
    jnet, params, net, batch = _tiny_problem()
    jbatch = {k: _j(v) for k, v in batch.items()}
    (jloss, jstats), jgrads = _jax_step(jnet, jbatch)(params)

    actor = make_synthetic_actor(net, boundary_ignore=40)
    loss, stats = actor({k: _t(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(stats["Stat/psnr"].item(),
                               float(jstats["Stat/psnr"]), rtol=1e-5)

    want = _leaves(jgrads["params"])
    got = _leaves(params_to_flax({k: p.grad for k, p in net.named_parameters()
                                  if p.requires_grad}))
    aligner = {k for k in want if "alignment_net" in k}
    assert aligner and set(got) == set(want) - aligner
    for k in aligner:  # stop_gradient in JAX, requires_grad False here
        assert not np.any(want[k]), k
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_three_adam_steps_match_jax_masked_adam():
    """Steps per epoch 2 and a decay every epoch: the third update runs at
    the decayed rate."""
    jnet, params, net, batch = _tiny_problem()
    jbatch = {k: _j(v) for k, v in batch.items()}
    step = _jax_step(jnet, jbatch)
    tx = jstate.make_optimizer(base_lr=1e-4, step_size_epochs=1, gamma=0.2,
                               steps_per_epoch=2,
                               freeze_subtree="alignment_net")

    @jax.jit  # one compile of the whole update, not one per small op
    def update(p, opt):
        _, grads = step(p)
        updates, opt = tx.update(grads, opt, p)
        return jax.tree.map(jnp.add, p, updates), opt

    jparams, opt = params, tx.init(params)
    for _ in range(3):
        jparams, opt = update(jparams, opt)

    aligner_before = {k: v.clone() for k, v in net.state_dict().items()
                      if k.startswith("encoder.alignment_net")}
    state = make_optimizer(base_lr=1e-4, step_size_epochs=1, gamma=0.2,
                           steps_per_epoch=2).init(net)
    actor = make_synthetic_actor(net, boundary_ignore=40)
    tbatch = {k: _t(v) for k, v in batch.items()}
    for _ in range(3):
        state.optimizer.zero_grad(set_to_none=True)
        actor(tbatch)[0].backward()
        state.apply_gradients()
    assert state.step == 3

    want = _leaves(jparams["params"])
    got = _leaves(params_to_flax(net.state_dict()))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    for k, v in aligner_before.items():
        assert torch.equal(net.state_dict()[k], v), k


def test_adam_with_global_norm_clip_matches_optax():
    """``grad_clip``: the port clips the global gradient norm before Adam,
    as the JAX package's ``optax.clip_by_global_norm`` does; a step above
    the norm and two below it (atol 1e-6)."""
    rng = np.random.RandomState(21)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3))
    kw = dict(base_lr=1e-2, step_size_epochs=1, gamma=0.5, steps_per_epoch=2,
              clip_norm=0.05)
    state = make_optimizer(**kw).init(net)
    tx = jstate.make_optimizer(**kw)
    jparams = {k: _j(p.detach().numpy()) for k, p in net.named_parameters()}
    opt = tx.init(jparams)
    for scale in (10.0, 1e-3, 1e-3):  # global norms ~110 and ~0.01
        grads = {k: (rng.randn(*v.shape) * scale).astype(np.float32)
                 for k, v in jparams.items()}
        for k, p in net.named_parameters():
            p.grad = _t(grads[k])
        state.apply_gradients()
        updates, opt = tx.update({k: _j(g) for k, g in grads.items()}, opt,
                                 jparams)
        jparams = jax.tree.map(jnp.add, jparams, updates)
    for k, p in net.named_parameters():
        _close(p.detach().numpy(), jparams[k], rtol=0, atol=1e-6)


@pytest.mark.parametrize("count", [0, 1, 999, 1000, 1001, 39_999, 40_000,
                                   40_001, 79_999, 80_000, 120_000])
def test_step_lr_schedule_matches_jax(count):
    want = jstate.step_lr_schedule(1e-4, 40, 0.2, 1000)(count)
    got = step_lr_schedule(1e-4, 40, 0.2, 1000)(count)
    np.testing.assert_allclose(got, float(want), rtol=1e-6)


def test_fresh_init_has_the_jax_distributions():
    """A fresh port network: conv weights and biases within
    +-1/sqrt(fan_in); the pre-shuffle conv ICNR (each sub-kernel channel
    repeated r^2 times, no bias), as the JAX package initialises them."""
    net = dbsrnet_tiny()
    init_params(net, make_generator("cpu", 3))
    for name, m in net.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            fan_in = m.in_channels // m.groups * m.kernel_size[0] \
                * m.kernel_size[1]
            if name.endswith("PixShuffleUpsampler_0.Conv_0"):
                continue
            assert m.weight.abs().max() <= 1 / np.sqrt(fan_in), name
    up = net.decoder.PixShuffleUpsampler_0.Conv_0
    assert up.bias is None
    r2 = 64
    w = up.weight.detach()
    assert torch.equal(w, w[::r2].repeat_interleave(r2, dim=0))
    std = np.sqrt(2.0 / up.in_channels) / .87962566103423978
    assert w.abs().max() <= 2 * std
    again = dbsrnet_tiny()
    init_params(again, make_generator("cpu", 3))
    for (k, a), b in zip(net.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k
