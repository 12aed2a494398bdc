"""The port's aligner-training path against the JAX package on CPU, float32:
the cost volume's backward, AlignLite with its pyramid, the flow actor,
pretraining's Adam, checkpoints both ways, the graft, a trainable aligner
inside DBSRNet and the reference-offset noise.

Inputs are made from a numpy seed and handed to both packages; parameters
are random draws carried over with ``params_from_flax``. On the CPU the JAX
package runs its XLA formulations (shifted-window correlation, gather warp)
with autodiff, or the Pallas bodies in interpret mode where a test says so;
the port runs its plain PyTorch versions through the same
``autograd.Function`` the kernels use.

Tolerances: the explicit plain backwards against the Pallas bodies and
against ``jax.vjp`` rtol 1e-5 / atol 1e-6 (an 81-term float32 sum in another
order); forwards atol 1e-5; losses rtol 1e-5; gradients of a whole step
rtol 1e-4 / atol 1e-6 and parameters after Adam steps atol 1e-6, as
``tests/test_torch_port_grad.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbsr_tpu.configs.dbsr.default_synthetic import \
    graft_alignment_params as jax_graft
from dbsr_tpu.models.align_lite import AlignLiteNet as JaxAlignLiteNet
from dbsr_tpu.models.align_lite import BurstAlignLite as JaxBurstAlignLite
from dbsr_tpu.models.dbsr import dbsrnet_tiny as jax_dbsrnet_tiny
from dbsr_tpu.ops.correlation import (_correlation_pallas_bwd_impl,
                                      correlation_xla)
from dbsr_tpu.training import actors as jactors
from dbsr_tpu.training import state as jstate
from dbsr_tpu.training.checkpoint import load_network as jax_load_network
from dbsr_tpu_torch.configs.align_lite import pretrain_synthetic
from dbsr_tpu_torch.configs.dbsr import default_synthetic as config
from dbsr_tpu_torch.data.procedural import (ProceduralImagePool,
                                            ProceduralPoolBatcher,
                                            make_generator,
                                            make_pool_prepare_fn)
from dbsr_tpu_torch.data.synthetic import BurstConfig
from dbsr_tpu_torch.environment import Settings
from dbsr_tpu_torch.models.align_lite import AlignLiteNet, BurstAlignLite
from dbsr_tpu_torch.models.dbsr import dbsrnet_tiny
from dbsr_tpu_torch.ops import correlation as corr_ops
from dbsr_tpu_torch.ops.correlation import (correlation_dfirst_plain,
                                            correlation_dsecond_plain,
                                            correlation_plain, cost_volume)
from dbsr_tpu_torch.run_training import run_training
from dbsr_tpu_torch.training import checkpoint as ckpt
from dbsr_tpu_torch.training.actors import (make_lite_flow_actor,
                                            make_synthetic_actor,
                                            pack_flow_to)
from dbsr_tpu_torch.training.state import make_optimizer
from dbsr_tpu_torch.training.trainer import LoaderSpec, Trainer
from dbsr_tpu_torch.utils.convert import params_from_flax, params_to_flax

RTOL, ATOL = 1e-5, 1e-6


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
    """A JAX array of its own copy of ``a`` (JAX on the CPU may alias a
    numpy buffer that PyTorch reads meanwhile)."""
    return jnp.array(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


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


def _corr_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    first = rng.randn(*shape).astype(np.float32)
    second = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape[:3], 81).astype(np.float32)
    return first, second, g


# ---------------------------------------------------------------------------
# the cost volume's backward


@pytest.mark.parametrize("shape", [(2, 12, 12, 16), (1, 16, 9, 8)])
def test_correlation_backward_plain_matches_pallas_interpret(shape):
    """Planes inside the Pallas kernels' envelope (<= 16x16)."""
    first, second, g = _corr_inputs(shape, 30)
    want_df, want_ds = _correlation_pallas_bwd_impl(_j(first), _j(second),
                                                    _j(g), interpret=True)
    _close(correlation_dfirst_plain(_t(second), _t(g)), want_df)
    _close(correlation_dsecond_plain(_t(first), _t(g)), want_ds)


@pytest.mark.parametrize("shape", [(2, 24, 24, 12), (1, 10, 27, 6),
                                   (1, 3, 5, 4)])
def test_correlation_backward_plain_matches_jax_vjp(shape):
    """Planes the TPU kernels did not take (24x24), a non-square plane that
    is no multiple of the CUDA kernel's 4x8 tile, and one smaller than the
    +-4 window."""
    first, second, g = _corr_inputs(shape, 31)
    _, vjp = jax.vjp(correlation_xla, _j(first), _j(second))
    want_df, want_ds = vjp(_j(g))
    _close(correlation_dfirst_plain(_t(second), _t(g)), want_df)
    _close(correlation_dsecond_plain(_t(first), _t(g)), want_ds)


@pytest.mark.parametrize("needs", [(True, True), (True, False),
                                   (False, True)])
def test_cost_volume_function_on_cpu_runs_plain_backwards(monkeypatch, needs):
    """The ``Function`` on CPU tensors: a volume that needs a gradient carries
    the Function's ``grad_fn``, keeps each input only for the gradient that
    reads it, and its backward runs the explicit plain backwards, each only
    for an input that needs a gradient."""
    first, second, g = _corr_inputs((2, 9, 11, 6), 32)
    a = _t(first).requires_grad_(needs[0])
    b = _t(second).requires_grad_(needs[1])
    calls = []
    for name in ("correlation_dfirst_plain", "correlation_dsecond_plain"):
        fn = getattr(corr_ops, name)
        monkeypatch.setattr(
            corr_ops, name,
            lambda *args, _fn=fn, _n=name: calls.append(_n) or _fn(*args))
    counts = (cost_volume.launches, corr_ops.correlation_dfirst.launches,
              corr_ops.correlation_dsecond.launches)
    out = cost_volume(a, b)
    assert torch.equal(out, correlation_plain(a.detach(), b.detach()))
    assert type(out.grad_fn).__name__ == "_CorrelationBackward"
    saved = out.grad_fn.saved_tensors
    # d_second reads first, d_first reads second
    assert (saved[0] is None) == (not needs[1])
    assert (saved[1] is None) == (not needs[0])
    out.backward(_t(g))

    xs = (_t(first).requires_grad_(True), _t(second).requires_grad_(True))
    want = torch.autograd.grad(correlation_plain(*xs), xs, _t(g))
    for x, w, need in zip((a, b), want, needs):
        if need:
            _close(x.grad, w)
        else:
            assert x.grad is None
    assert calls == [n for n, need in
                     zip(("correlation_dfirst_plain",
                          "correlation_dsecond_plain"), needs) if need]
    assert counts == (cost_volume.launches,
                      corr_ops.correlation_dfirst.launches,
                      corr_ops.correlation_dsecond.launches)


def test_cost_volume_saves_nothing_without_gradient():
    first, second, _ = _corr_inputs((1, 8, 8, 4), 33)
    a, b = _t(first).requires_grad_(True), _t(second).requires_grad_(True)
    with torch.no_grad():
        out = cost_volume(a, b)
    assert out.grad_fn is None and not out.requires_grad
    out = cost_volume(a.detach(), b.detach())
    assert out.grad_fn is None and not out.requires_grad
    # a non-contiguous input (a repeated target pyramid) is taken
    rep = a.detach().permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    assert not rep.is_contiguous()
    assert torch.equal(cost_volume(rep, b.detach()), out)


@pytest.mark.parametrize("op", ["dfirst", "dsecond", "shape"])
def test_correlation_backward_wrappers_raise(op):
    m4 = torch.empty(1, 8, 8, 8, device="meta")
    g = torch.empty(1, 8, 8, 81, device="meta")
    if op == "shape":
        with pytest.raises(ValueError, match=r"\[B,H,W,81\]"):
            corr_ops.correlation_dfirst(torch.zeros(1, 8, 8, 8),
                                        torch.zeros(1, 8, 8, 80))
        return
    fn = {"dfirst": corr_ops.correlation_dfirst,
          "dsecond": corr_ops.correlation_dsecond}[op]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fn(m4, g)


# ---------------------------------------------------------------------------
# AlignLite with its pyramid, BurstAlignLite


def _burst_problem(seed=40, shape=(2, 3, 16, 16, 4)):
    rng = np.random.RandomState(seed)
    burst = rng.rand(*shape).astype(np.float32)
    jnet = JaxBurstAlignLite()
    shapes = jax.eval_shape(jnet.init, jax.random.key(0), _j(burst))
    params = _random_params(shapes, seed + 1)
    net = BurstAlignLite()
    net.load_state_dict(params_from_flax(params), strict=True)
    return jnet, jax.tree.map(_j, params), net, burst


def test_align_lite_pyramid_matches_jax():
    jnet, params, net, burst = _burst_problem()
    rgb = np.random.RandomState(42).rand(2, 3, 16, 16, 3).astype(np.float32)
    src = rgb[:, 1:].reshape(4, 16, 16, 3)
    want, waux = jax.jit(lambda p, s, t: JaxAlignLiteNet().apply(
        {"params": p}, s, t, return_pyramid=True, target_repeat=2))(
        params["params"]["alignment_net"], _j(src), _j(rgb[:, 0]))
    with torch.no_grad():
        got, aux = net.alignment_net(_t(src), _t(rgb[:, 0]), target_repeat=2,
                                     return_pyramid=True)
        alone = net.alignment_net(_t(src), _t(rgb[:, 0]), target_repeat=2)
    assert torch.equal(got, alone)
    _close(got, want, rtol=0, atol=1e-5)
    assert set(aux["pyramid"]) == {0, 1, 2}
    for lvl, f in aux["pyramid"].items():
        assert tuple(f.shape) == (4, 16 >> lvl, 16 >> lvl, 2)
        _close(f, waux["pyramid"][lvl], rtol=0, atol=1e-5, msg=f"level {lvl}")
    # the refined full-resolution flow is pyramid level 0
    assert torch.equal(aux["pyramid"][0], got)


def test_burst_align_lite_matches_jax():
    jnet, params, net, burst = _burst_problem()
    want, waux = jax.jit(lambda p, b: jnet.apply(p, b, return_pyramid=True))(
        params, _j(burst))
    with torch.no_grad():
        got, aux = net(_t(burst), return_pyramid=True)
        alone = net(_t(burst))
    assert tuple(got.shape) == (2, 2, 16, 16, 2) and torch.equal(got, alone)
    _close(got, want, rtol=0, atol=1e-5)
    for lvl in (0, 1, 2):
        _close(aux["pyramid"][lvl], waux["pyramid"][lvl], rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="packed burst"):
        net(torch.zeros(2, 16, 16, 4))
    with pytest.raises(NotImplementedError, match="bfloat16"):
        BurstAlignLite(dtype="bfloat16")


# ---------------------------------------------------------------------------
# the flow actor, pretraining's Adam


def test_pack_flow_to_matches_jax():
    flow = np.random.RandomState(43).randn(2, 3, 32, 16, 2).astype(np.float32)
    for hw in ((16, 8), (8, 4), (32, 16)):
        _close(pack_flow_to(_t(flow), hw), jactors.pack_flow_to(_j(flow), hw))
    with pytest.raises(ValueError, match="does not pool"):
        pack_flow_to(_t(flow), (12, 8))


def _flow_batch(seed=44, shape=(2, 3, 16, 16, 4)):
    rng = np.random.RandomState(seed)
    B, N, h, w, _ = shape
    return {"burst": rng.rand(*shape).astype(np.float32),
            # dense LR-grid flow of all N frames, a few pixels
            "flow": (2.0 * rng.randn(B, N, 2 * h, 2 * w, 2)).astype(
                np.float32)}


@pytest.mark.parametrize("shape", [(2, 3, 16, 16, 4), (1, 4, 16, 32, 4)])
def test_lite_flow_actor_loss_stats_and_gradients_match_jax(shape):
    """The multi-scale loss (the JAX actor's default, which its pretraining
    uses), on a square burst and on a wider one of four frames."""
    jnet, params, net, _ = _burst_problem(45)
    batch = _flow_batch(shape=shape)
    jactor = jactors.make_lite_flow_actor(jnet)
    jbatch = {k: _j(v) for k, v in batch.items()}
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jactor(p, jbatch), has_aux=True))(params)

    actor = make_lite_flow_actor(net)
    loss, stats = actor({k: _t(v) for k, v in batch.items()})
    loss.backward()
    assert set(stats) == set(jstats)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in stats:
        assert not stats[k].requires_grad
        np.testing.assert_allclose(stats[k].item(), float(jstats[k]),
                                   rtol=1e-5, err_msg=k)
    # the target is the negated synthesis flow: the zero-flow EPE is its norm
    assert stats["Stat/epe"].item() > 0.5

    want = _leaves(jgrads["params"])
    got = _leaves(params_to_flax({k: p.grad
                                  for k, p in net.named_parameters()}))
    assert set(got) == set(want)
    for k in got:
        assert np.any(want[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_three_adam_steps_of_pretrain_recipe_match_optax():
    """Adam 2e-4 with StepLR(gamma 0.3): two steps an epoch and a decay every
    epoch here, so the third update runs at the decayed rate."""
    jnet, params, net, _ = _burst_problem(46)
    batch = _flow_batch(47)
    jbatch = {k: _j(v) for k, v in batch.items()}
    jactor = jactors.make_lite_flow_actor(jnet)
    kw = dict(base_lr=2e-4, step_size_epochs=1, gamma=0.3, steps_per_epoch=2)
    tx = jstate.make_optimizer(**kw)

    @jax.jit
    def update(p, opt):
        grads = jax.grad(lambda q: jactor(q, jbatch)[0])(p)
        updates, opt = tx.update(grads, opt, p)
        return jax.tree.map(jnp.add, p, updates), opt

    jparams, opt = params, tx.init(params)
    for _ in range(3):
        jparams, opt = update(jparams, opt)

    state = make_optimizer(**kw).init(net)
    actor = make_lite_flow_actor(net)
    tbatch = {k: _t(v) for k, v in batch.items()}
    for _ in range(3):
        state.optimizer.zero_grad(set_to_none=True)
        actor(tbatch)[0].backward()
        state.apply_gradients()
    want = _leaves(jparams["params"])
    got = _leaves(params_to_flax(net.state_dict()))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# checkpoints both ways, the graft, default_synthetic's search


def _pretrained_state(seed=3):
    net = BurstAlignLite()
    from dbsr_tpu_torch.models.layers import init_params
    init_params(net, make_generator("cpu", seed))
    return make_optimizer(base_lr=2e-4, step_size_epochs=6, gamma=0.3).init(net)


def test_port_align_lite_checkpoint_is_read_and_grafted_by_both(tmp_path):
    state = _pretrained_state()
    path = ckpt.save_checkpoint(str(tmp_path), "align_lite", 2, state)
    header = ckpt.read_header(path)
    assert header["net_name"] == "align_lite"
    assert header["net_spec"] == {"module": "dbsr_tpu.models.align_lite",
                                  "cls": "BurstAlignLite",
                                  "kwargs": {"dtype": None}}
    assert config.flow_net_kind(path) == "lite"

    # the JAX package rebuilds and runs it
    burst = np.random.RandomState(50).rand(1, 3, 16, 16, 4).astype(np.float32)
    jflow_net, jfparams, _ = jax_load_network(path)
    assert isinstance(jflow_net, JaxBurstAlignLite)
    want_flow = jax.jit(jflow_net.apply)(jfparams, _j(burst))
    with torch.no_grad():
        _close(state.net(_t(burst)), want_flow, rtol=0, atol=1e-5)
    # and so does the port
    again, _ = ckpt.load_network(path, device="cpu")
    assert isinstance(again, BurstAlignLite)
    for (k, a), b in zip(again.state_dict().items(),
                         state.net.state_dict().values()):
        assert torch.equal(a, b), k

    # both packages graft it into their DBSRNet: equal forwards
    jnet = jax_dbsrnet_tiny(flow_net="lite")
    shapes = jax.eval_shape(jnet.init, jax.random.key(0), _j(burst))
    dparams = _random_params(shapes, 51)
    grafted = jax_graft(jax.tree.map(_j, dparams), path)
    want, waux = jax.jit(jnet.apply)(grafted, _j(burst))

    net = dbsrnet_tiny()
    net.load_state_dict(params_from_flax(dparams), strict=True)
    config.graft_alignment_params(net, path)
    with torch.no_grad():
        got, aux = net(_t(burst))
    _close(got, want, rtol=0, atol=1e-5)
    _close(aux["offsets"], waux["offsets"], rtol=0, atol=1e-5)
    _close(aux["offsets"], want_flow, rtol=0, atol=1e-5)


@pytest.fixture
def workspace(tmp_path, monkeypatch):
    monkeypatch.setenv("DBSR_TPU_ENV", str(tmp_path / "env.json"))
    monkeypatch.setenv("DBSR_TPU_WORKSPACE_DIR", str(tmp_path / "ws"))
    monkeypatch.delenv("DBSR_TPU_ZURICHRAW2RGB_DIR", raising=False)
    return tmp_path / "ws"


def _settings(**kw):
    s = Settings()
    for k, v in {"pool_size": 2, "steps_per_epoch": 2, **kw}.items():
        setattr(s, k, v)
    return s


@pytest.mark.parametrize("train_alignment", [False, True])
def test_default_synthetic_finds_the_ports_own_checkpoint(workspace, capsys,
                                                          train_alignment):
    """With no ``pwc_checkpoint``: the latest ``align_lite`` checkpoint of
    the workspace is found and grafts; ``train_alignment`` decides whether
    the aligner trains and what the checkpoint header says of Adam."""
    state = _pretrained_state(4)
    lite_dir = workspace / "align_lite" / "pretrain_synthetic"
    ckpt.save_checkpoint(str(lite_dir), "align_lite", 1, state)
    latest = ckpt.save_checkpoint(str(lite_dir), "align_lite", 3, state)

    trainer, flow_ckpt = config.make_trainer(
        _settings(train_alignment=train_alignment), "cpu")
    assert flow_ckpt == latest
    assert f"train_alignment={train_alignment}" in capsys.readouterr().out
    config.graft_alignment_params(trainer.net, flow_ckpt)
    aligner = trainer.net.encoder.alignment_net
    for (k, a), b in zip(aligner.state_dict().items(),
                         state.net.alignment_net.state_dict().values()):
        assert torch.equal(a, b), k
    assert all(p.requires_grad == train_alignment
               for p in aligner.parameters())
    assert trainer.header_settings == {"masked_adam": not train_alignment}
    opt = trainer.tx.init(trainer.net).opt_state()
    assert any("alignment_net" in k for k in opt["mu"]) == train_alignment

    # a workspace written with the other optimizer structure is refused
    ckpt.write_checkpoint(
        str(workspace / "dbsr" / "default_synthetic"
            / "dbsr_synthetic_ep0001.ckpt"),
        {"epoch": 1, "net_name": "dbsr_synthetic",
         "settings": {"masked_adam": train_alignment}}, {})
    with pytest.raises(ValueError, match="cross-restore"):
        config.make_trainer(_settings(train_alignment=train_alignment), "cpu")


def test_default_synthetic_without_any_aligner_checkpoint_says_so(workspace):
    with pytest.raises(RuntimeError, match="align_lite pretrain_synthetic"):
        run_training("dbsr", "default_synthetic", device="cpu")
    with pytest.raises(RuntimeError, match="PWC-Net, which is not ported"):
        run_training("dbsr", "default_synthetic", device="cpu",
                     train_alignment=True)


# ---------------------------------------------------------------------------
# a trainable aligner inside DBSRNet, the reference-offset noise


def _tiny_dbsr(seed, **kw):
    rng = np.random.RandomState(seed)
    batch = {"burst": rng.rand(2, 3, 16, 16, 4).astype(np.float32),
             "frame_gt": rng.rand(2, 128, 128, 3).astype(np.float32)}
    jnet = jax_dbsrnet_tiny(flow_net="lite", **kw)
    shapes = jax.eval_shape(jnet.init, jax.random.key(0), _j(batch["burst"]))
    params = _random_params(shapes, seed + 1)
    net = dbsrnet_tiny(**kw)
    net.load_state_dict(params_from_flax(params), strict=True)
    return jnet, jax.tree.map(_j, params), net, batch


def test_train_alignment_loss_and_every_gradient_match_jax():
    jnet, params, net, batch = _tiny_dbsr(60, train_alignment=True)
    jbatch = {k: _j(v) for k, v in batch.items()}
    jactor = jactors.make_synthetic_actor(jnet, boundary_ignore=40)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jactor(p, jbatch), has_aux=True))(params)

    assert all(p.requires_grad for p in net.parameters())
    loss, _ = make_synthetic_actor(net, boundary_ignore=40)(
        {k: _t(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = _leaves(jgrads["params"])
    got = _leaves(params_to_flax({k: p.grad
                                  for k, p in net.named_parameters()}))
    assert set(got) == set(want)
    aligner = [k for k in want if "alignment_net" in k]
    assert aligner and all(np.any(want[k]) for k in aligner)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("amplitude,generator", [(0.25, False), (0.0, True)])
def test_ref_offset_noise_off_equals_jax(amplitude, generator):
    """No generator, or a zero amplitude: the reference offsets are zeros,
    as the JAX module without its ``offset_noise`` stream."""
    jnet, params, net, batch = _tiny_dbsr(61, ref_offset_noise=amplitude)
    want, _ = jax.jit(jnet.apply)(params, _j(batch["burst"]))
    g = make_generator("cpu", 5) if generator else None
    with torch.no_grad():
        got, _ = net(_t(batch["burst"]), noise_generator=g)
    _close(got, want, rtol=0, atol=1e-5)


def test_ref_offset_noise_changes_the_reference_offsets_only():
    amplitude = 0.25
    _, _, net, batch = _tiny_dbsr(62, ref_offset_noise=amplitude)
    seen = []
    net.merging.offset_conv.register_forward_pre_hook(
        lambda _, args: seen.append(args[0].clone()))
    burst = _t(batch["burst"])
    with torch.no_grad():
        plain, _ = net(burst)
        noisy, _ = net(burst, noise_generator=make_generator("cpu", 6))
    from dbsr_tpu_torch.models.dbsr import draw_ref_offset_noise
    draw = draw_ref_offset_noise(make_generator("cpu", 6), (2, 1, 16, 16, 2),
                                 amplitude)
    assert draw.min() >= -amplitude and draw.max() < amplitude
    assert draw.min() < -0.2 and draw.max() > 0.2
    offs0, offs1 = (s.reshape(2, 3, 16, 16, 2) for s in seen)
    assert torch.equal(offs0[:, 1:], offs1[:, 1:])
    assert not offs0[:, 0].any()
    assert torch.equal(offs1[:, :1], torch.remainder(draw, 1.0))
    assert not torch.equal(plain, noisy)


# ---------------------------------------------------------------------------
# the pretraining Trainer


CFG = BurstConfig(burst_size=3, crop_sz=(64, 64), downsample_factor=2,
                  border_crop=16, max_translation=8.0, max_rotation=0.5,
                  add_noise=False, fused_resample=True)


def _pretrain_trainer(workspace, batch=1, base_lr=2e-3,
                      schedule_steps_per_epoch=2):
    net = BurstAlignLite()
    pool = ProceduralImagePool(2, CFG.pre_crop_sz, seed=5, device="cpu",
                               num_leaves=80)
    loaders = [LoaderSpec("train", ProceduralPoolBatcher(pool, batch, 2)),
               LoaderSpec("val", ProceduralPoolBatcher(pool, batch, 1),
                          training=False, epoch_interval=2)]
    return Trainer(net, make_lite_flow_actor(net),
                   make_optimizer(base_lr=base_lr, step_size_epochs=6,
                                  gamma=0.3,
                                  steps_per_epoch=schedule_steps_per_epoch),
                   loaders, make_pool_prepare_fn(CFG, batch), str(workspace),
                   net_name=pretrain_synthetic.NET_NAME, print_interval=1,
                   seed=6, device="cpu")


def test_tiny_pretrain_trainer_checkpoints_and_learns_a_fixed_batch(tmp_path,
                                                                    capsys):
    """Two epochs through the Trainer (a val pass in the second), resumed
    for a third; then 60 Adam steps on one fixed batch of two bursts cut the
    EPE well below where it started (the zero-flow EPE, which a fresh net
    sits at), as the JAX package's own learnability test. At that test's
    rate of 2e-3 on a single burst both packages leave the plateau after
    ~25 steps and then overshoot, step for step alike; 1e-3 on two bursts
    descends steadily (1.60 -> 0.83 when written, limit 0.7x)."""
    t = _pretrain_trainer(tmp_path)
    state = t.train(2)
    assert state.step == 4
    assert np.isfinite(t.stats["val"]["Stat/epe"].avg)
    header = ckpt.read_header(str(tmp_path / "align_lite_ep0002.ckpt"))
    assert header["net_spec"]["cls"] == "BurstAlignLite"
    assert set(header["stats"]["train"]) == {"Loss/total", "Stat/epe",
                                             "Stat/acc_0.5px"}
    again = _pretrain_trainer(tmp_path)
    assert again.train(3).step == 6
    assert "(epoch 2, step 4)" in capsys.readouterr().out

    t = _pretrain_trainer(tmp_path / "fixed", batch=2, base_lr=1e-3,
                          schedule_steps_per_epoch=1000)  # no decay here
    state = t.init_state()
    pool = t.loaders[0].batcher.next_batch()
    epes = [t.train_step(state, make_generator("cpu", 7), pool)["Stat/epe"]
            .item() for _ in range(61)]
    assert epes[-1] < 0.7 * epes[0], (epes[0], epes[-1])


def test_pretrain_entry_on_cuda_without_card_raises(workspace):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the request is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_training("align_lite", "pretrain_synthetic")
    assert not os.path.exists(workspace)


def test_pretrain_config_builds_the_recipe(workspace):
    """The configured trainer on the CPU (nothing rendered or run): the
    recipe's schedule, loaders and workspace."""
    t = pretrain_synthetic.make_trainer(_settings(steps_per_epoch=1000), "cpu")
    assert isinstance(t.net, BurstAlignLite) and t.net_name == "align_lite"
    assert t.workspace_dir == str(workspace / "align_lite"
                                  / "pretrain_synthetic")
    sched = t.tx.schedule
    want = jstate.step_lr_schedule(2e-4, 6, 0.3, 1000)
    for count in (0, 5999, 6000, 12000, 14999):
        np.testing.assert_allclose(sched(count), float(want(count)),
                                   rtol=1e-6)
    train, val = t.loaders
    assert (train.num_batches(), train.training) == (1000, True)
    assert (val.num_batches(), val.training, val.epoch_interval) == \
        (50, False, 5)
    assert train.batcher.batch_size == 16 and t.print_interval == 100


def test_chip_smoke_imports_nothing_of_jax_and_fails_without_a_card():
    """``chip_smoke.py`` names no module of JAX or of the JAX package, and
    without a card it exits non-zero and prints no result line."""
    import ast
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(repo, "chip_smoke.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert "dbsr_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "optax", "msgpack",
                        "dbsr_tpu"}, roots
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, path], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
