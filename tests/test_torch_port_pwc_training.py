"""PWC-Net's training path in the port against the JAX package on the CPU,
float32: the flow actor's multi-scale loss, stats and gradients, three Adam
steps of the pretraining recipe, ``pwcnet_synth`` checkpoints read and
grafted by both packages, ``dbsr/default_synthetic`` grafting a PWC-Net
checkpoint and its fallback without one, the pretraining entry, and the
converter of upstream PWC-Net weights against the JAX package's.

Parameters are the port's seeded init carried to the JAX package with
``params_to_flax``; batches are made from a numpy seed. The JAX gradient is
compiled once for the module (a fixture) and reused by the Adam steps.

Tolerances: the loss and stats rtol 1e-5; gradients rtol 1e-4 / atol 1e-6;
parameters after Adam steps atol 1e-6; forwards atol 1e-5, as
``tests/test_torch_port_align.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dbsr_tpu.configs.dbsr.default_synthetic import \
    graft_alignment_params as jax_graft
from dbsr_tpu.models.dbsr import dbsrnet_tiny as jax_dbsrnet_tiny
from dbsr_tpu.models.pwcnet import BurstFlowNet as JaxBurstFlowNet
from dbsr_tpu.training import actors as jactors
from dbsr_tpu.training import state as jstate
from dbsr_tpu.training.checkpoint import load_network as jax_load_network
from dbsr_tpu.utils.convert_pwcnet import \
    convert_pwcnet_state_dict as jax_convert_pwcnet
from dbsr_tpu_torch.configs.dbsr import default_synthetic as config
from dbsr_tpu_torch.configs.pwcnet import pretrain_synthetic
from dbsr_tpu_torch.data.procedural import make_generator
from dbsr_tpu_torch.environment import Settings
from dbsr_tpu_torch.models.align_lite import AlignLiteNet, BurstAlignLite
from dbsr_tpu_torch.models.dbsr import dbsrnet_tiny
from dbsr_tpu_torch.models.layers import init_params
from dbsr_tpu_torch.models.pwcnet import BurstFlowNet, PWCFlowNet, PWCNet
from dbsr_tpu_torch.run_training import run_training
from dbsr_tpu_torch.training import checkpoint as ckpt
from dbsr_tpu_torch.training.actors import PWC_LEVEL_WEIGHTS, make_flow_actor
from dbsr_tpu_torch.training.state import make_optimizer
from dbsr_tpu_torch.utils.convert import params_to_flax
from dbsr_tpu_torch.utils.convert_pwcnet import (convert_pwcnet_state_dict,
                                                 load_pwcnet_torch_checkpoint)

PWC_SYNTH = "dbsr_tpu/artifacts/pwcnet_synth_params.ckpt"
ADAM = dict(base_lr=2e-4, step_size_epochs=1, gamma=0.3, steps_per_epoch=2)


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


def _j(a):
    return jnp.array(np.array(a))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _seeded_flow_net(seed):
    net = BurstFlowNet()
    init_params(net, make_generator("cpu", seed))
    return net


def _flow_batch(seed, shape=(1, 3, 16, 16, 4)):
    rng = np.random.RandomState(seed)
    B, N, h, w, _ = shape
    return {"burst": rng.rand(*shape).astype(np.float32),
            # dense LR-grid flow of all N frames, a few pixels
            "flow": (2.0 * rng.randn(B, N, 2 * h, 2 * w, 2)).astype(
                np.float32)}


@pytest.fixture(scope="module")
def problem():
    """A seeded ``BurstFlowNet``'s state dict and flax parameters, a batch,
    and the JAX actor's jitted ``value_and_grad`` on that batch."""
    net = _seeded_flow_net(7)
    params = {"params": params_to_flax(net.state_dict())}
    batch = _flow_batch(70)
    jactor = jactors.make_flow_actor(JaxBurstFlowNet())
    jbatch = {k: _j(v) for k, v in batch.items()}
    grad_fn = jax.jit(jax.value_and_grad(lambda p: jactor(p, jbatch),
                                         has_aux=True))
    return net.state_dict(), jax.tree.map(_j, params), batch, grad_fn


def _port_net(problem):
    net = BurstFlowNet()
    net.load_state_dict(problem[0], strict=True)
    return net


def test_flow_actor_loss_stats_and_gradients_match_jax(problem):
    _, params, batch, grad_fn = problem
    (jloss, jstats), jgrads = grad_fn(params)
    net = _port_net(problem)
    loss, stats = make_flow_actor(net)({k: _t(v) for k, v in batch.items()})
    loss.backward()
    assert list(PWC_LEVEL_WEIGHTS) == [6, 5, 4, 3, 2]
    assert set(stats) == set(jstats) == {"Loss/total", "Stat/epe",
                                         "Stat/acc_0.5px"}
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in stats:
        assert not stats[k].requires_grad
        np.testing.assert_allclose(stats[k].item(), float(jstats[k]),
                                   rtol=1e-5, err_msg=k)
    want = _leaves(jgrads["params"])
    got = _leaves(params_to_flax({k: p.grad
                                  for k, p in net.named_parameters()}))
    assert set(got) == set(want)
    assert any("upflow" in k for k in got)
    for k in got:
        assert np.any(want[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_three_adam_steps_of_the_pwc_recipe_match_optax(problem):
    """Adam 2e-4 with StepLR(gamma 0.3): two steps an epoch and a decay every
    epoch here, so the third update runs at the decayed rate."""
    _, params, batch, grad_fn = problem
    tx = jstate.make_optimizer(**ADAM)

    @jax.jit
    def update(grads, opt, p):
        updates, opt = tx.update(grads, opt, p)
        return optax.apply_updates(p, updates), opt

    jparams, opt = params, tx.init(params)
    for _ in range(3):
        jparams, opt = update(grad_fn(jparams)[1], opt, jparams)

    net = _port_net(problem)
    state = make_optimizer(**ADAM).init(net)
    actor = make_flow_actor(net)
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
# checkpoints both ways and the graft


def test_port_pwcnet_checkpoint_is_read_and_grafted_by_both(tmp_path):
    """A ``pwcnet_synth`` checkpoint the port writes: the JAX package
    rebuilds and runs it, and both packages graft it into their DBSRNet with
    ``flow_net='pwc'``, with equal forwards."""
    state = make_optimizer().init(_seeded_flow_net(8))
    path = ckpt.save_checkpoint(str(tmp_path), "pwcnet_synth", 2, state)
    header = ckpt.read_header(path)
    assert header["net_spec"] == {"module": "dbsr_tpu.models.pwcnet",
                                  "cls": "BurstFlowNet",
                                  "kwargs": {"dtype": None}}
    assert config.flow_net_kind(path) == "pwc"

    burst = np.random.RandomState(80).rand(1, 3, 8, 8, 4).astype(np.float32)
    jflow_net, jfparams, _ = jax_load_network(path)
    assert isinstance(jflow_net, JaxBurstFlowNet)
    want_flow = jax.jit(jflow_net.apply)(jfparams, _j(burst))
    with torch.no_grad():
        flow = state.net(_t(burst))
    np.testing.assert_allclose(flow.numpy(), np.asarray(want_flow), atol=1e-5)

    jnet = jax_dbsrnet_tiny(flow_net="pwc")
    shapes = jax.eval_shape(jnet.init, jax.random.key(0), _j(burst))
    net = dbsrnet_tiny(flow_net="pwc")
    init_params(net, make_generator("cpu", 81))
    dparams = {"params": params_to_flax(net.state_dict())}
    assert jax.tree.structure(dparams) == jax.tree.structure(shapes)
    grafted = jax_graft(jax.tree.map(_j, dparams), path)
    want, waux = jax.jit(jnet.apply)(grafted, _j(burst))
    config.graft_alignment_params(net, path)
    with torch.no_grad():
        got, aux = net(_t(burst))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(aux["offsets"].numpy(),
                               np.asarray(waux["offsets"]), atol=1e-5)
    np.testing.assert_allclose(aux["offsets"].numpy(), flow.numpy(),
                               atol=1e-5)


def test_banked_jax_checkpoint_is_read_and_grafted_by_the_port():
    """The JAX-written banked ``pwcnet_synth_params.ckpt``: the port's
    ``load_network`` rebuilds a ``BurstFlowNet``, its graft puts the same
    tensors into a PWC-Net DBSRNet, and a tensor of the wrong shape is
    refused."""
    flow_net, _ = ckpt.load_network(PWC_SYNTH, device="cpu")
    assert isinstance(flow_net, BurstFlowNet)
    net = dbsrnet_tiny(flow_net="pwc")
    config.graft_alignment_params(net, PWC_SYNTH)
    got = net.encoder.alignment_net.state_dict()
    want = flow_net.alignment_net.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="incompatible"):
        config.graft_alignment_params(dbsrnet_tiny(flow_net="lite"),
                                      PWC_SYNTH)


# ---------------------------------------------------------------------------
# default_synthetic: the graft, the search order, the fallback


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


def _save_pwc(directory, epoch, seed):
    state = make_optimizer().init(_seeded_flow_net(seed))
    return ckpt.save_checkpoint(str(directory), "pwcnet_synth", epoch, state)


@pytest.mark.parametrize("where", ["workspace", "explicit"])
def test_default_synthetic_grafts_a_pwc_checkpoint_frozen(workspace, capsys,
                                                          where):
    """The latest ``pwcnet/pretrain_synthetic`` checkpoint of the workspace,
    or ``pwc_checkpoint``: ``flow_net='pwc'``, grafted and frozen."""
    if where == "workspace":
        pwc_dir = workspace / "pwcnet" / "pretrain_synthetic"
        _save_pwc(pwc_dir, 1, 9)
        path = _save_pwc(pwc_dir, 4, 10)
        settings = _settings()
    else:
        path = PWC_SYNTH
        settings = _settings(pwc_checkpoint=PWC_SYNTH)
    trainer, flow_ckpt = config.make_trainer(settings, "cpu")
    assert flow_ckpt == path
    assert (f"using pretrained flow weights: {path} (flow_net=pwc, "
            "train_alignment=False)") in capsys.readouterr().out
    aligner = trainer.net.encoder.alignment_net
    assert isinstance(aligner, PWCNet)
    assert not any(p.requires_grad for p in aligner.parameters())
    assert trainer.header_settings == {"masked_adam": True}
    config.graft_alignment_params(trainer.net, flow_ckpt)
    want, _ = ckpt.load_network(path, device="cpu")
    for (k, a), b in zip(aligner.state_dict().items(),
                         want.alignment_net.state_dict().values()):
        assert torch.equal(a, b), k


def test_default_synthetic_prefers_align_lite_then_pwcnet(workspace):
    """The JAX package's search order: ``align_lite/pretrain_synthetic``
    before ``pwcnet/pretrain_synthetic``."""
    pwc = _save_pwc(workspace / "pwcnet" / "pretrain_synthetic", 2, 11)
    assert config.find_pretrained_flow(_settings()) == pwc
    lite_state = make_optimizer().init(BurstAlignLite())
    lite = ckpt.save_checkpoint(
        str(workspace / "align_lite" / "pretrain_synthetic"), "align_lite", 1,
        lite_state)
    assert config.find_pretrained_flow(_settings()) == lite
    trainer, _ = config.make_trainer(_settings(), "cpu")
    assert isinstance(trainer.net.encoder.alignment_net, AlignLiteNet)


def test_default_synthetic_falls_back_to_training_pwc_end_to_end(workspace,
                                                                 capsys):
    """No aligner checkpoint anywhere: the JAX package's WARNING, a fresh
    PWC-Net trained with the rest (Adam over every parameter), and no
    epoch-0 graft written."""
    trainer, flow_ckpt = config.make_trainer(_settings(), "cpu")
    assert flow_ckpt is None
    out = capsys.readouterr().out
    assert ("WARNING: no pretrained flow checkpoint found — training the "
            "aligner end-to-end (reference protocol is pretrained+frozen; "
            "run `python run_training.py align_lite pretrain_synthetic` "
            "first)") in out
    assert isinstance(trainer.net.encoder.alignment_net, PWCNet)
    assert trainer.net.encoder.train_alignment
    assert all(p.requires_grad for p in trainer.net.parameters())
    assert trainer.header_settings == {"masked_adam": False}
    opt = trainer.tx.init(trainer.net).opt_state()
    assert any("alignment_net.net.dec2.upflow" in k for k in opt["mu"])

    run_training("dbsr", "default_synthetic", device="cpu", epochs=0,
                 pool_size=2, steps_per_epoch=2)
    assert "WARNING: no pretrained flow checkpoint" in capsys.readouterr().out
    ws = workspace / "dbsr" / "default_synthetic"
    assert not ws.exists() or not os.listdir(ws)


# ---------------------------------------------------------------------------
# the pretraining entry


def test_pwc_pretrain_entry_on_cuda_without_card_raises(workspace):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the request is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_training("pwcnet", "pretrain_synthetic")
    assert not os.path.exists(workspace)


def test_pwc_pretrain_config_builds_the_recipe(workspace):
    """The configured trainer on the CPU (nothing rendered or run): the
    network, the actor's net name, the schedule, loaders and workspace."""
    t = pretrain_synthetic.make_trainer(_settings(steps_per_epoch=1000),
                                        "cpu")
    assert isinstance(t.net, BurstFlowNet) and t.net_name == "pwcnet_synth"
    assert t.workspace_dir == str(workspace / "pwcnet" / "pretrain_synthetic")
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


# ---------------------------------------------------------------------------
# upstream PWC-Net weights


def _upstream_state_dict(seed):
    """A synthetic state dict in the upstream (sniklaus pytorch-pwc) layout:
    its key names, with the ``module.`` prefix of a saved checkpoint, and the
    shapes of the port's modules, filled from a seed."""
    rng = np.random.RandomState(seed)
    shapes = {k: tuple(v.shape) for k, v in PWCFlowNet().state_dict().items()}
    names = ("netOne", "netTwo", "netThr", "netFou", "netFiv", "netSix")
    pairs = []
    for lvl, name in enumerate(names, start=1):
        pairs += [(f"netExtractor.{name}.{idx}",
                   f"extractor.lvl{lvl}_conv{j}.Conv_0")
                  for j, idx in enumerate((0, 2, 4))]
    for lvl, name in enumerate(names[1:], start=2):
        pairs += [(f"{name}.{d}.0", f"dec{lvl}.dense{i}.Conv_0")
                  for i, d in enumerate(names[:5])]
        pairs.append((f"{name}.netSix.0", f"dec{lvl}.flow_head.Conv_0"))
        if lvl < 6:
            pairs += [(f"{name}.netUpflow", f"dec{lvl}.upflow"),
                      (f"{name}.netUpfeat", f"dec{lvl}.upfeat")]
    pairs += [(f"netRefiner.netMain.{idx}", f"refiner.ctx{i}.Conv_0")
              for i, idx in enumerate((0, 2, 4, 6, 8, 10))]
    pairs.append(("netRefiner.netMain.12", "refiner.ctx_flow.Conv_0"))
    return {f"module.{up}.{leaf}": torch.from_numpy(
        rng.randn(*shapes[f"{port}.{leaf}"]).astype(np.float32))
        for up, port in pairs for leaf in ("weight", "bias")}


def test_upstream_converter_matches_the_jax_one(tmp_path):
    """The port's renaming against the JAX package's converter on a
    synthetic upstream state dict: equal by value under every flax path
    (the transposed convs' kernels included), loaded strictly into
    ``PWCFlowNet``; the same from a saved ``.pth``; a missing tensor
    raises."""
    sd = _upstream_state_dict(90)
    got = convert_pwcnet_state_dict(sd)
    want = _leaves(jax_convert_pwcnet(sd))
    assert len(got) == len(sd) == len(want)
    PWCFlowNet().load_state_dict(got, strict=True)
    flax = _leaves(params_to_flax(got))
    assert set(flax) == set(want)
    for k in want:
        np.testing.assert_array_equal(flax[k], want[k], err_msg=k)
    path = str(tmp_path / "pwc.pth")
    torch.save(sd, path)
    again = load_pwcnet_torch_checkpoint(path)
    assert all(torch.equal(again[k], got[k]) for k in got)
    del sd["module.netFiv.netUpflow.weight"]
    with pytest.raises(KeyError, match="netFiv.netUpflow.weight"):
        convert_pwcnet_state_dict(sd)
