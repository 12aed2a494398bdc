"""The port's training loop on CPU: checkpoints written by its own msgpack
writer (read back by the port, by flax and by the JAX package's
``load_network``), resume, the tiny ``Trainer`` with its divergence guards
and fail-safe restart, the training entry and its refusals.

Tolerances: the checkpoint bytes and parameters are exact; a port-written
checkpoint run by the JAX package agrees with the port's forward to
atol 1e-5 (float32 sums in another order, as in the forward tests).
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from dbsr_tpu.training.checkpoint import _read as jax_read
from dbsr_tpu.training.checkpoint import load_network as jax_load_network
from dbsr_tpu_torch.configs.dbsr import default_synthetic as config
from dbsr_tpu_torch.data.procedural import (ProceduralImagePool,
                                            ProceduralPoolBatcher,
                                            make_generator,
                                            make_pool_prepare_fn)
from dbsr_tpu_torch.data.synthetic import BurstConfig, synthesize_batch
from dbsr_tpu_torch.models.dbsr import dbsrnet_cvpr2021, dbsrnet_tiny
from dbsr_tpu_torch.models.layers import init_params
from dbsr_tpu_torch.run_training import main, run_training
from dbsr_tpu_torch.training import checkpoint as ckpt
from dbsr_tpu_torch.training.actors import make_synthetic_actor
from dbsr_tpu_torch.training.state import make_optimizer
from dbsr_tpu_torch.training.trainer import (LoaderSpec, Trainer,
                                             is_divergent)
from dbsr_tpu_torch.utils.convert import params_from_flax, params_to_flax

REPO = Path(__file__).resolve().parents[1]
FLAGSHIP = str(REPO / "dbsr_tpu/artifacts/campaigns/"
               "dbsr_campaign_r5_best_params.ckpt")
ALIGN_LITE = str(REPO / "dbsr_tpu/artifacts/align_lite_params.ckpt")
PWC = str(REPO / "dbsr_tpu/artifacts/pwcnet_synth_params.ckpt")
CFG = BurstConfig(burst_size=3, crop_sz=(32, 32), border_crop=4,
                  max_translation=3.0, fused_resample=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this module runs: the suite runs
    in parallel worker processes, and torch's many small CPU ops slow down
    several-fold when every worker spins a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_msgpack_writer_round_trips_and_matches_flax_encoding():
    tree = {"params": {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
                       "b": {"c": np.zeros((0, 2), np.float32),
                             "i": np.array([-1, 2 ** 40], np.int64)}},
            "x" * 40: [1, -33, 300, -70000, 2 ** 40, 1.5, None, True],
            "s": np.float32(2.5), "t": "y" * 300, "u": b"\x00" * 70}
    blob = ckpt.msgpack_pack(tree)
    # flax's own encoding of the same tree, keys in the same order
    assert blob == msgpack.packb(tree, default=serialization._msgpack_ext_pack)
    got, want = ckpt.msgpack_unpack(blob), serialization.msgpack_restore(blob)
    assert _leaves(got).keys() == _leaves(want).keys() == _leaves(tree).keys()
    for k, v in _leaves(tree).items():
        for other in (got, want):
            o = _leaves(other)[k]
            assert o.dtype == v.dtype and o.shape == v.shape, k
            np.testing.assert_array_equal(o, v, err_msg=k)


def test_params_to_flax_inverts_params_from_flax():
    _, tree = ckpt.read_checkpoint(FLAGSHIP)
    flax_params = tree["params"]["params"]
    back = params_to_flax(params_from_flax(flax_params))
    want, got = _leaves(flax_params), _leaves(back)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


def _tiny_state(seed=0):
    net = dbsrnet_tiny()
    init_params(net, make_generator("cpu", seed))
    return make_optimizer(base_lr=1e-3, steps_per_epoch=2).init(net)


def _batch(seed=1, batch=2):
    crops = torch.from_numpy(np.random.RandomState(seed).rand(
        batch, 40, 40, 3).astype(np.float32))
    return synthesize_batch(make_generator("cpu", seed), crops, CFG)


def _step(state, batch):
    actor = make_synthetic_actor(state.net, boundary_ignore=4)
    state.optimizer.zero_grad(set_to_none=True)
    loss, _ = actor(batch)
    loss.backward()
    state.apply_gradients()
    return loss.item()


def test_port_checkpoint_is_read_by_flax_and_runs_in_jax(tmp_path):
    state = _tiny_state()
    _step(state, _batch())
    path = ckpt.save_checkpoint(str(tmp_path), "dbsr_synthetic", 1, state,
                                stats={"train": {"Loss/total": 0.5}},
                                settings={"masked_adam": True})
    assert os.path.basename(path) == "dbsr_synthetic_ep0001.ckpt"
    assert not list(tmp_path.glob("*.tmp"))
    header, tree = ckpt.read_checkpoint(path)
    jheader, blob = jax_read(path)
    assert header == jheader and header["epoch"] == 1
    assert header["net_spec"]["module"] == "dbsr_tpu.models.dbsr"
    flax_tree = serialization.msgpack_restore(blob)
    assert _leaves(flax_tree).keys() == _leaves(tree).keys()
    for k, v in _leaves(flax_tree).items():
        assert v.tobytes() == _leaves(tree)[k].tobytes(), k
    assert tree["step"] == 1 and tree["opt_state"]["count"] == 1
    assert not any("alignment_net" in k for k in _leaves(tree["opt_state"]))

    jnet, jparams, _ = jax_load_network(path)
    burst = np.random.RandomState(2).rand(1, 3, 8, 8, 4).astype(np.float32)
    want, _ = jax.jit(jnet.apply)(jparams, jnp.array(burst))
    with torch.no_grad():
        got, _ = state.net(torch.from_numpy(burst))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_resume_restores_params_moments_and_step(tmp_path):
    a = _tiny_state()
    _step(a, _batch(1))
    _step(a, _batch(2))
    path = ckpt.save_checkpoint(str(tmp_path), "net", 1, a)
    b = _tiny_state(seed=5)  # other parameters until restored
    header = ckpt.load_train_state(path, b)
    assert header["epoch"] == 1 and b.step == a.step == 2
    _step(a, _batch(3))  # the third update runs at the decayed rate
    _step(b, _batch(3))
    for (k, pa), pb in zip(a.net.state_dict().items(),
                           b.net.state_dict().values()):
        assert torch.equal(pa, pb), k
    oa, ob = a.opt_state(), b.opt_state()
    assert oa["count"] == ob["count"] == 3
    for k in oa["mu"]:
        assert torch.equal(oa["mu"][k], ob["mu"][k]), k
        assert torch.equal(oa["nu"][k], ob["nu"][k]), k


def test_checkpoint_listing_and_resolution(tmp_path):
    state = _tiny_state()
    for e in (2, 10, 1):
        ckpt.save_checkpoint(str(tmp_path), "net", e, state)
    assert [e for e, _ in ckpt.list_checkpoints(str(tmp_path), "net")] == \
        [1, 2, 10]
    assert ckpt.resolve_checkpoint(str(tmp_path), "net").endswith(
        "net_ep0010.ckpt")
    assert ckpt.resolve_checkpoint(str(tmp_path), "other") is None
    with pytest.raises(FileNotFoundError):
        ckpt.resolve_checkpoint(str(tmp_path), "net", epoch=3)


@pytest.mark.parametrize("loss,best,factor,want", [
    (None, 1.0, 1.4, False), (float("nan"), None, 1.4, True),
    (1.3, 1.0, 1.4, False), (1.5, 1.0, 1.4, True), (5.0, None, 1.4, False),
    (5.0, 1.0, None, False)])
def test_is_divergent(loss, best, factor, want):
    assert is_divergent(loss, best, factor) is want


def _trainer(workspace, print_interval=1, val_interval=None):
    net = dbsrnet_tiny()
    pool = ProceduralImagePool(4, CFG.pre_crop_sz, seed=3, device="cpu",
                               num_leaves=4)
    loaders = [LoaderSpec("train", ProceduralPoolBatcher(pool, 2, 2))]
    if val_interval:
        loaders.append(LoaderSpec("val", ProceduralPoolBatcher(pool, 2, 1),
                                  training=False,
                                  epoch_interval=val_interval))
    actor = make_synthetic_actor(net, boundary_ignore=4)
    return Trainer(net, actor,
                   make_optimizer(base_lr=1e-3, steps_per_epoch=2),
                   loaders, make_pool_prepare_fn(CFG, 2), str(workspace),
                   net_name="tiny", print_interval=print_interval, seed=4,
                   device="cpu")


def test_tiny_trainer_checkpoints_and_resumes(tmp_path, capsys):
    """Two epochs with a val pass in the second only (no update there),
    then a third epoch resumed from the second's checkpoint."""
    t = _trainer(tmp_path, val_interval=2)
    state = t.train(2)
    assert state.step == 4 and t.epoch == 2
    val = t.stats["val"]
    assert val["Loss/total"].count == 2 and not val["Loss/total"].history
    assert np.isfinite(val["Stat/psnr"].avg)
    assert [e for e, _ in ckpt.list_checkpoints(str(tmp_path), "tiny")] == \
        [1, 2]
    losses = t.stats["train"]["Loss/total"].history + [
        t.stats["train"]["Loss/total"].avg]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    header, _ = ckpt.read_checkpoint(str(tmp_path / "tiny_ep0002.ckpt"))
    assert np.isfinite(header["stats"]["train"]["Stat/psnr"])

    again = _trainer(tmp_path)
    state2 = again.train(3)
    out = capsys.readouterr().out
    assert "resumed from" in out and "(epoch 2, step 4)" in out
    assert state2.step == 6 and (tmp_path / "tiny_ep0003.ckpt").exists()


def _inject(trainer, scale):
    """Scale the losses of epoch 2's first attempt by ``scale`` (the stats
    too), or crash once in epoch 2 (``scale`` None)."""
    actor, crashed = trainer.actor_fn, []

    def fn(batch):
        loss, stats = actor(batch)
        if trainer.epoch == 2 and scale is None and not crashed:
            crashed.append(1)
            raise RuntimeError("injected crash")
        if trainer.epoch == 2 and scale is not None \
                and trainer._retry_salt == 0:
            loss = loss * scale
            stats = dict(stats, **{"Loss/total": stats["Loss/total"] * scale})
        return loss, stats

    trainer.actor_fn = fn


@pytest.mark.parametrize("scale,message,intra,epoch_factor", [
    (20.0, "Mid-epoch divergence at epoch 2", 5.0, None),
    (20.0, "Divergence detected at epoch 2", None, 5.0),
    (None, "Training crashed at epoch 2", None, None)])
def test_tiny_trainer_rolls_back_and_retries(tmp_path, capsys, scale,
                                             message, intra, epoch_factor):
    """A blow-up within epoch 2 (the interval guard), over epoch 2 (the
    epoch guard) or a crash: training goes back to the epoch-1 checkpoint
    and runs epoch 2 again to its end, on a reseeded stream after a
    divergence. The guards' factors are raised from 3 and 1.4 to 5 here,
    above the spread of this tiny problem's batch losses (about 2x)."""
    t = _trainer(tmp_path)
    t.intra_divergence_factor, t.divergence_factor = intra, epoch_factor
    _inject(t, scale)
    state = t.train(2)
    out = capsys.readouterr().out
    assert message in out and "Finished training!" in out
    assert "resumed from" in out and "(epoch 1, step 2)" in out
    assert t._retry_salt == (0 if scale is None else 1)
    assert t.epoch == 2 and (tmp_path / "tiny_ep0002.ckpt").exists()
    assert state.step == 4  # epoch-1 checkpoint (step 2) + two updates


def test_trainer_on_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the request is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(dbsrnet_tiny(), None, make_optimizer(), [], None,
                str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_training("dbsr", "default_synthetic")


@pytest.fixture
def workspace(tmp_path, monkeypatch):
    monkeypatch.setenv("DBSR_TPU_ENV", str(tmp_path / "env.json"))
    monkeypatch.setenv("DBSR_TPU_WORKSPACE_DIR", str(tmp_path / "ws"))
    monkeypatch.delenv("DBSR_TPU_ZURICHRAW2RGB_DIR", raising=False)
    return tmp_path / "ws"


@pytest.mark.parametrize("overrides,error,match", [
    ({}, RuntimeError, "pwc_checkpoint=dbsr_tpu/artifacts/align_lite"),
    ({"pwc_checkpoint": PWC}, RuntimeError, "AlignLite"),
    ({"compute_dtype": "bfloat16"}, NotImplementedError, "float32"),
    ({"pwc_checkpoint": ALIGN_LITE, "mix": "mixed"}, NotImplementedError,
     "dead-leaves")])
def test_training_entry_refuses_what_the_port_does_not_run(
        workspace, overrides, error, match):
    with pytest.raises(error, match=match):
        run_training("dbsr", "default_synthetic", device="cpu", **overrides)
    assert not workspace.exists() or not any(workspace.rglob("*.ckpt"))


def test_training_cli_parses_settings(workspace):
    with pytest.raises(NotImplementedError, match="'bfloat16'"):
        main(["dbsr", "default_synthetic", "--device", "cpu", "--set",
              "compute_dtype=bfloat16", "--set", "epochs=2"])


def test_graft_alignment_params_checks_names_and_shapes(tmp_path):
    net = dbsrnet_cvpr2021()
    config.graft_alignment_params(net, ALIGN_LITE)
    _, raw = ckpt.read_checkpoint(ALIGN_LITE)
    want = params_from_flax(raw["params"]["params"]["alignment_net"])
    got = net.encoder.alignment_net.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert config.flow_net_kind(ALIGN_LITE) == "lite"
    assert config.flow_net_kind(PWC) == "pwc"

    header, raw = ckpt.read_checkpoint(ALIGN_LITE)
    node = raw["params"]["params"]["alignment_net"]
    while isinstance(node[next(iter(node))], dict):
        node = node[next(iter(node))]
    key = next(iter(node))
    node[key] = node[key][..., :1]  # one tensor of the wrong shape
    bad = ckpt.write_checkpoint(str(tmp_path / "bad.ckpt"), header, raw)
    with pytest.raises(ValueError, match="incompatible"):
        config.graft_alignment_params(dbsrnet_cvpr2021(), bad)
