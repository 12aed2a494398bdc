"""The port's trainer service layer on the CPU, against the JAX package's:
resume from a params-only checkpoint, the params-only artifact both ways,
the asynchronous checkpoint writer, TensorBoard and step tracing.

A JAX tiny AlignLite DBSRNet trains two epochs with JAX's ``Trainer``
(started from the port's seeded init carried over by ``params_to_flax``:
flax's eager init of the net takes ~50 s here) and JAX's
``save_params_artifact`` banks its epoch-2 parameters. The port's trainer
resumes from that file: parameters bit-equal, a fresh Adam, ``step ==
2 x steps_per_epoch``, and trains on to epoch 3 (the counterpart of
``test_params_only_resume_grafts_and_fast_forwards``). Checkpoint bytes
and parameters are compared exactly.
"""

import glob
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import \
    EventAccumulator

from dbsr_tpu.data.pipeline import CropBatcher, RandomImageSampler
from dbsr_tpu.data.synthetic import BurstConfig as JaxBurstConfig
from dbsr_tpu.models.dbsr import dbsrnet_tiny as jax_dbsrnet_tiny
from dbsr_tpu.training import checkpoint as jax_ckpt
from dbsr_tpu.training.actors import \
    make_synthetic_actor as jax_synthetic_actor
from dbsr_tpu.training.state import TrainState as JaxTrainState
from dbsr_tpu.training.state import make_optimizer as jax_make_optimizer
from dbsr_tpu.training.tblogger import TensorboardWriter as JaxTBWriter
from dbsr_tpu.training.trainer import LoaderSpec as JaxLoaderSpec
from dbsr_tpu.training.trainer import Trainer as JaxTrainer
from dbsr_tpu_torch.data.procedural import (ProceduralImagePool,
                                            ProceduralPoolBatcher,
                                            make_generator,
                                            make_pool_prepare_fn)
from dbsr_tpu_torch.data.synthetic import BurstConfig
from dbsr_tpu_torch.models.dbsr import dbsrnet_tiny
from dbsr_tpu_torch.models.layers import init_params
from dbsr_tpu_torch.training import checkpoint as ckpt
from dbsr_tpu_torch.training.actors import make_synthetic_actor
from dbsr_tpu_torch.training.state import make_optimizer
from dbsr_tpu_torch.training.tblogger import TensorboardWriter
from dbsr_tpu_torch.training.trainer import LoaderSpec, Trainer
from dbsr_tpu_torch.utils.convert import params_to_flax
from dbsr_tpu_torch.utils.profiling import annotate, maybe_trace

CFG = BurstConfig(burst_size=3, crop_sz=(32, 32), downsample_factor=2,
                  border_crop=4, max_translation=3.0, fused_resample=True)
JAX_CFG = JaxBurstConfig(burst_size=3, crop_sz=(32, 32), downsample_factor=2,
                         border_crop=4, max_translation=3.0, max_rotation=0.5)
STEPS = 2  # batches per training epoch, in both packages' runs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this module runs (the suite runs
    in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (k,)))
        return out
    return {"/".join(prefix): np.asarray(tree)}


class _Images:
    """Four in-memory images for JAX's ``RandomImageSampler``."""

    def __init__(self):
        rng = np.random.RandomState(0)
        self.images = [(rng.rand(80, 96, 3) * 255).astype(np.uint8)
                       for _ in range(4)]

    def get_num_images(self):
        return len(self.images)

    def get_image(self, i, info=None):
        return self.images[i], {}


def _port_tiny(seed=0):
    net = dbsrnet_tiny(upsample_factor=4)
    init_params(net, make_generator("cpu", seed))
    return net


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's trainer, two epochs of the tiny net; ``(epoch-2 checkpoint,
    JAX's params-only artifact of it)``."""
    ws = tmp_path_factory.mktemp("jax_ws")
    net = jax_dbsrnet_tiny(upsample_factor=4, flow_net="lite")
    tx = jax_make_optimizer(1e-3, 40, 0.2, steps_per_epoch=STEPS)
    batcher = CropBatcher(RandomImageSampler([_Images()], [1.0],
                                             samples_per_epoch=2 * STEPS),
                          batch_size=2, crop_sz=JAX_CFG.pre_crop_sz, seed=0)
    trainer = JaxTrainer(net, jax_synthetic_actor(net, boundary_ignore=4), tx,
                         [JaxLoaderSpec("train", batcher)], JAX_CFG, str(ws),
                         net_name="tiny", print_interval=100, seed=0)
    params = {"params": jax.tree.map(
        jnp.asarray, params_to_flax(_port_tiny().state_dict()))}
    trainer.init_state = lambda: JaxTrainState.create(params, tx)
    trainer.train(2, load_latest=False, fail_safe=False)
    src = jax_ckpt.resolve_checkpoint(str(ws), "tiny", 2)
    header, raw = jax_ckpt.load_checkpoint(src)
    art = jax_ckpt.save_params_artifact(
        str(tmp_path_factory.mktemp("bank") / "tiny_ep0002.ckpt"), header,
        {"params": raw["params"]})
    return src, art


def _port_trainer(workspace, tx=None, **kwargs):
    net = dbsrnet_tiny(upsample_factor=4)
    pool = ProceduralImagePool(4, CFG.pre_crop_sz, seed=3, device="cpu",
                               num_leaves=4)
    return Trainer(net, make_synthetic_actor(net, boundary_ignore=4),
                   tx or make_optimizer(base_lr=1e-3, steps_per_epoch=STEPS),
                   [LoaderSpec("train", ProceduralPoolBatcher(pool, 2, STEPS))],
                   make_pool_prepare_fn(CFG, 2), str(workspace),
                   net_name="tiny", print_interval=STEPS, seed=4,
                   device="cpu", **kwargs)


# -- params-only resume ------------------------------------------------------

def test_port_resumes_from_jax_params_only_artifact(tmp_path, jax_run, capsys):
    """JAX's artifact dropped into a fresh workspace: epoch 2, parameters
    bit-equal, fresh Adam (zero moments, count 0), ``step`` fast-forwarded
    to 2 x the batches of an epoch, the learning rate on the schedule's
    rung for ``step``; then epoch 3 trains and is written."""
    _, art = jax_run
    ws = tmp_path / "ws"
    ws.mkdir()
    (ws / "tiny_ep0002.ckpt").write_bytes(open(art, "rb").read())
    tx = make_optimizer(base_lr=1e-3, step_size_epochs=1, gamma=0.5,
                        steps_per_epoch=STEPS)
    t = _port_trainer(ws, tx)
    state = t._load_latest(t.init_state())
    assert t.epoch == 2 and state.step == 2 * STEPS and state.count == 0
    assert "resumed PARAMS-ONLY from" in capsys.readouterr().out
    _, raw = jax_ckpt.load_checkpoint(art)
    got = _leaves(params_to_flax(state.net.state_dict()))
    want = _leaves(raw["params"]["params"])
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k
    opt = state.opt_state()
    assert opt["count"] == 0 and not state.optimizer.state
    assert all(not v.any() for v in list(opt["mu"].values())
               + list(opt["nu"].values()))

    state = t.train(3)
    assert t.epoch == 3 and state.step == 3 * STEPS and state.count == STEPS
    # the last update ran at the rate for its step (rung 2), not for Adam's
    # count (rung 0)
    assert state.optimizer.param_groups[0]["lr"] == tx.schedule(
        3 * STEPS - 1) == 1e-3 * 0.25
    header, tree = ckpt.read_checkpoint(str(ws / "tiny_ep0003.ckpt"))
    assert header["epoch"] == 3 and not header.get("params_only")
    assert tree["step"] == 3 * STEPS and tree["opt_state"]["count"] == STEPS


def test_params_only_artifacts_read_both_ways(tmp_path, jax_run):
    """The port's artifact of JAX's checkpoint is JAX's artifact, byte for
    byte, and reads in JAX's ``load_checkpoint``; a port-trained checkpoint's
    artifact reads there too; both packages refuse to restore a train state
    from an artifact."""
    src, jax_art = jax_run
    header, tree = ckpt.read_checkpoint(src)
    port_art = ckpt.save_params_artifact(str(tmp_path / "port.ckpt"), header,
                                         {"params": tree["params"]})
    assert open(port_art, "rb").read() == open(jax_art, "rb").read()

    t = _port_trainer(tmp_path / "ws")
    t.train(1)
    full = ckpt.resolve_checkpoint(str(tmp_path / "ws"), "tiny", 1)
    header, tree = ckpt.read_checkpoint(full)
    art = ckpt.save_params_artifact(str(tmp_path / "a" / "tiny_p.ckpt"),
                                    header, {"params": tree["params"]})
    jheader, jraw = jax_ckpt.load_checkpoint(art)
    assert jheader["params_only"] and jheader["epoch"] == 1
    assert jheader["net_spec"] == header["net_spec"]
    got, want = _leaves(jraw["params"]), _leaves(tree["params"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # no Adam moments (the trainable parameters': the aligner is frozen)
    moments = sum(a.nbytes for a in _leaves(tree["opt_state"]).values())
    assert os.path.getsize(full) - os.path.getsize(art) >= moments > 0
    with pytest.raises(ValueError, match="params-only"):
        ckpt.load_train_state(art, t.init_state())
    with pytest.raises(ValueError, match="params-only"):
        ckpt.load_train_state(jax_art, t.init_state())
    with pytest.raises(ValueError, match="params-only"):
        jax_ckpt.load_checkpoint(art, state_template={})
    net, h = ckpt.load_network(jax_art, device="cpu")
    assert h["params_only"] and isinstance(net, type(t.net))


# -- the asynchronous writer ---------------------------------------------------

def test_async_checkpoint_writer_orders_and_flushes(tmp_path):
    w = ckpt.AsyncCheckpointWriter()
    order = []

    def slow(i):
        def fn():
            time.sleep(0.05)
            order.append(i)
            (tmp_path / f"f{i}").write_text("x")
        return fn

    for i in range(3):
        w.submit(slow(i))
    w.flush()
    assert order == [0, 1, 2]
    assert all((tmp_path / f"f{i}").exists() for i in range(3))
    w.close()
    assert not w._thread.is_alive()


def test_async_checkpoint_writer_surfaces_errors(capsys):
    w = ckpt.AsyncCheckpointWriter()
    w.submit(lambda: (_ for _ in ()).throw(OSError("disk full")))
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        w.flush()
    w.submit(lambda: (_ for _ in ()).throw(OSError("disk full")))
    w.flush(raise_on_error=False)  # the rollbacks' flush: logged
    assert "async checkpoint write failed" in capsys.readouterr().out
    w.submit(lambda: None)  # the writer stays usable
    w.close()


def test_trainer_async_save_lands_before_resume(tmp_path):
    """Every epoch of an async run is on disk when ``train`` returns, and a
    resume right after sees the last one."""
    t = _port_trainer(tmp_path, async_checkpoint=True)
    t.train(2)
    assert [e for e, _ in ckpt.list_checkpoints(str(tmp_path), "tiny")] == \
        [1, 2]
    again = _port_trainer(tmp_path, async_checkpoint=True)
    assert again.train(2).step == 2 * STEPS and again.epoch == 2


class _SyncCopyTrainer(Trainer):
    """Writes a synchronous copy of every checkpoint to ``copy_dir`` at the
    moment the asynchronous save is submitted."""

    copy_dir = None

    def _save(self, state):
        ckpt.save_checkpoint(self.copy_dir, self.net_name, self.epoch, state,
                             stats={n: s.averages()
                                    for n, s in self.stats.items()},
                             settings=self.header_settings)
        super()._save(state)


def test_async_checkpoint_is_the_epoch_it_was_submitted_at(tmp_path):
    """The epoch-1 write is held until epoch 2 has updated the parameters
    and Adam's moments in place; the file it writes must still be epoch 1's
    synchronous save, byte for byte (a writer that read the live state when
    it ran would write epoch 2's values). TensorBoard logs each epoch."""
    t = _port_trainer(tmp_path / "ws", async_checkpoint=True,
                      tensorboard_dir=str(tmp_path / "tb"))
    t.__class__ = _SyncCopyTrainer
    t.copy_dir = str(tmp_path / "sync")
    gate = threading.Event()
    submit, step = t._ckpt_writer.submit, t.train_step

    def held_submit(fn):
        def late():
            if not gate.wait(60):
                raise TimeoutError("epoch 2 never stepped")
            fn()
        submit(late)

    def train_step(state, g, data):
        out = step(state, g, data)
        if t.epoch == 2:
            gate.set()  # epoch 2 has stepped: let epoch 1's write run
        return out

    t._ckpt_writer.submit, t.train_step = held_submit, train_step
    state = t.train(2)
    assert state.step == 2 * STEPS
    for e in (1, 2):
        name = f"tiny_ep{e:04d}.ckpt"
        assert (tmp_path / "ws" / name).read_bytes() == \
            (tmp_path / "sync" / name).read_bytes(), name
    assert (tmp_path / "ws" / "tiny_ep0001.ckpt").read_bytes() != \
        (tmp_path / "ws" / "tiny_ep0002.ckpt").read_bytes()
    t.tb.close()
    acc = EventAccumulator(str(tmp_path / "tb" / "train"))
    acc.Reload()
    assert [e.step for e in acc.Scalars("Loss/total")] == [1, 2]


# -- TensorBoard, tracing -----------------------------------------------------

def _events(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        acc = EventAccumulator(os.path.join(directory, name),
                               size_guidance={"scalars": 0, "tensors": 0})
        acc.Reload()
        tags = acc.Tags()
        out[name] = {
            "scalars": {k: [(e.step, e.value) for e in acc.Scalars(k)]
                        for k in tags["scalars"]},
            "tensors": sorted(tags["tensors"])}
    return out


def test_tensorboard_writer_writes_what_jax_writes(tmp_path):
    """The same run info and epoch scalars through both writers give the
    same tags, steps and values per loader."""
    rng = np.random.RandomState(0)
    epochs = [{"Loss/total": float(rng.rand()), "Stat/psnr": float(rng.rand())}
              for _ in range(3)]
    for cls, d in ((JaxTBWriter, "jax"), (TensorboardWriter, "port")):
        w = cls(str(tmp_path / d), ["train", "val"])
        w.write_info("dbsr_synthetic", "a description")
        for e, scalars in enumerate(epochs, 1):
            w.write_epoch("train", scalars, e)
            if e % 2 == 0:
                w.write_epoch("val", scalars, e)
        w.close()
    port = _events(tmp_path / "port")
    assert port == _events(tmp_path / "jax")
    assert port["train"]["scalars"]["Stat/psnr"][2][0] == 3
    assert [s for s, _ in port["val"]["scalars"]["Loss/total"]] == [2]
    assert "script_name/text_summary" in port["train"]["tensors"]
    assert TensorboardWriter(str(tmp_path / "x"), ["a"]).available


def _steps(n):
    x = torch.ones(8, 8)
    for i in range(n):
        with maybe_trace(i):
            with annotate(f"probe_step_{i}"):
                x = x @ x / 8


def test_maybe_trace_records_steps_5_to_9(tmp_path, monkeypatch):
    monkeypatch.delenv("DBSR_TPU_TRACE_DIR", raising=False)
    _steps(12)
    assert not list(tmp_path.iterdir())  # unset: nothing
    monkeypatch.setenv("DBSR_TPU_TRACE_DIR", str(tmp_path))
    _steps(12)
    files = glob.glob(str(tmp_path / "trace_steps5-9_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert {f"probe_step_{i}" for i in range(5, 10)} <= names
    assert not names & {"probe_step_4", "probe_step_10"}
