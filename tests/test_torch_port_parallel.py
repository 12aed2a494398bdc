"""The port's data parallelism (``dbsr_tpu_torch/parallel``, the trainer's
all-reduce, the loaders' rank slices) and multi-device serving, on the CPU
with gloo, against the JAX package's ``data`` mesh on conftest's virtual
CPU devices.

One module fixture launches this file under ``python -m
torch.distributed.run --standalone --nproc_per_node=2`` with
``DBSR_TPU_DIST=1``: each rank initialises its group the way
``run_training`` does (``maybe_initialize_distributed()`` from torchrun's
environment), runs every 2-rank check below in that one group and saves
what it saw; the rank processes import torch and ``dbsr_tpu_torch`` only.
The tests then hold the ranks' results against JAX and against the same
code at one rank, run in this process.

Tolerances: against JAX and 1 rank against 2, rtol 1e-4 / atol 1e-6
(``PERF.md`` §2, a step; float32 sums in another order, and the ranks'
halves of the batch summed by the all-reduce); the two ranks against each
other, bit for bit.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dbsr_tpu_torch.configs.dbsr.default_realworld import BurstBatcher
from dbsr_tpu_torch.data import burstsr, datasets
from dbsr_tpu_torch.data.pipeline import CropBatcher, RandomImageSampler
from dbsr_tpu_torch.data.procedural import (ProceduralImagePool,
                                            ProceduralPoolBatcher,
                                            make_pool_prepare_fn)
from dbsr_tpu_torch.data.synthetic import BurstConfig
from dbsr_tpu_torch.models.dbsr import dbsrnet_tiny
from dbsr_tpu_torch.parallel import mesh, multihost
from dbsr_tpu_torch.serving import Predictor
from dbsr_tpu_torch.training import checkpoint as ckpt
from dbsr_tpu_torch.training.actors import make_synthetic_actor
from dbsr_tpu_torch.training.state import make_optimizer
from dbsr_tpu_torch.training.trainer import LoaderSpec, Trainer
from dbsr_tpu_torch.utils.png16 import write_png

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-6
CFG = BurstConfig(burst_size=3, crop_sz=(32, 32), border_crop=4,
                  max_translation=3.0, fused_resample=True)
STEP_B = 4          # the fixed-batch step: 2 rows a rank
POOL_B, POOL_STEPS = 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this module runs: the suite runs
    in parallel worker processes, and torch's many small CPU ops slow down
    several-fold when every worker spins a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# what every rank runs (and this process at one rank)

def _step_problem(root):
    """The fixed-batch step's parameters and batch, written by the test."""
    blob = torch.load(os.path.join(root, "step_problem.pt"))
    net = dbsrnet_tiny()
    net.load_state_dict(blob["params"], strict=True)
    return net, blob["batch"]


def _dp_step(root):
    """One train step through ``Trainer.train_step`` on this rank's rows of
    the fixed batch: the reduced loss, gradients and updated parameters."""
    net, batch = _step_problem(root)
    trainer = Trainer(net, make_synthetic_actor(net, boundary_ignore=40),
                      make_optimizer(base_lr=1e-4, steps_per_epoch=2), [],
                      lambda g, b: multihost.local_rows(b, STEP_B),
                      os.path.join(root, "unused"), device="cpu")
    state = trainer.tx.init(net)
    stats = trainer.train_step(state, None, batch)
    loss = stats["Loss/total"].reshape(1).clone()
    multihost.all_reduce_mean_([loss])
    grads = {k: p.grad.clone() for k, p in state.trainable().items()}
    return {"loss": loss, "grads": grads,
            "params": {k: v.clone() for k, v in net.state_dict().items()}}


def _realworld_sca(pred, gt, burst):
    """A stand-in for SCA's alignment: the prediction as it is, valid where
    the ground truth's red exceeds 0.25."""
    return pred, (gt[..., :1] > 0.25).float()


def _realworld_step(root):
    """One realworld-actor step (its masked mean, here of the L2 error: the
    L1's gradient jumps where a pixel's error changes sign, so the float32
    rounding of 1 rank and 2 ranks would part there) through
    ``Trainer.train_step`` on this rank's rows of the fixed batch, whose
    last two rows are dimmed so that far fewer of their pixels are valid:
    the reduced loss, gradients and updated parameters."""
    from dbsr_tpu_torch.training.actors import make_realworld_actor
    net, batch = _step_problem(root)
    batch["frame_gt"][2:] *= 0.3
    trainer = Trainer(net, make_realworld_actor(net, _realworld_sca,
                                                boundary_ignore=8,
                                                metric="l2"),
                      make_optimizer(base_lr=1e-4, steps_per_epoch=2), [],
                      lambda g, b: multihost.local_rows(b, STEP_B),
                      os.path.join(root, "unused"), device="cpu")
    state = trainer.tx.init(net)
    stats = trainer.train_step(state, None, batch)
    loss = stats["Loss/total"].reshape(1).clone()
    multihost.all_reduce_mean_([loss])
    grads = {k: p.grad.clone() for k, p in state.trainable().items()}
    return {"loss": loss, "grads": grads,
            "params": {k: v.clone() for k, v in net.state_dict().items()}}


def _pool_trainer(workspace):
    net = dbsrnet_tiny()
    train = ProceduralPoolBatcher(ProceduralImagePool(8, CFG.pre_crop_sz,
                                                      seed=0, device="cpu",
                                                      num_leaves=20),
                                  POOL_B, POOL_STEPS)
    val = ProceduralPoolBatcher(ProceduralImagePool(4, CFG.pre_crop_sz,
                                                    seed=999, device="cpu",
                                                    num_leaves=20),
                                POOL_B, 1)
    return Trainer(net, make_synthetic_actor(net, boundary_ignore=4),
                   make_optimizer(base_lr=1e-3, steps_per_epoch=POOL_STEPS),
                   [LoaderSpec("train", train),
                    LoaderSpec("val", val, training=False)],
                   make_pool_prepare_fn(CFG, POOL_B), workspace,
                   net_name="tiny", print_interval=1, seed=3, device="cpu")


def _pool_run(workspace):
    """An epoch of the pool path, then a second from its checkpoint in a new
    trainer: the stats, the parameters and who wrote the checkpoints."""
    writes = []
    real = ckpt.write_train_state

    def counted(*args, **kwargs):
        writes.append(args[2])  # the epoch
        return real(*args, **kwargs)

    ckpt.write_train_state = counted
    try:
        out = {}
        for epochs in (1, 2):
            trainer = _pool_trainer(workspace)
            trainer.train(epochs)
            out[epochs] = {"stats": {n: s.averages()
                                     for n, s in trainer.stats.items()},
                           "epoch": trainer.epoch,
                           "params": {k: v.clone() for k, v in
                                      trainer.net.state_dict().items()}}
    finally:
        ckpt.write_train_state = real
    out["writes"] = writes
    return out


def _smoke_tiny(workspace):
    """``run_training dbsr smoke_tiny`` (host-fed ``CropBatcher``), its
    last checkpoint's parameters."""
    from dbsr_tpu_torch.run_training import run_training
    os.environ["DBSR_TPU_WORKSPACE_DIR"] = workspace
    run_training("dbsr", "smoke_tiny", device="cpu", batch_size=2)
    multihost.barrier()  # rank 0's last write has landed
    path = ckpt.resolve_checkpoint(os.path.join(workspace, "dbsr",
                                                "smoke_tiny"), "smoke")
    return {"path": os.path.basename(path),
            "params": ckpt.read_checkpoint(path)[1]["params"]}


def _rank_main(root):
    """One rank of the 2-rank group (``torch.distributed.run``)."""
    torch.set_num_threads(1)
    assert multihost.maybe_initialize_distributed(device_type="cpu")
    r = multihost.rank()
    out = {"rank": r, "world": multihost.world_size(),
           "backend": torch.distributed.get_backend(),
           "node": (multihost.node_index(), multihost.node_count()),
           "slice": multihost.process_local_batch_slice(STEP_B),
           "step": _dp_step(root),
           "realworld": _realworld_step(root),
           "pool": _pool_run(os.path.join(root, "pool2")),
           "smoke": _smoke_tiny(os.path.join(root, "smoke2"))}
    try:
        multihost.process_local_batch_slice(5)
    except ValueError as e:
        out["odd_batch"] = str(e)
    torch.save(out, os.path.join(root, f"rank{r}.pt"))
    torch.distributed.destroy_process_group()


# ----------------------------------------------------------------------
# the JAX side and the launch

def _jax_tiny_problem():
    """The tiny DBSR's parameters (random, flax layout) and a fixed batch
    of ``STEP_B`` from a numpy seed."""
    import jax
    from dbsr_tpu.models.dbsr import dbsrnet_tiny as jax_dbsrnet_tiny
    from dbsr_tpu_torch.utils.convert import params_from_flax

    rng = np.random.RandomState(21)
    batch = {"burst": rng.rand(STEP_B, 3, 16, 16, 4).astype(np.float32),
             "frame_gt": rng.rand(STEP_B, 128, 128, 3).astype(np.float32)}
    jnet = jax_dbsrnet_tiny(flow_net="lite")
    shapes = jax.eval_shape(jnet.init, jax.random.key(0), batch["burst"])
    prng = np.random.RandomState(22)

    def fill(node, fan_in=None):  # U[-1/sqrt(fan_in), +], as the grad tests
        kernel = node.get("kernel")
        if kernel is not None:
            fan_in = int(np.prod(kernel.shape[:-1]))
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            else:
                b = 1.0 / np.sqrt(fan_in)
                out[k] = prng.uniform(-b, b, v.shape).astype(np.float32)
        return out

    params = fill(shapes)
    return jnet, params, batch, params_from_flax(params)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results, and the JAX side's problem they ran."""
    root = str(tmp_path_factory.mktemp("dp2"))
    jnet, params, batch, torch_params = _jax_tiny_problem()
    torch.save({"params": torch_params,
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()}},
               os.path.join(root, "step_problem.pt"))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env.update(PYTHONPATH=str(REPO), DBSR_TPU_DIST="1", OMP_NUM_THREADS="1",
               DBSR_TPU_ENV=os.path.join(root, "env.json"))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", __file__, root], env=env, cwd=root,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-5000:]
    res = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
           for r in range(2)]
    return {"root": root, "ranks": res, "jax": (jnet, params, batch),
            "log": out.stdout}


# ----------------------------------------------------------------------
# the helpers, single-process

def test_maybe_initialize_distributed_is_a_no_op_without_the_variable(
        monkeypatch):
    monkeypatch.delenv("DBSR_TPU_DIST", raising=False)
    assert not multihost.distributed_requested()
    assert multihost.maybe_initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    assert (multihost.world_size(), multihost.rank(),
            multihost.node_count(), multihost.node_index()) == (1, 0, 1, 0)
    assert multihost.is_main_process()
    assert multihost.process_local_batch_slice(7) == (0, 7)
    tree = {"a": torch.arange(6)}
    assert multihost.local_rows(tree, 6) is tree
    for v in ("0", "", "false"):
        monkeypatch.setenv("DBSR_TPU_DIST", v)
        assert not multihost.distributed_requested()


def test_dist_requested_without_a_launcher_raises(monkeypatch):
    """``DBSR_TPU_DIST=1`` with no WORLD_SIZE / RANK raises: training never
    carries on single-process in its place."""
    monkeypatch.setenv("DBSR_TPU_DIST", "1")
    for k in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        multihost.maybe_initialize_distributed()


def test_the_jax_helpers_agree_single_process():
    from dbsr_tpu.parallel import multihost as jmh
    assert jmh.process_local_batch_slice(8) == \
        multihost.process_local_batch_slice(8)


def test_make_mesh_and_shard_batch_split_in_order():
    devs = mesh.make_mesh(2, "cpu")
    assert devs == [torch.device("cpu")] * 2
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    parts = mesh.shard_batch(devs, {"x": x, "y": [torch.ones(4)]})
    assert len(parts) == 2
    np.testing.assert_array_equal(parts[1]["x"].numpy(), x[2:])
    assert parts[0]["y"][0].shape == (2,)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.shard_batch(mesh.make_mesh(3, "cpu"), x)


@pytest.mark.parametrize("pid", [0, 1])
def test_fold_in_process_is_the_jax_seed_arithmetic(pid):
    """The pools' folded seeds and mixed plans, and a folded ``CropBatcher``'s
    batches, equal the JAX package's for node 0 and 1."""
    from dbsr_tpu.data.pipeline import CropBatcher as JaxCropBatcher
    from dbsr_tpu.data.pipeline import RandomImageSampler as JaxSampler
    from dbsr_tpu.data.procedural import ProceduralImagePool as JaxPool
    from dbsr_tpu.data.procedural import ProceduralPoolBatcher as JaxBatcher
    from dbsr_tpu.data.procedural import _mix_plan

    for mix in ("deadleaves", "mixed"):
        pool = ProceduralImagePool(256, (8, 8), seed=5, device="cpu", mix=mix)
        jpool = JaxPool(256, (8, 8), seed=5, mix=mix)
        ProceduralPoolBatcher(pool, 2, 1).fold_in_process(pid)
        JaxBatcher(jpool, 2, 1).fold_in_process(pid)
        assert pool.seed == jpool.seed
        assert pool.plan(3) == (_mix_plan(8, jpool.seed + 3)
                                if mix == "mixed" else ["dead_leaves"] * 8)

    class Images:
        def get_num_images(self):
            return 3

        def get_image(self, i):
            return np.full((20, 24, 3), 40 * i, np.uint8), {}

    got = CropBatcher(RandomImageSampler([Images()], [1.0], 8), 2, (8, 8),
                      seed=4)
    want = JaxCropBatcher(JaxSampler([Images()], [1.0], 8), 2, (8, 8), seed=4)
    got.fold_in_process(pid)
    want.fold_in_process(pid)
    for _ in range(3):
        np.testing.assert_array_equal(got.next_batch(), want.next_batch())


def _pngs(tmp_path, n=5):
    rng = np.random.RandomState(3)
    for i in range(n):
        h, w = 40 + 4 * i, 50 + 2 * i
        write_png(str(tmp_path / f"{i}.png"),
                  rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    return datasets.ImageFolder(str(tmp_path))


def _as_rank(monkeypatch, r, n):
    monkeypatch.setattr(multihost, "process_local_batch_slice",
                        lambda b: (r * (b // n), b // n))


@pytest.mark.parametrize("jitter", [0.0, 0.2])
def test_crop_batcher_rank_rows_decode_only_their_images(tmp_path,
                                                         monkeypatch, jitter):
    """Each of 2 ranks' batches are its rows of the 1-rank batches, batch
    after batch (the stream advanced over the others' rows from the PNG
    headers alone), and each decodes only its own images."""
    folder = _pngs(tmp_path)
    assert [datasets.image_size(os.path.join(folder.root, f))
            for f in folder.image_list] == [
        folder.get_image(i)[0].shape[:2] for i in range(5)]

    def batcher():
        return CropBatcher(RandomImageSampler([folder], [1.0], 12), 4,
                           (24, 24), scale_range=(0.5, 1.0),
                           ar_range=(0.8, 1.2), brightness_jitter=jitter,
                           seed=9)

    full = batcher()
    want = [full.next_batch() for _ in range(3)]
    decodes = []
    real = datasets.ImageFolder.get_image
    monkeypatch.setattr(datasets.ImageFolder, "get_image",
                        lambda self, i, info=None: (decodes.append(i),
                                                    real(self, i, info))[1])
    for r in range(2):
        _as_rank(monkeypatch, r, 2)
        b = batcher()
        decodes.clear()
        for want_b in want:
            np.testing.assert_array_equal(b.next_batch(),
                                          want_b[2 * r:2 * r + 2])
        assert len(decodes) == 6  # 2 rows a batch, 3 batches


def test_a_decode_that_fails_after_its_header_raises_under_ranks(
        tmp_path, monkeypatch):
    """An image whose header reads but whose pixels do not: one rank a node
    retries it on a fresh draw (the JAX package's sampler); the skipping
    ranks read its header alone and could not follow that retry, so under
    2 ranks its owner raises instead of drifting the streams apart."""
    from dbsr_tpu_torch.data.pipeline import OutOfStep
    folder = _pngs(tmp_path, n=2)
    bad = os.path.join(folder.root, folder.image_list[0])
    with open(bad, "r+b") as f:  # keep the signature and IHDR, cut IDAT
        f.truncate(60)
    sampler = RandomImageSampler([folder], [1.0], 4)

    def first_image(seed):  # the sampler's first draw: dataset, then image
        rng = np.random.default_rng(seed)
        rng.choice(1, p=sampler.p)
        return rng.integers(0, 2)

    seed = next(s for s in range(100) if first_image(s) == 0)
    assert sampler.sample_shape(np.random.default_rng(seed)) == \
        datasets.image_size(bad)
    got = sampler.sample(np.random.default_rng(seed))
    assert got.shape[:2] == datasets.image_size(
        os.path.join(folder.root, folder.image_list[1]))
    monkeypatch.setattr(multihost, "local_world_size", lambda: 2)
    with pytest.raises(OutOfStep, match="does not decode"):
        sampler.sample(np.random.default_rng(seed))


def test_burst_batcher_rank_rows_read_only_their_bursts(tmp_path,
                                                        monkeypatch):
    from dbsr_tpu_torch.data.make_synthetic_burstsr import generate_dataset

    root = str(tmp_path / "bsr")
    generate_dataset(root, bursts=3, lr=24, n_frames=6, split="train",
                     device="cpu")
    proc = burstsr.BurstSRProcessing(crop_sz=8, substract_black_level=True,
                                     random_flip=True,
                                     noise_level=(1e-3, 1e-2))

    def batcher():
        return BurstBatcher(burstsr.RandomBurstSampler(
            burstsr.BurstSRDataset(root, split="train"), burst_size=4,
            samples_per_epoch=8, processing=proc, seed=2), 4)

    full = batcher()
    want = [full.next_batch() for _ in range(2)]
    reads = []
    real = burstsr.BurstSRDataset.get_burst
    monkeypatch.setattr(burstsr.BurstSRDataset, "get_burst",
                        lambda self, *a: (reads.append(a[0]),
                                          real(self, *a))[1])
    for r in range(2):
        _as_rank(monkeypatch, r, 2)
        b = batcher()
        reads.clear()
        for want_b in want:
            got = b.next_batch()
            for k in ("burst", "frame_gt"):
                np.testing.assert_array_equal(got[k],
                                              want_b[k][2 * r:2 * r + 2])
        assert len(reads) == 4


def test_single_device_refuses_a_process_group(monkeypatch):
    monkeypatch.setattr(multihost, "world_size", lambda: 2)
    net = dbsrnet_tiny()
    with pytest.raises(ValueError, match="single_device"):
        Trainer(net, None, make_optimizer(), [], None, "unused",
                device="cpu", data_parallel=False)


def test_multi_device_predictor_matches_one_device():
    """``Predictor(devices=["cpu", "cpu"])``: two replicas, each its half of
    the batch, gathered in order, within 1e-6 of one device; a batch of 7
    over 2 devices raises the JAX package's error."""
    net = dbsrnet_tiny()
    from dbsr_tpu_torch.data.procedural import make_generator
    from dbsr_tpu_torch.models.layers import init_params
    init_params(net, make_generator("cpu", 1))
    one = Predictor(net, 4, 3, (16, 16), torch.device("cpu"))
    two = Predictor(net, 4, 3, (16, 16), torch.device("cpu"),
                    devices=["cpu", "cpu"])
    assert len(two.nets) == 2 and two.nets[1] is not two.nets[0]
    burst = np.random.RandomState(5).rand(3, 3, 16, 16, 4).astype(np.float32)
    np.testing.assert_allclose(two(burst), one(burst), rtol=0, atol=1e-6)
    two.warm_up()
    assert two.flops_per_batch == one.warm_up().flops_per_batch
    with pytest.raises(ValueError, match="not divisible by the mesh"):
        Predictor(net, 7, 3, (16, 16), torch.device("cpu"),
                  devices=["cpu", "cpu"])


def test_load_predictor_takes_a_device_list(tmp_path):
    from dbsr_tpu_torch.serving import load_predictor
    net = dbsrnet_tiny()
    from dbsr_tpu_torch.data.procedural import make_generator
    from dbsr_tpu_torch.models.layers import init_params
    init_params(net, make_generator("cpu", 2))
    state = make_optimizer().init(net)
    path = ckpt.save_checkpoint(str(tmp_path), "tiny", 1, state)
    pred = load_predictor(path, batch_size=2, burst_size=3,
                          burst_hw=(16, 16), dtype=None, fused_s2d=False,
                          devices=["cpu", "cpu"])
    assert pred.devices == [torch.device("cpu")] * 2
    burst = np.random.RandomState(6).rand(2, 3, 16, 16, 4).astype(np.float32)
    with torch.no_grad():
        want = net(torch.from_numpy(burst))[0].clamp(0, 1).numpy()
    np.testing.assert_allclose(pred(burst), want, rtol=0, atol=1e-6)


# ----------------------------------------------------------------------
# the 2-rank group

def test_two_ranks_ran_one_gloo_group_from_torchrun(ranks):
    r0, r1 = ranks["ranks"]
    assert (r0["rank"], r1["rank"]) == (0, 1)
    assert r0["world"] == r1["world"] == 2
    assert r0["backend"] == "gloo"
    assert r0["node"] == r1["node"] == (0, 1)  # one node: no fold
    assert (r0["slice"], r1["slice"]) == ((0, 2), (2, 2))
    assert "not divisible by process count 2" in r0["odd_batch"]


def _leaves(tree):
    import jax
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_data_parallel_step_matches_the_jax_mesh_step(ranks):
    """One step on 2 gloo ranks (2 rows each) against JAX's ``Trainer`` with
    ``mesh=make_mesh(2)`` on the whole batch: the loss, the reduced
    gradients (the mesh step's, read from masked Adam's first moment) and
    the parameters after the step; the ranks' gradients and parameters
    bit-equal."""
    import jax
    from dbsr_tpu.parallel.mesh import make_mesh
    from dbsr_tpu.training import actors as jactors
    from dbsr_tpu.training import state as jstate
    from dbsr_tpu.training.trainer import Trainer as JaxTrainer
    from dbsr_tpu_torch.utils.convert import params_to_flax

    jnet, params, batch = ranks["jax"]
    tx = jstate.make_optimizer(base_lr=1e-4, steps_per_epoch=2,
                               freeze_subtree="alignment_net")
    jt = JaxTrainer(jnet, jactors.make_synthetic_actor(jnet,
                                                       boundary_ignore=40),
                    tx, [], CFG, os.path.join(ranks["root"], "jax"),
                    mesh=make_mesh(2), prepare_fn=lambda key, b: b,
                    cast_uint8_inputs=False)
    jparams = jax.tree.map(np.asarray, params)
    state = jstate.TrainState.create(jparams, tx)
    new_state, jstats = jt._train_step(state, jax.random.key(0), batch)
    # the mesh step's reduced gradient, from Adam's first moment after one
    # update: mu = (1 - b1) g
    want = {}
    for path, v in jax.tree_util.tree_leaves_with_path(new_state.opt_state):
        k = jax.tree_util.keystr(path)
        if ".mu['params']" in k:
            want[k.split(".mu['params']")[1]] = np.asarray(v) / (1.0 - 0.9)

    r0, r1 = (r["step"] for r in ranks["ranks"])
    np.testing.assert_allclose(r0["loss"].item(), float(jstats["Loss/total"]),
                               rtol=RTOL)
    assert torch.equal(r0["loss"], r1["loss"])
    got = _leaves(params_to_flax(r0["grads"]))
    assert got and set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    want = _leaves(new_state.params["params"])
    got = _leaves(params_to_flax(r0["params"]))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    for k, v in r0["params"].items():
        assert torch.equal(v, r1["params"][k]), k
    for k, v in r0["grads"].items():
        assert torch.equal(v, r1["grads"][k]), k


def test_realworld_masked_mean_over_two_ranks_is_one_ranks(ranks):
    """The realworld actor's masked L1 on 2 ranks whose rows hold very
    different shares of valid pixels (about 3/4 and 1/6) takes the step of
    one masked mean over the whole batch at 1 rank: the loss, the reduced
    gradients and the parameters after the step; the ranks bit-equal."""
    one = _realworld_step(ranks["root"])
    r0, r1 = (r["realworld"] for r in ranks["ranks"])
    np.testing.assert_allclose(r0["loss"].item(), one["loss"].item(),
                               rtol=RTOL)
    assert torch.equal(r0["loss"], r1["loss"])
    for part in ("grads", "params"):
        assert set(r0[part]) == set(one[part])
        for k, v in one[part].items():
            np.testing.assert_allclose(r0[part][k].numpy(), v.numpy(),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{part} {k}")
            assert torch.equal(r0[part][k], r1[part][k]), k


def test_two_ranks_take_the_steps_of_one_on_the_pool_path(ranks, tmp_path):
    """Two epochs of the device-pool path (a val pass each), the second
    resumed from the first's checkpoint in a new trainer, at 2 ranks and at
    1 rank (this process): the stats and parameters agree, the ranks'
    parameters are bit-equal, and rank 0 alone wrote the checkpoints."""
    one = _pool_run(str(tmp_path / "pool1"))
    r0, r1 = (r["pool"] for r in ranks["ranks"])
    assert r0["writes"] == [1, 2] and r1["writes"] == []
    assert one["writes"] == [1, 2]
    assert sorted(os.listdir(os.path.join(ranks["root"], "pool2"))) == [
        "tiny_ep0001.ckpt", "tiny_ep0002.ckpt"]
    for epochs in (1, 2):
        assert r0[epochs]["epoch"] == r1[epochs]["epoch"] == epochs
        for loader in ("train", "val"):
            for k, v in one[epochs]["stats"][loader].items():
                np.testing.assert_allclose(r0[epochs]["stats"][loader][k], v,
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=f"{epochs} {loader} {k}")
                assert r0[epochs]["stats"][loader][k] == \
                    r1[epochs]["stats"][loader][k]
        for k, v in one[epochs]["params"].items():
            np.testing.assert_allclose(r0[epochs]["params"][k].numpy(),
                                       v.numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{epochs} {k}")
            assert torch.equal(r0[epochs]["params"][k],
                               r1[epochs]["params"][k]), k


def test_run_training_under_torchrun_equals_one_process(ranks, tmp_path,
                                                        monkeypatch):
    """``run_training dbsr smoke_tiny`` (host-fed ``CropBatcher``, batch 2:
    one row a rank) on 2 ranks writes one checkpoint, and its parameters
    equal one process's."""
    from dbsr_tpu_torch.run_training import run_training
    ws = str(tmp_path / "smoke1")
    monkeypatch.setenv("DBSR_TPU_WORKSPACE_DIR", ws)
    monkeypatch.setenv("DBSR_TPU_ENV", str(tmp_path / "env.json"))
    monkeypatch.delenv("DBSR_TPU_DIST", raising=False)
    run_training("dbsr", "smoke_tiny", device="cpu", batch_size=2)
    path = ckpt.resolve_checkpoint(os.path.join(ws, "dbsr", "smoke_tiny"),
                                   "smoke")
    want = _leaves(ckpt.read_checkpoint(path)[1]["params"])
    r0, r1 = (r["smoke"] for r in ranks["ranks"])
    assert r0["path"] == r1["path"] == os.path.basename(path)
    g0, g1 = _leaves(r0["params"]), _leaves(r1["params"])
    assert set(g0) == set(want)
    for k in want:
        np.testing.assert_allclose(g0[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
        assert np.array_equal(g0[k], g1[k]), k


if __name__ == "__main__":
    _rank_main(sys.argv[1])
