"""The burst-frame axis sharded over gloo ranks
(``dbsr_tpu_torch/parallel/frame_sharding.py``) against the JAX package's
``parallel/frame_sharding.py`` on conftest's virtual CPU devices, and
against the dense fusion and forward; the merge's ``return_logits``
against JAX's.

One module fixture per world size (2 and 4) spawns that many processes of
this file; each initialises its group with explicit arguments
(``maybe_initialize_distributed(init_method="tcp://...", ...)``), runs
every check of that world size in that one group, and saves what it got.
The rank processes import torch and ``dbsr_tpu_torch`` only.

Tolerances: the fusion 1e-6 (a softmax in another order of summation);
the frame-sharded forward 2e-4 against JAX and 1e-5 against the port's
dense forward (float32, the merge's sums split over the ranks).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dbsr_tpu_torch.data.procedural import make_generator
from dbsr_tpu_torch.models.dbsr import dbsrnet_tiny
from dbsr_tpu_torch.models.layers import init_params
from dbsr_tpu_torch.parallel import frame_sharding as fs
from dbsr_tpu_torch.parallel import multihost

REPO = Path(__file__).resolve().parents[1]
N_FRAMES = 14
FUSION_SHAPE = (2, 4, 3, 5, 6)  # [B, N, H, W, C]
JAX_TOL, DENSE_TOL, FUSION_TOL = 2e-4, 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this module runs: the suite runs
    in parallel worker processes, and torch's many small CPU ops slow down
    several-fold when every worker spins a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _net():
    net = dbsrnet_tiny()
    init_params(net, make_generator("cpu", 7))
    return net.eval()


def _problem():
    """The burst and the fusion's inputs, from numpy seeds; a mask of the
    4 fusion frames with frame 2 invalid."""
    rng = np.random.RandomState(31)
    burst = rng.rand(2, N_FRAMES, 16, 16, 4).astype(np.float32)
    feats = rng.randn(*FUSION_SHAPE).astype(np.float32)
    logits = 3.0 * rng.randn(*FUSION_SHAPE).astype(np.float32)
    mask = np.array([1, 1, 0, 1], np.float32)
    return burst, feats, logits, mask


# ----------------------------------------------------------------------
# what every rank runs

def _rank_main(rank, world, port, root):
    torch.set_num_threads(1)
    assert multihost.maybe_initialize_distributed(
        init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
        backend="gloo", device_type="cpu")
    net = _net()
    burst, feats, logits, mask = (torch.from_numpy(a) for a in _problem())
    out = {"pred": fs.dbsr_apply_frame_sharded(net, burst)}
    k = FUSION_SHAPE[1] // world
    if world == 2:
        out["fused"] = fs.make_frame_sharded_fusion()(feats, logits)
        local = slice(rank * k, (rank + 1) * k)
        out["masked"] = fs.masked_sharded_softmax_fusion(
            feats[:, local], logits[:, local],
            mask[local].reshape(1, k, 1, 1, 1))
    else:
        frame_group, data_group = fs.make_data_frame_groups(2, 2)
        out["pred_2x2"] = fs.dbsr_apply_frame_sharded(net, burst, frame_group,
                                                      data_group)
    torch.save(out, os.path.join(root, f"w{world}_rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(world, root):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA", "DBSR_TPU_DIST"))}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(port), root],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [torch.load(os.path.join(root, f"w{world}_rank{r}.pt"))
            for r in range(world)]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _launch(2, str(tmp_path_factory.mktemp("fs2")))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _launch(4, str(tmp_path_factory.mktemp("fs4")))


# ----------------------------------------------------------------------
# the JAX side

@pytest.fixture(scope="module")
def jax_side():
    """The JAX tiny network on the port's parameters, its dense forward."""
    import jax
    from dbsr_tpu.models.dbsr import dbsrnet_tiny as jax_dbsrnet_tiny
    from dbsr_tpu_torch.utils.convert import params_to_flax

    net = _net()
    jnet = jax_dbsrnet_tiny(flow_net="lite")
    params = jax.tree.map(np.asarray,
                          {"params": params_to_flax(net.state_dict())})
    burst = _problem()[0]
    dense = np.asarray(jax.jit(jnet.apply)(params, burst)[0])
    return jnet, params, net, burst, dense


def _jax_sharded(jax_side, shape, names, data_axis=None):
    import jax
    from dbsr_tpu.parallel.frame_sharding import dbsr_apply_frame_sharded
    from dbsr_tpu.parallel.mesh import make_mesh
    jnet, params, _, burst, _ = jax_side
    mesh = make_mesh(int(np.prod(shape)), names,
                     shape if len(shape) > 1 else None)
    # jitted: shard_map run op by op takes minutes here
    fn = jax.jit(lambda p, b: dbsr_apply_frame_sharded(
        jnet, p, b, mesh, data_axis=data_axis))
    return np.asarray(fn(params, burst))


# ----------------------------------------------------------------------

def test_sharded_fusion_matches_jax_and_the_dense_merge(world2):
    from dbsr_tpu.parallel.frame_sharding import make_frame_sharded_fusion
    from dbsr_tpu.parallel.mesh import make_mesh
    from dbsr_tpu_torch.ops.merge import fused_softmax_merge_plain

    _, feats, logits, _ = _problem()
    want = np.asarray(make_frame_sharded_fusion(
        make_mesh(2, ("frame",)))(feats, logits))
    dense = fused_softmax_merge_plain(torch.from_numpy(feats),
                                      torch.from_numpy(logits)).numpy()
    for r in world2:
        np.testing.assert_allclose(r["fused"].numpy(), want, rtol=0,
                                   atol=FUSION_TOL)
        np.testing.assert_allclose(r["fused"].numpy(), dense, rtol=0,
                                   atol=FUSION_TOL)
    assert torch.equal(world2[0]["fused"], world2[1]["fused"])


def test_masked_sharded_fusion_matches_jax_and_a_softmax_over_the_valid(
        world2):
    """Frame 2 of 4 masked: JAX's ``masked_sharded_softmax_fusion`` in a
    ``shard_map`` over 2 devices, and the dense softmax over the other 3."""
    import jax
    from jax.sharding import PartitionSpec as P
    from dbsr_tpu.parallel.frame_sharding import masked_sharded_softmax_fusion
    from dbsr_tpu.parallel.mesh import make_mesh

    _, feats, logits, mask = _problem()
    fn = jax.shard_map(
        lambda f, l, m: masked_sharded_softmax_fusion(f, l, m, "frame"),
        mesh=make_mesh(2, ("frame",)),
        in_specs=(P(None, "frame"), P(None, "frame"), P(None, "frame")),
        out_specs=P())
    want = np.asarray(fn(feats, logits, mask.reshape(1, 4, 1, 1, 1)))
    keep = mask > 0
    w = np.exp(logits[:, keep] - logits[:, keep].max(1, keepdims=True))
    dense = (feats[:, keep] * w).sum(1) / w.sum(1)
    for r in world2:
        np.testing.assert_allclose(r["masked"].numpy(), want, rtol=0,
                                   atol=FUSION_TOL)
        np.testing.assert_allclose(r["masked"].numpy(), dense, rtol=0,
                                   atol=FUSION_TOL)


def test_frame_sharded_forward_over_two_ranks(world2, jax_side):
    """14 frames over 2 ranks: 13 others, 7 a rank, one padded frame."""
    _, _, net, burst, dense = jax_side
    want = _jax_sharded(jax_side, (2,), ("frame",))
    with torch.no_grad():
        port_dense = net(torch.from_numpy(burst))[0].numpy()
    np.testing.assert_allclose(want, dense, rtol=0, atol=JAX_TOL)
    for r in world2:
        np.testing.assert_allclose(r["pred"].numpy(), want, rtol=0,
                                   atol=JAX_TOL)
        np.testing.assert_allclose(r["pred"].numpy(), port_dense, rtol=0,
                                   atol=DENSE_TOL)
    assert torch.equal(world2[0]["pred"], world2[1]["pred"])


def test_frame_sharded_forward_over_four_ranks(world4, jax_side):
    """14 frames over 4 ranks (4 others a rank, 3 padded)."""
    _, _, net, burst, _ = jax_side
    want = _jax_sharded(jax_side, (4,), ("frame",))
    for r in world4:
        np.testing.assert_allclose(r["pred"].numpy(), want, rtol=0,
                                   atol=JAX_TOL)


def test_data_by_frame_two_by_two(world4, jax_side):
    """2 x 2 data x frame: each rank its data shard's row, fused over its
    frame group; the rows in data order equal JAX's (data, frame) mesh."""
    want = _jax_sharded(jax_side, (2, 2), ("data", "frame"),
                        data_axis="data")
    _, _, net, burst, _ = jax_side
    for rank, r in enumerate(world4):
        d = rank // 2
        assert r["pred_2x2"].shape[0] == 1
        np.testing.assert_allclose(r["pred_2x2"].numpy(), want[d:d + 1],
                                   rtol=0, atol=JAX_TOL)
    assert torch.equal(world4[0]["pred_2x2"], world4[1]["pred_2x2"])


def test_merge_return_logits_matches_jax(jax_side):
    """``WeightedSumMerge.forward(return_logits=True)``: the frames'
    features and the logits before the softmax, as JAX's merge returns
    them; the dense fusion of those is the merge's output."""
    from dbsr_tpu.models.dbsr import WeightedSumMerge as JaxMerge
    from dbsr_tpu_torch.ops.merge import fused_softmax_merge_plain

    jnet, params, net, _, _ = jax_side
    rng = np.random.RandomState(41)
    enc = {"ref_feat": rng.rand(2, 1, 8, 8, 16).astype(np.float32),
           "oth_feat": rng.rand(2, 3, 8, 8, 16).astype(np.float32),
           "offsets": 2.0 * rng.randn(2, 3, 8, 8, 2).astype(np.float32)}
    merge = JaxMerge(jnet.enc_out_dim, jnet.weight_pred_proj_dim,
                     jnet.offset_feat_dim, jnet.num_offset_feat_extractor_res,
                     jnet.num_weight_predictor_res, jnet.use_offset,
                     jnet.offset_modulo, jnet.softmax, jnet.use_base_frame,
                     jnet.ref_offset_noise, jnet.activation, jnet.dtype)
    want = merge.apply({"params": params["params"]["merging"]}, enc,
                       return_logits=True)
    with torch.no_grad():
        tenc = {k: torch.from_numpy(v) for k, v in enc.items()}
        got = net.merging(tenc, return_logits=True)
        fused = net.merging(tenc)["fused_enc"]
    assert set(got) == {"all_feat", "logits"}
    np.testing.assert_array_equal(got["all_feat"].numpy(),
                                  np.asarray(want["all_feat"]))
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        fused_softmax_merge_plain(got["all_feat"], got["logits"]).numpy(),
        fused.numpy(), rtol=0, atol=FUSION_TOL)


if __name__ == "__main__":
    _rank_main(*map(int, sys.argv[1:4]), sys.argv[4])
