"""bf16 training, the JAX package's default compute dtype, against the JAX
package on the CPU, inputs made from a seed with numpy and the same
parameters on both sides.

* The gradients of the encoder, the ``WeightedSumMerge`` and the decoder
  (all three forms) in bf16, every parameter's and the input's together,
  for the loss ``sum(out * r)`` with a fixed random ``r``: within relative
  L2 2e-2 of JAX's bf16 gradients (``util_scripts/tpu_parity_check.py``'s
  bf16 limit, ``test_torch_port_bf16.py``'s for the forward) and no farther
  from JAX's float32 ones than twice JAX bf16's own distance to them.
  The biases' gradients, sums over the batch and the plane, by the second
  limit alone: JAX on the CPU sums them in bf16, PyTorch in float32.
* A tiny ``dbsrnet`` train step in bf16, the aligner frozen and trained:
  the loss within 1e-2 relative, the gradients as above; parameters,
  their gradients and Adam's moments float32.
* Checkpoints: a bf16 network's ``net_spec`` records
  ``{"__dtype__": "bfloat16"}`` and each package rebuilds the other's bf16
  network; ``default_synthetic`` builds a bf16 network by default, float32
  with ``compute_dtype=float32``; ``default_realworld`` restores a bf16
  checkpoint in bf16 and fine-tunes it.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbsr_tpu.models import dbsr as jdbsr
from dbsr_tpu.training import actors as jactors
from dbsr_tpu.training.checkpoint import load_network as jax_load_network
from dbsr_tpu.training.checkpoint import save_checkpoint as jax_save
from dbsr_tpu_torch.configs.dbsr import default_synthetic
from dbsr_tpu_torch.data import make_synthetic_burstsr
from dbsr_tpu_torch.environment import Settings
from dbsr_tpu_torch.models import dbsr
from dbsr_tpu_torch.models.layers import compute_dtype_of, set_compute_dtype
from dbsr_tpu_torch.ops.conv_s2d import FINE_PATCH_ENV
from dbsr_tpu_torch.run_training import run_training
from dbsr_tpu_torch.training import checkpoint as ckpt
from dbsr_tpu_torch.training.actors import make_synthetic_actor
from dbsr_tpu_torch.training.state import make_optimizer
from dbsr_tpu_torch.utils.convert import params_from_flax, params_to_flax

BF = torch.bfloat16
ALIGN_LITE = str(Path(__file__).resolve().parents[1]
                 / "dbsr_tpu/artifacts/align_lite_params.ckpt")
REL_L2 = 2e-2    # util_scripts/tpu_parity_check.py:259-270, bf16
LOSS_RTOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this module runs (the suite runs
    in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _random_params(shapes, seed):
    """A flax tree of ``shapes`` filled with U[-1/sqrt(fan_in), +] draws."""
    rng = np.random.RandomState(seed)

    def fill(node):
        out = {}
        kernel = node.get("kernel")
        fan_in = (np.prod(kernel.shape[:-1]) if kernel is not None
                  else None)
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            else:
                b = 1.0 / np.sqrt(fan_in)
                out[k] = rng.uniform(-b, b, v.shape).astype(np.float32)
        return out

    return fill(shapes)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _flat(d):
    """The values of ``d`` by sorted key, as one float64 vector."""
    return np.concatenate([np.asarray(d[k], np.float64).ravel()
                           for k in sorted(d)])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _check_bf16(got, want_bf16, want_f32):
    """``got`` (the port's bf16 gradients, flattened) within REL_L2 of JAX's
    bf16 ones, and no farther from JAX's float32 ones than twice JAX bf16's
    own distance."""
    rel = _rel(got, want_bf16)
    port, ref = _rel(got, want_f32), _rel(want_bf16, want_f32)
    assert rel <= REL_L2 and port <= 2 * ref, (rel, port, ref)


def _port_grads(module, inputs, r):
    """The port module's gradients of ``sum(out * r)``: by flax path, the
    parameters' and, as ``input<i>``, the inputs' (float32 values)."""
    xs = [x.requires_grad_(True) for x in inputs]
    out = module(*xs)
    (out.float() * torch.from_numpy(r)).sum().backward()
    grads = {f"params{k}": v for k, v in _leaves(params_to_flax(
        {n: p.grad for n, p in module.named_parameters()})).items()}
    for p in module.parameters():
        assert p.dtype == p.grad.dtype == torch.float32
    for i, x in enumerate(xs):
        grads[f"input{i}"] = x.grad.float().numpy()
    return grads


def _jax_grads(make, params, inputs, r, argnums_inputs=True):
    """JAX's gradients of the same loss at bf16 and at float32, as
    :func:`_port_grads` names them."""
    out = []
    for dt in (jnp.bfloat16, None):
        m = make(dt)

        def loss(p, *xs):
            return (m.apply(p, *xs).astype(jnp.float32) * r).sum()

        argnums = tuple(range(1 + len(inputs))) if argnums_inputs else (0,)
        gs = jax.jit(jax.grad(loss, argnums=argnums))(params, *inputs)
        grads = {f"params{k}": v for k, v in _leaves(gs[0]["params"]).items()}
        for i, gx in enumerate(gs[1:]):
            grads[f"input{i}"] = np.asarray(gx, np.float32)
        out.append(grads)
    return out


def _compare(got, want_bf16, want_f32):
    """The kernels' and the inputs' gradients together by
    :func:`_check_bf16`; the biases' together by its second limit alone,
    no farther from JAX's float32 ones than twice JAX bf16's own distance:
    a bias's gradient is the sum of the output gradient over the batch and
    the plane, which PyTorch accumulates in float32 (one rounding to bf16)
    and JAX on the CPU in bf16 (the transpose of the bias's broadcast; see
    :func:`test_jax_cpu_sums_a_bf16_bias_gradient_in_bf16`), so that JAX
    bf16's were 0.38 of the norm off its own float32 ones at the tiny
    network's last conv, where the port's were 3e-3."""
    assert set(got) == set(want_bf16) == set(want_f32)
    bias = {k for k in got if k.endswith("['bias']")}
    rest = set(got) - bias
    _check_bf16(*[_flat({k: d[k] for k in rest})
                  for d in (got, want_bf16, want_f32)])
    if bias:
        b_got, b_bf16, b_f32 = [_flat({k: d[k] for k in bias})
                                for d in (got, want_bf16, want_f32)]
        port, ref = _rel(b_got, b_f32), _rel(b_bf16, b_f32)
        assert port <= 2 * ref, (port, ref)


def test_jax_cpu_sums_a_bf16_bias_gradient_in_bf16():
    """Why the biases' gradients are held against float32: 10^4 output
    gradients of 1 give a bf16 bias a gradient of 4096 in JAX on the CPU
    (a bf16 running sum stops growing there) and 9984 here, 10^4 rounded
    once to bf16 (float32 accumulation)."""
    def jax_loss(b):
        y = jnp.ones((100, 100, 4), jnp.bfloat16) + b.astype(jnp.bfloat16)
        return y.astype(jnp.float32).sum()

    assert np.all(np.asarray(jax.grad(jax_loss)(jnp.zeros(4))) == 4096)
    b = torch.zeros(4, requires_grad=True)
    (torch.ones(100, 100, 4, dtype=BF) + b.to(BF)).float().sum().backward()
    assert torch.all(b.grad == torch.tensor(10_000.0).to(BF).float())
    assert b.grad[0].item() == 9984


def test_encoder_bf16_gradients_match_jax():
    x = np.random.RandomState(30).rand(4, 8, 8, 4).astype(np.float32)
    make = lambda dt: jdbsr.ResEncoder(  # noqa: E731
        init_dim=8, num_res_blocks=1, out_dim=16, dtype=dt)
    params = _random_params(jax.eval_shape(
        make(None).init, jax.random.key(0), jnp.asarray(x)), 31)
    r = _rand((4, 8, 8, 16), 32)
    want = _jax_grads(make, params, (jnp.asarray(x),), r)
    m = dbsr.ResEncoder(4, 8, 1, 16)
    m.load_state_dict(params_from_flax(params), strict=True)
    set_compute_dtype(m, "bfloat16")
    _compare(_port_grads(m, [torch.from_numpy(x)], r), *want)


def test_weighted_sum_merge_bf16_gradients_match_jax():
    """The merge's parameters and the embeddings' gradients (through the
    merge's backward), the offsets float32 and without gradient, as the
    frozen aligner gives them."""
    feat = _rand((2, 3, 8, 8, 16), 33)
    offsets = _rand((2, 2, 8, 8, 2), 34, 3.0)
    kw = dict(input_dim=16, project_dim=4, offset_feat_dim=4,
              num_weight_predictor_res=1)

    def make(dt):
        class Merge(jdbsr.WeightedSumMerge):
            def __call__(self, ref, oth):
                return super().__call__({"ref_feat": ref, "oth_feat": oth,
                                         "offsets": jnp.asarray(offsets)}
                                        )["fused_enc"]
        return Merge(dtype=dt, **kw)

    jin = (jnp.asarray(feat[:, :1]).astype(jnp.bfloat16),
           jnp.asarray(feat[:, 1:]).astype(jnp.bfloat16))
    params = _random_params(jax.eval_shape(
        make(None).init, jax.random.key(0), *jin), 35)
    r = _rand((2, 8, 8, 16), 36)
    want = _jax_grads(make, params, jin, r)
    m = dbsr.WeightedSumMerge(16, 4, 4, 1, 1)
    m.load_state_dict(params_from_flax(params), strict=True)
    set_compute_dtype(m, "bfloat16")
    off = torch.from_numpy(offsets)

    def fwd(ref, oth):
        return m({"ref_feat": ref, "oth_feat": oth,
                  "offsets": off})["fused_enc"]

    fwd.named_parameters, fwd.parameters = m.named_parameters, m.parameters
    got = _port_grads(fwd, [torch.from_numpy(feat[:, :1]).to(BF),
                            torch.from_numpy(feat[:, 1:]).to(BF)], r)
    _compare(got, *want)


@pytest.mark.parametrize("form", ["fine", "s2d_dense", "s2d_kernel"])
def test_decoder_bf16_gradients_match_jax(form, monkeypatch):
    """The decoder's parameters and input: the fine form, and the s2d form
    through the structured-dense conv and through the fine-patch conv's
    ``Function`` (d_input in bf16 on the rotated weight, d_kernel float32),
    against JAX's dense s2d decoder."""
    monkeypatch.setenv(FINE_PATCH_ENV, "1" if form == "s2d_kernel" else "0")
    x = _rand((2, 6, 6, 16), 37)
    kw = dict(init_conv_dim=8, num_pre_res_blocks=1, post_conv_dim=8,
              num_post_res_blocks=1, upsample_factor=8)
    s2d = form != "fine"
    make = lambda dt: jdbsr.PixShuffleDecoder(  # noqa: E731
        dtype=dt, fused_s2d=s2d, **kw)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    params = _random_params(jax.eval_shape(
        make(None).init, jax.random.key(0), jx), 38)
    r = _rand((2, 48, 48, 3), 39)
    want = _jax_grads(make, params, (jx,), r)
    m = dbsr.PixShuffleDecoder(16, fused_s2d=s2d, **kw)
    m.load_state_dict(params_from_flax(params), strict=True)
    set_compute_dtype(m, "bfloat16")
    _compare(_port_grads(m, [torch.from_numpy(x).to(BF)], r), *want)


# ---------------------------------------------------------------------------
# a tiny train step


@pytest.fixture(scope="module")
def tiny_problem():
    """The tiny network's random parameters and one batch (as
    ``test_torch_port_bf16.py``'s forward test, with a ground truth)."""
    rng = np.random.RandomState(14)
    batch = {"burst": rng.rand(2, 3, 16, 16, 4).astype(np.float32),
             "frame_gt": rng.rand(2, 128, 128, 3).astype(np.float32)}
    jnet = jdbsr.dbsrnet_tiny(flow_net="lite")
    params = _random_params(jax.eval_shape(
        jnet.init, jax.random.key(0), jnp.asarray(batch["burst"])), 15)
    return batch, params


@pytest.mark.parametrize("train_alignment", [False, True])
def test_tiny_bf16_train_step_matches_jax(tiny_problem, train_alignment):
    batch, params = tiny_problem
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = []
    for dt in (jnp.bfloat16, None):
        jnet = jdbsr.dbsrnet_tiny(flow_net="lite", dtype=dt,
                                  train_alignment=train_alignment)
        actor = jactors.make_synthetic_actor(jnet, boundary_ignore=40)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: actor(p, jbatch), has_aux=True))(params)
        want.append((float(loss), _leaves(grads["params"])))

    net = dbsr.dbsrnet_tiny(dtype="bfloat16",
                            train_alignment=train_alignment)
    net.load_state_dict(params_from_flax(params), strict=True)
    state = make_optimizer().init(net)
    actor = make_synthetic_actor(net, boundary_ignore=40)
    loss, _ = actor({k: torch.from_numpy(v) for k, v in batch.items()})
    assert loss.dtype == torch.float32
    loss.backward()
    np.testing.assert_allclose(loss.item(), want[0][0], rtol=LOSS_RTOL)

    got = _leaves(params_to_flax({k: p.grad for k, p in
                                  net.named_parameters() if p.requires_grad}))
    aligner = {k for k in want[0][1] if "alignment_net" in k}
    assert aligner
    if train_alignment:
        assert set(got) == set(want[0][1])
    else:  # stop_gradient in JAX, requires_grad False here
        assert set(got) == set(want[0][1]) - aligner
    _compare(got, *[{k: w[1][k] for k in got} for w in want])

    # parameters, gradients and Adam's moments stay float32
    state.apply_gradients()
    opt = state.opt_state()
    for name, p in state.trainable().items():
        assert p.dtype == p.grad.dtype == torch.float32, name
        assert opt["mu"][name].dtype == opt["nu"][name].dtype \
            == torch.float32, name
        assert opt["mu"][name].abs().sum() > 0, name


# ---------------------------------------------------------------------------
# checkpoints and the entry points


def test_bf16_net_spec_round_trips_between_port_and_jax(tmp_path,
                                                        tiny_problem):
    """The port's bf16 network is recorded as JAX records it and rebuilt by
    JAX in bf16 (the same prediction within bf16's limits); a JAX bf16
    checkpoint rebuilds the port's bf16 network with its parameters."""
    batch, params = tiny_problem
    burst = batch["burst"]
    net = dbsr.dbsrnet_tiny(dtype="bfloat16")
    net.load_state_dict(params_from_flax(params), strict=True)
    path = ckpt.save_checkpoint(str(tmp_path / "port"), "dbsr_synthetic", 1,
                                make_optimizer().init(net))
    header, _ = ckpt.read_checkpoint(path)
    assert header["net_spec"]["kwargs"]["dtype"] == {"__dtype__": "bfloat16"}
    jnet, jparams, _ = jax_load_network(path)
    assert jnet.dtype == jnp.bfloat16
    want_bf16 = jax.jit(jnet.apply)(jparams, jnp.asarray(burst))[0]
    want_f32 = jax.jit(jdbsr.dbsrnet_tiny(flow_net="lite").apply)(
        params, jnp.asarray(burst))[0]
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(burst))[0]
    _check_bf16(got.numpy().astype(np.float64).ravel(),
                np.asarray(want_bf16, np.float64).ravel(),
                np.asarray(want_f32, np.float64).ravel())
    # float32 is recorded as the JAX package records it: null
    f32 = ckpt.network_spec(dbsr.dbsrnet_tiny(dtype="float32"))
    assert f32["kwargs"]["dtype"] is None

    jnet = jdbsr.dbsrnet_tiny(flow_net="lite", dtype=jnp.bfloat16)
    jpath = jax_save(str(tmp_path / "jax"), "dbsr_synthetic", 1,
                     {"params": jax.tree.map(jnp.asarray, params)}, net=jnet)
    port, _ = ckpt.load_network(jpath, device="cpu")
    assert compute_dtype_of(port) == BF
    for k, v in params_from_flax(params).items():
        assert torch.equal(port.state_dict()[k], v), k


@pytest.fixture
def workspace(tmp_path, monkeypatch):
    monkeypatch.setenv("DBSR_TPU_ENV", str(tmp_path / "env.json"))
    monkeypatch.setenv("DBSR_TPU_WORKSPACE_DIR", str(tmp_path / "ws"))
    monkeypatch.delenv("DBSR_TPU_ZURICHRAW2RGB_DIR", raising=False)
    return tmp_path / "ws"


@pytest.mark.parametrize("dtype,want", [(None, BF), ("bfloat16", BF),
                                        ("bf16", BF), ("float32", None),
                                        ("f32", None)])
def test_default_synthetic_trains_bf16_by_default(workspace, dtype, want):
    settings = Settings()
    for k, v in {"pool_size": 2, "steps_per_epoch": 2,
                 "pwc_checkpoint": ALIGN_LITE}.items():
        setattr(settings, k, v)
    if dtype is not None:
        settings.compute_dtype = dtype
    trainer, _ = default_synthetic.make_trainer(settings, "cpu")
    assert compute_dtype_of(trainer.net) == want
    spec = ckpt.network_spec(trainer.net)["kwargs"]["dtype"]
    assert spec == (None if want is None else {"__dtype__": "bfloat16"})


def test_default_realworld_restores_and_fine_tunes_in_bf16(tmp_path,
                                                           monkeypatch):
    """A bf16 ``default_synthetic`` checkpoint is restored in bf16, one
    fine-tuning step runs (a float32 loss, float32 parameters), and the
    fine-tuned checkpoint records bf16 again."""
    ws = tmp_path / "ws"
    root = str(tmp_path / "burstsr")
    for split, seed in (("train", 2), ("val", 3)):
        make_synthetic_burstsr.generate_dataset(
            root, bursts=1, lr=16, n_frames=4, split=split, seed=seed,
            device="cpu")
    net = dbsr.dbsrnet_tiny(dtype="bfloat16")
    ckpt.save_checkpoint(str(ws / "dbsr" / "default_synthetic"),
                         "dbsr_synthetic", 1, make_optimizer().init(net))
    monkeypatch.setenv("DBSR_TPU_ENV", str(tmp_path / "env.json"))
    monkeypatch.setenv("DBSR_TPU_WORKSPACE_DIR", str(ws))
    monkeypatch.setenv("DBSR_TPU_BURSTSR_DIR", root)
    state = run_training("dbsr", "default_realworld", device="cpu", epochs=1,
                         batch_size=1, crop_sz=8, burst_sz=3,
                         steps_per_epoch=1, print_interval=1)
    assert compute_dtype_of(state.net) == BF
    assert all(p.dtype == torch.float32 for p in state.net.parameters())
    rw = ws / "dbsr" / "default_realworld"
    header, _ = ckpt.read_checkpoint(ckpt.resolve_checkpoint(
        str(rw), "dbsr_realworld"))
    assert header["epoch"] == 1
    assert np.isfinite(header["stats"]["train"]["Loss/total"])
    assert header["net_spec"]["kwargs"]["dtype"] == {"__dtype__": "bfloat16"}
