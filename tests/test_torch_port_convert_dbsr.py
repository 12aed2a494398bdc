"""The reference-checkpoint converter (``utils/convert_dbsr.py``),
``utils/loading.py`` and the ``ConvFlow`` aligner (``flow_net='conv'``) on
the CPU against the JAX package.

The reference state dicts are synthetic: a port ``DBSRNet(flow_net='pwc')``
with seeded parameters written under the reference's names by
``reference_state_dict`` (no published checkpoint is in the repository),
at the flagship's block counts and at reduced ones, with and without the
offset extractor.

Tolerances: converted tensors exact (renaming, no arithmetic); forwards
within 2e-4 of the JAX package's (float32, sums in another order); a
train step's loss rtol 1e-5 and gradients rtol 1e-4 / atol 1e-6, as
``tests/test_torch_port_grad.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbsr_tpu.models.dbsr import dbsrnet_tiny as jax_dbsrnet_tiny
from dbsr_tpu.training import actors as jax_actors
from dbsr_tpu.training.checkpoint import load_network as jax_load_network
from dbsr_tpu.utils import loading as jax_loading
from dbsr_tpu.utils.convert_dbsr import \
    convert_dbsr_state_dict as jax_convert_dbsr_state_dict
from dbsr_tpu_torch.data.procedural import make_generator
from dbsr_tpu_torch.models.dbsr import ConvFlow, DBSRNet, dbsrnet_tiny
from dbsr_tpu_torch.models.layers import init_params
from dbsr_tpu_torch.training.actors import make_synthetic_actor
from dbsr_tpu_torch.training.checkpoint import (load_network,
                                                resolve_checkpoint,
                                                save_checkpoint)
from dbsr_tpu_torch.training.state import make_optimizer
from dbsr_tpu_torch.utils import convert_dbsr, loading
from dbsr_tpu_torch.utils.convert import params_from_flax, params_to_flax

FWD_ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this module runs (the suite runs
    in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _burst(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _seeded(net, seed):
    init_params(net, make_generator("cpu", seed))
    return net.eval()


def _j(a):
    return jnp.array(np.array(a))


# ---------------------------------------------------------------------------
# the converter

CONFIGS = {
    "flagship": dict(flow_net="pwc"),
    "reduced": dict(enc_num_res_blocks=2, dec_num_pre_res_blocks=1,
                    dec_num_post_res_blocks=2, num_weight_predictor_res=2,
                    num_offset_feat_extractor_res=2, enc_out_dim=32,
                    enc_init_dim=16, flow_net="pwc"),
    "no_offset": dict(enc_num_res_blocks=1, dec_num_pre_res_blocks=1,
                      dec_num_post_res_blocks=1, num_weight_predictor_res=1,
                      use_offset=False, enc_out_dim=16, enc_init_dim=8,
                      flow_net="pwc"),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_converter_is_bit_equal_to_the_jax_converters(config):
    """The reference dict converted by the port against the JAX package's
    converter carried over by ``params_from_flax``: the same names, the same
    bits, and the network's own parameters back."""
    net = _seeded(DBSRNet(**CONFIGS[config]), 1)
    ref = convert_dbsr.reference_state_dict(net)
    assert any(k.startswith("encoder.res_layers.") for k in ref)
    assert ("merging.offset_feat_extractor.0.0.weight" in ref) == \
        (config != "no_offset")
    got = convert_dbsr.convert_dbsr_state_dict(ref)
    want = params_from_flax(jax_convert_dbsr_state_dict(ref))
    sd = net.state_dict()
    assert set(got) == set(want) == set(sd)
    for k in sd:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]) and torch.equal(got[k], sd[k]), k
    # numpy arrays convert alike
    got_np = convert_dbsr.convert_dbsr_state_dict(
        {k: v.numpy() for k, v in ref.items()})
    assert all(torch.equal(got_np[k], got[k]) for k in got)


def test_converted_forward_matches_jax():
    """A reduced PWC-Net DBSRNet (x8) from a reference dict: the port's
    forward against the JAX package's with the JAX converter's params."""
    net = _seeded(dbsrnet_tiny(flow_net="pwc"), 2)
    ref = convert_dbsr.reference_state_dict(net)
    port = dbsrnet_tiny(flow_net="pwc")
    port.load_state_dict(convert_dbsr.convert_dbsr_state_dict(ref),
                         strict=True)
    burst = _burst((1, 3, 16, 16, 4), 3)
    want, _ = jax.jit(jax_dbsrnet_tiny(flow_net="pwc").apply)(
        {"params": jax_convert_dbsr_state_dict(ref)}, _j(burst))
    with torch.no_grad():
        got, _ = port.eval()(torch.from_numpy(burst))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)


def test_missing_tensor_raises_key_error():
    ref = convert_dbsr.reference_state_dict(
        _seeded(DBSRNet(**CONFIGS["no_offset"]), 4))
    for key, named in (("decoder.predictor.0.weight",
                        "decoder.predictor.0.weight"),
                       ("encoder.alignment_net.net.netRefiner.netMain.12.weight",
                        "net.netRefiner.netMain.12.weight")):
        with pytest.raises(KeyError, match=f"lacks {named}"):
            convert_dbsr.convert_dbsr_state_dict(
                {k: v for k, v in ref.items() if k != key})


def test_load_dbsr_torch_checkpoint(tmp_path):
    """A ``.pth.tar`` whose ``net`` entry holds the state dict (beside the
    reference's other entries), and a bare state dict."""
    net = _seeded(DBSRNet(**CONFIGS["no_offset"]), 5)
    ref = convert_dbsr.reference_state_dict(net)
    torch.save({"epoch": 3, "net": ref, "net_type": "DBSRNet"},
               tmp_path / "ckpt.pth.tar")
    torch.save(ref, tmp_path / "bare.pth")
    for path in ("ckpt.pth.tar", "bare.pth"):
        got = convert_dbsr.load_dbsr_torch_checkpoint(str(tmp_path / path))
        assert all(torch.equal(got[k], v) for k, v in
                   net.state_dict().items())


def test_reference_state_dict_refuses_another_aligner():
    with pytest.raises(ValueError, match="reference name"):
        convert_dbsr.reference_state_dict(dbsrnet_tiny())


# ---------------------------------------------------------------------------
# load_trained_network


def _save(directory, net_name, epoch, seed=6):
    net = _seeded(dbsrnet_tiny(upsample_factor=4), seed)
    return save_checkpoint(str(directory), net_name, epoch,
                           make_optimizer().init(net))


def test_load_trained_network_resolves_as_jax(tmp_path, monkeypatch):
    ws = tmp_path / "ws"
    d = ws / "dbsr" / "default_synthetic"
    _save(d, "smoke", 1)
    _save(d, "dbsr_realworld", 2, seed=7)
    _save(d, "dbsr_realworld", 3, seed=8)
    monkeypatch.setenv("DBSR_TPU_ENV", str(tmp_path / "env.json"))
    monkeypatch.setenv("DBSR_TPU_WORKSPACE_DIR", str(ws))
    burst = _burst((1, 3, 8, 8, 4), 9)
    for kw, want_path in (
            ({}, resolve_checkpoint(str(d), "dbsr_realworld")),
            ({"epoch": 2}, resolve_checkpoint(str(d), "dbsr_realworld", 2)),
            ({"net_name": "smoke"}, resolve_checkpoint(str(d), "smoke"))):
        net, header = loading.load_trained_network(
            "dbsr", "default_synthetic", device="cpu", **kw)
        jnet, jparams, jheader = jax_loading.load_trained_network(
            "dbsr", "default_synthetic", **kw)
        ref, _ = load_network(want_path, device="cpu")
        assert header == jheader
        assert header["epoch"] == int(want_path[-9:-5])
        for k, v in ref.state_dict().items():
            assert torch.equal(net.state_dict()[k], v), k
        with torch.no_grad():
            got = net(torch.from_numpy(burst))[0].numpy()
        want, _ = jnet.apply(jparams, _j(burst))
        np.testing.assert_allclose(got, np.asarray(want), atol=FWD_ATOL)
    # an explicit workspace wins over the environment's
    net, _ = loading.load_trained_network("dbsr", "default_synthetic",
                                          workspace_dir=str(ws),
                                          device="cpu")
    assert net.training is False


def test_load_trained_network_errors_are_the_jax_packages(tmp_path):
    d = tmp_path / "dbsr" / "x"
    for kw in ({}, {"net_name": "dbsr_synthetic"}):
        with pytest.raises(FileNotFoundError) as got:
            loading.load_trained_network("dbsr", "x",
                                         workspace_dir=str(tmp_path),
                                         device="cpu", **kw)
        with pytest.raises(FileNotFoundError) as want:
            jax_loading.load_trained_network("dbsr", "x",
                                             workspace_dir=str(tmp_path),
                                             **kw)
        assert str(got.value) == str(want.value)
    _save(d, "smoke", 1)
    with pytest.raises(FileNotFoundError, match="epoch 5"):
        loading.load_trained_network("dbsr", "x", epoch=5,
                                     workspace_dir=str(tmp_path),
                                     device="cpu")


def test_load_trained_network_on_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the request is valid here")
    _save(tmp_path / "dbsr" / "x", "smoke", 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loading.load_trained_network("dbsr", "x",
                                     workspace_dir=str(tmp_path))


# ---------------------------------------------------------------------------
# ConvFlow


def _conv_problem():
    rng = np.random.RandomState(14)
    batch = {"burst": rng.rand(2, 3, 16, 16, 4).astype(np.float32),
             "frame_gt": rng.rand(2, 128, 128, 3).astype(np.float32)}
    # seed 17: every output channel alive after the decoder's final ReLU
    net = _seeded(dbsrnet_tiny(flow_net="conv", train_alignment=True), 17)
    params = jax.tree.map(_j, params_to_flax(net.state_dict()))
    jnet = jax_dbsrnet_tiny(flow_net="conv", train_alignment=True)
    return jnet, {"params": params}, net.train(), batch


def test_conv_flow_has_the_jax_modules_parameters():
    jnet, params, net, batch = _conv_problem()
    shapes = jax.eval_shape(jnet.init, jax.random.key(0),
                            _j(batch["burst"]))
    want = {jax.tree_util.keystr(p): v.shape for p, v in
            jax.tree_util.tree_leaves_with_path(shapes["params"])}
    got = {jax.tree_util.keystr(p): v.shape for p, v in
           jax.tree_util.tree_leaves_with_path(params["params"])}
    assert got == want
    assert isinstance(net.encoder.alignment_net, ConvFlow)
    assert sorted(k for k in net.state_dict()
                  if "alignment_net" in k) == sorted(
        f"encoder.alignment_net.ConvBlock_{i}.Conv_0.{leaf}"
        for i in (0, 1) for leaf in ("weight", "bias"))


def test_conv_flow_forward_matches_jax():
    jnet, params, net, batch = _conv_problem()
    want, jaux = jax.jit(jnet.apply)(params, _j(batch["burst"]))
    with torch.no_grad():
        got, aux = net.eval()(torch.from_numpy(batch["burst"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)
    assert aux["offsets"].dtype == torch.float32
    np.testing.assert_allclose(aux["offsets"].numpy(),
                               np.asarray(jaux["offsets"]), atol=FWD_ATOL)


def test_conv_flow_train_step_matches_jax():
    """``train_alignment=True``: ConvFlow's two convs get their gradients
    through the flow, as in the JAX package."""
    jnet, params, net, batch = _conv_problem()
    actor = jax_actors.make_synthetic_actor(jnet, boundary_ignore=40)
    jbatch = {k: _j(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: actor(p, jbatch), has_aux=True))(params)
    loss, _ = make_synthetic_actor(net, boundary_ignore=40)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(jgrads["params"])}
    got = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
           jax.tree_util.tree_leaves_with_path(params_to_flax(
               {k: p.grad for k, p in net.named_parameters()}))}
    assert set(got) == set(want)
    aligner = [k for k in got if "alignment_net" in k]
    assert len(aligner) == 4 and all(np.any(got[k]) for k in aligner)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_conv_flow_checkpoint_loads_in_both_packages(tmp_path):
    """A port checkpoint of a ConvFlow network: ``load_network`` rebuilds it
    from its ``net_spec`` in the port and in the JAX package alike."""
    _, _, net, batch = _conv_problem()
    path = save_checkpoint(str(tmp_path), "dbsr_synthetic", 1,
                           make_optimizer().init(net))
    port, header = load_network(path, device="cpu")
    assert header["net_spec"]["kwargs"]["flow_net"] == "conv"
    jnet, jparams, _ = jax_load_network(path)
    want, _ = jax.jit(jnet.apply)(jparams, _j(batch["burst"]))
    with torch.no_grad():
        got, _ = port(torch.from_numpy(batch["burst"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)
    assert os.path.basename(path) == "dbsr_synthetic_ep0001.ckpt"
