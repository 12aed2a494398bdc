"""The port's serving forward (``dbsr_tpu_torch.models``, ``serving``)
against the JAX package on CPU, float32, same inputs made from a seed with
numpy and the same parameters carried over with ``params_from_flax``.

On the CPU the JAX package runs its plain XLA formulations (gather warp,
shifted-window correlation, softmax-sum merge) and the port its plain
PyTorch versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbsr_tpu.models.align_lite import AlignLiteNet as JaxAlignLiteNet
from dbsr_tpu.models.dbsr import dbsrnet_tiny as jax_dbsrnet_tiny
from dbsr_tpu.training.checkpoint import load_checkpoint as jax_load_checkpoint
from dbsr_tpu.training.checkpoint import load_network as jax_load_network
from dbsr_tpu_torch.models.align_lite import AlignLiteNet
from dbsr_tpu_torch.models.dbsr import dbsrnet_tiny
from dbsr_tpu_torch.serving import load_predictor
from dbsr_tpu_torch.training.checkpoint import load_network
from dbsr_tpu_torch.utils.convert import params_from_flax

FLAGSHIP = "dbsr_tpu/artifacts/campaigns/dbsr_campaign_r5_best_params.ckpt"
ALIGN_LITE = "dbsr_tpu/artifacts/align_lite_params.ckpt"


def _burst(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _random_params(shapes, seed):
    """Flax parameter tree of ``shapes`` (from ``jax.eval_shape`` of the
    JAX init) filled with torch-default-like U[-1/sqrt(fan_in), +] draws."""
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


def _port(net, params):
    net.load_state_dict(params_from_flax(params), strict=True)
    return net.eval()


def test_dbsrnet_tiny_matches_jax():
    x = _burst((2, 3, 16, 16, 4), 0)
    jnet = jax_dbsrnet_tiny(flow_net="lite")
    shapes = jax.eval_shape(jnet.init, jax.random.key(0), jnp.asarray(x))
    params = _random_params(shapes, 1)
    want, waux = jax.jit(jnet.apply)(params, jnp.asarray(x))
    net = _port(dbsrnet_tiny(), params)
    with torch.no_grad():
        got, aux = net(torch.from_numpy(x), return_fusion_weights=True)
    assert got.shape == (2, 128, 128, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(aux["offsets"].numpy(),
                               np.asarray(waux["offsets"]), atol=1e-5)
    np.testing.assert_allclose(aux["fusion_weights"].numpy(),
                               np.asarray(waux["fusion_weights"]), atol=1e-5)


def test_flagship_banked_params_match_jax():
    """Full width, epoch-60 params: the port with its decoder pinned at
    fine resolution against the JAX package's fused s2d decoder (the two
    forms compute one function; ``test_torch_port_s2d.py`` holds the port's
    s2d form, which the checkpoint's header selects). Tolerance 2e-4 on
    outputs of order 1 (observed ~4e-5: 512-channel sums in another
    order)."""
    x = _burst((1, 3, 16, 16, 4), 2)
    jnet, jparams, _ = jax_load_network(FLAGSHIP, dtype=None,
                                        fused_s2d_decoder=True)
    want, waux = jax.jit(jnet.apply)(jparams, jnp.asarray(x))
    net, header = load_network(FLAGSHIP, device="cpu", dtype=None,
                               fused_s2d_decoder=False)
    assert not net.decoder.s2d
    assert header["epoch"] == 60
    with torch.no_grad():
        got, aux = net(torch.from_numpy(x))
    diff = np.abs(got.numpy() - np.asarray(want))
    assert diff.max() <= 2e-4, (diff.max(), int((diff > 2e-4).sum()))
    np.testing.assert_allclose(aux["offsets"].numpy(),
                               np.asarray(waux["offsets"]), atol=1e-5)


def test_align_lite_banked_params_match_jax():
    """The pretrained aligner alone, with the burst's target dedupe."""
    _, raw = jax_load_checkpoint(ALIGN_LITE)
    params = raw["params"]["params"]["alignment_net"]
    rgb = _burst((2, 3, 16, 16, 3), 3)
    src = rgb[:, 1:].reshape(4, 16, 16, 3)
    apply = jax.jit(lambda p, s, t: JaxAlignLiteNet().apply(
        {"params": p}, s, t, target_repeat=2))
    want = apply(params, jnp.asarray(src), jnp.asarray(rgb[:, 0]))
    net = _port(AlignLiteNet(), params)
    with torch.no_grad():
        got = net(torch.from_numpy(src), torch.from_numpy(rgb[:, 0]),
                  target_repeat=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_predictor_pads_partial_batches_and_clips():
    pred = load_predictor(FLAGSHIP, batch_size=2, burst_size=3,
                          burst_hw=(16, 16), device="cpu")
    bursts = _burst((2, 3, 16, 16, 4), 4)
    full = pred(bursts)
    assert full.shape == (2, 128, 128, 3) and full.dtype == np.float32
    assert full.min() >= 0.0 and full.max() <= 1.0
    np.testing.assert_allclose(pred(bursts[:1]), full[:1], atol=1e-6)
    np.testing.assert_allclose(pred(bursts[1]), full[1:], atol=1e-6)
    with pytest.raises(ValueError, match="batch 3"):
        pred(np.zeros((3, 3, 16, 16, 4), np.float32))


def test_predictor_forward_turns_tf32_off_and_restores():
    pred = load_predictor(FLAGSHIP, batch_size=1, burst_size=2,
                          burst_hw=(8, 8), device="cpu")
    seen = []
    pred.net.register_forward_pre_hook(lambda *_: seen.append(
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32)))
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        pred(_burst((1, 2, 8, 8, 4), 5))
        assert seen == [(False, False)]
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def test_load_predictor_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the request is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_predictor(FLAGSHIP, device="cuda")


@pytest.mark.parametrize("override", [{"dtype": "bfloat16"},
                                      {"flow_net": "pwc"},
                                      {"softmax": False}])
def test_unported_options_raise(override):
    with pytest.raises(NotImplementedError, match=next(iter(override))):
        load_network(FLAGSHIP, device="cpu", **{"dtype": None, **override})
