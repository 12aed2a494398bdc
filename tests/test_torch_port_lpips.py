"""The port's LPIPS (``models/lpips.py``) and LPIPS in scoring, on the CPU
against the JAX package's.

The weights are seeded random ones in the ``.npz`` layout, as
``tests/test_lpips.py`` makes them (no published weights are in the
repository). Scoring runs a tiny network (``dbsrnet_tiny``, AlignLite,
seeded, written by the port's checkpoint writer, which the JAX package
reads) on a 2-burst SyntheticBurstVal tree written by the JAX package and
on a 2-burst BurstSR tree written by the port's generator.

Tolerances: LPIPS rtol 1e-4 / atol 1e-7 (float32 convs summed in another
order); the ``.npz`` arrays exact; scores within 5e-3 dB and 5e-5 SSIM,
as ``tests/test_torch_port_eval.py``.
"""

import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbsr_tpu.data import burstsr as jax_burstsr
from dbsr_tpu.data.datasets import \
    write_synthetic_burst_val as jax_write_synthetic_burst_val
from dbsr_tpu.data.synthetic import BurstConfig as JaxBurstConfig
from dbsr_tpu.data.synthetic import rgb2rawburst as jax_rgb2rawburst
from dbsr_tpu.evaluation import burstsr as jax_burstsr_eval
from dbsr_tpu.evaluation import synburst as jax_synburst
from dbsr_tpu.evaluation.network_param import NetworkParam as JaxNetworkParam
from dbsr_tpu.models import lpips as J
from dbsr_tpu_torch import run_evaluation
from dbsr_tpu_torch.data import burstsr
from dbsr_tpu_torch.data import make_synthetic_burstsr as gen
from dbsr_tpu_torch.evaluation import burstsr as ev
from dbsr_tpu_torch.evaluation import synburst
from dbsr_tpu_torch.evaluation.network_param import NetworkParam
from dbsr_tpu_torch.models import lpips as L

RTOL, ATOL = 1e-4, 1e-7
PSNR_DB, SSIM_ABS = 5e-3, 5e-5
# 112^2 ground truths: AlexNet's second max-pool needs 31 px after the
# crop, and the CLI crops the protocol's 40 px
CFG = JaxBurstConfig(burst_size=14, crop_sz=(112, 112), downsample_factor=2,
                     border_crop=4, max_translation=3.0, max_rotation=0.5)
BOUNDARY = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this module runs (the suite runs
    in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _synthetic_weights():
    """Seeded random weights in the ``.npz`` layout (``tests/
    test_lpips.py``'s recipe)."""
    rng = np.random.RandomState(0)
    w = {}
    in_ch = 3
    for i, (out_ch, k, _, _) in enumerate(J._ALEX_CONVS):
        w[f"conv{i}_w"] = (0.1 * rng.randn(k, k, in_ch, out_ch)
                           ).astype(np.float32)
        w[f"conv{i}_b"] = (0.01 * rng.randn(out_ch)).astype(np.float32)
        in_ch = out_ch
    for i, (out_ch, _, _, _) in enumerate(J._ALEX_CONVS):
        w[f"lin{i}_w"] = np.abs(rng.randn(1, 1, out_ch, 1)).astype(np.float32)
    return w


@pytest.fixture(scope="module")
def weights():
    return _synthetic_weights()


@pytest.fixture(scope="module")
def npz(tmp_path_factory, weights):
    path = str(tmp_path_factory.mktemp("lpips") / "lpips_alex.npz")
    np.savez(path, **weights)
    return path


def _img(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _jax(weights, pred, gt, b=None):
    return float(J.lpips_distance(jnp.asarray(pred), jnp.asarray(gt),
                                  {k: jnp.asarray(v) for k, v in
                                   weights.items()}, b))


def test_constants_are_the_jax_packages():
    assert L._ALEX_CONVS == J._ALEX_CONVS
    np.testing.assert_array_equal(np.float32(L._SHIFT), J._SHIFT)
    np.testing.assert_array_equal(np.float32(L._SCALE), J._SCALE)


@pytest.mark.parametrize("hw", [64, 47])
def test_feature_taps_match_jax(weights, hw):
    """The five taps' shapes and values; 47^2 is odd at every max-pool
    (floor mode, no padding: JAX's VALID ``reduce_window``)."""
    x = _img((2, hw, hw, 3), 0) * 2 - 1
    want = J._alex_features(jnp.asarray(x), {k: jnp.asarray(v)
                                             for k, v in weights.items()})
    got = L._alex_features(torch.from_numpy(x), L.torch_weights(weights))
    assert [tuple(t.permute(0, 2, 3, 1).shape) for t in got] == \
        [t.shape for t in want]
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   rtol=RTOL, atol=RTOL * np.abs(w).max())


@pytest.mark.parametrize("hw,boundary", [(64, None), (64, 4), (47, None),
                                         (47, 3)])
def test_lpips_distance_matches_jax(weights, hw, boundary):
    pred, gt = _img((2, hw, hw, 3), 1), _img((2, hw, hw, 3), 2)
    got = float(L.lpips_distance(torch.from_numpy(pred), torch.from_numpy(gt),
                                 weights, boundary))
    np.testing.assert_allclose(got, _jax(weights, pred, gt, boundary),
                               rtol=RTOL, atol=ATOL)


def test_identical_inputs_give_zero_and_the_distance_is_symmetric(weights):
    fn = L.lpips_from_weights(weights)
    a, b = torch.from_numpy(_img((40, 40, 3), 3)), \
        torch.from_numpy(_img((40, 40, 3), 4))
    assert float(fn(a, a)) == 0.0
    ab, ba = float(fn(a, b)), float(fn(b, a))
    assert ab > 0 and abs(ab - ba) <= RTOL * ab
    # unbatched [H, W, 3] is a batch of one; a batch averages its samples
    np.testing.assert_allclose(ab, _jax(weights, a[None].numpy(),
                                        b[None].numpy()), rtol=RTOL)
    pair = fn(torch.stack([a, b]), torch.stack([b, b]))
    np.testing.assert_allclose(float(pair), ab / 2, rtol=RTOL)


def test_per_sample_form_matches_jax_burst_by_burst(weights):
    """``reduce=False``: one pass over the batch, each sample's LPIPS, as
    the JAX package's metric gives it for that sample alone."""
    fn = L.lpips_from_weights(weights)
    pred, gt = _img((3, 47, 47, 3), 8), _img((3, 47, 47, 3), 9)
    got = fn(torch.from_numpy(pred), torch.from_numpy(gt), 3, reduce=False)
    assert got.shape == (3,)
    want = [_jax(weights, pred[i:i + 1], gt[i:i + 1], 3) for i in range(3)]
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        float(fn(torch.from_numpy(pred), torch.from_numpy(gt), 3)),
        np.mean(want), rtol=RTOL)


def test_boundary_ignore_crops_before_the_features(weights):
    """A difference inside the ignored border does not count."""
    fn = L.lpips_from_weights(weights)
    a = _img((1, 48, 48, 3), 5)
    b = a.copy()
    b[:, :4] = 1.0 - b[:, :4]
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    assert float(fn(a, b, 4)) == 0.0 and float(fn(a, b)) > 0.0


def test_load_lpips_from_npz_and_env(npz, weights, tmp_path, monkeypatch):
    pred, gt = _img((1, 40, 40, 3), 6), _img((1, 40, 40, 3), 7)
    want = _jax(weights, pred, gt)
    p, g = torch.from_numpy(pred), torch.from_numpy(gt)
    np.testing.assert_allclose(float(L.load_lpips(npz)(p, g)), want,
                               rtol=RTOL)
    monkeypatch.setenv("DBSR_TPU_ENV", str(tmp_path / "env.json"))
    monkeypatch.delenv("DBSR_TPU_LPIPS_WEIGHTS", raising=False)
    monkeypatch.delenv("DBSR_TPU_PRETRAINED_NETS_DIR", raising=False)
    assert L.default_weights_path() is None
    with pytest.raises(FileNotFoundError, match="DBSR_TPU_LPIPS_WEIGHTS"):
        L.load_lpips()
    with pytest.raises(FileNotFoundError):
        L.load_lpips(str(tmp_path / "missing.npz"))
    monkeypatch.setenv("DBSR_TPU_LPIPS_WEIGHTS", npz)
    assert L.default_weights_path() == npz
    np.testing.assert_allclose(float(L.load_lpips()(p, g)), want, rtol=RTOL)
    # the pretrained nets' directory, as the JAX package looks there
    monkeypatch.delenv("DBSR_TPU_LPIPS_WEIGHTS")
    monkeypatch.setenv("DBSR_TPU_PRETRAINED_NETS_DIR", os.path.dirname(npz))
    assert L.default_weights_path() == npz == J.default_weights_path()


def test_convert_from_torch_writes_the_jax_packages_arrays(tmp_path,
                                                           monkeypatch):
    """A stub ``lpips`` package (AlexNet slices and ``lin`` layers of
    seeded random weights): the two converters write the same arrays."""
    torch.manual_seed(0)
    nn = torch.nn
    convs = [nn.Conv2d(i, o, k, s, p) for (o, k, s, p), i in
             zip(J._ALEX_CONVS, (3, 64, 192, 384, 256))]
    net = types.SimpleNamespace(
        slice1=nn.Sequential(convs[0], nn.ReLU()),
        slice2=nn.Sequential(nn.MaxPool2d(3, 2), convs[1], nn.ReLU()),
        slice3=nn.Sequential(nn.MaxPool2d(3, 2), convs[2], nn.ReLU()),
        slice4=nn.Sequential(convs[3], nn.ReLU()),
        slice5=nn.Sequential(convs[4], nn.ReLU()))
    lins = [types.SimpleNamespace(model=nn.Sequential(
        nn.Dropout(), nn.Conv2d(o, 1, 1, bias=False)))
        for o, _, _, _ in J._ALEX_CONVS]
    model = types.SimpleNamespace(net=net, lins=lins)
    monkeypatch.setitem(sys.modules, "lpips", types.SimpleNamespace(
        LPIPS=lambda net: model))
    L.convert_from_torch(str(tmp_path / "port.npz"))
    J.convert_from_torch(str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as got, \
            np.load(tmp_path / "jax.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        assert len(got.files) == 15
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# LPIPS in scoring


def _save_port_tiny(directory, upsample_factor, seed=4):
    from dbsr_tpu_torch.data.procedural import make_generator
    from dbsr_tpu_torch.models.dbsr import dbsrnet_tiny
    from dbsr_tpu_torch.models.layers import init_params
    from dbsr_tpu_torch.training.checkpoint import save_checkpoint
    from dbsr_tpu_torch.training.state import make_optimizer

    net = dbsrnet_tiny(upsample_factor=upsample_factor)
    init_params(net, make_generator("cpu", seed))
    return save_checkpoint(str(directory), "dbsr_synthetic", 1,
                           make_optimizer().init(net))


@pytest.fixture(scope="module")
def val_root(tmp_path_factory):
    """Two bursts written by the JAX package at the small configuration of
    ``tests/test_torch_port_eval.py``, at 112^2 crops."""
    root = str(tmp_path_factory.mktemp("synval"))
    samples = []
    for i in range(2):
        img = jnp.asarray(_img(CFG.pre_crop_sz + (3,), i))
        s = jax_rgb2rawburst(jax.random.key(i), img, CFG)
        samples.append({"burst": np.asarray(s["burst"]),
                        "frame_gt": np.asarray(s["frame_gt"]),
                        "meta": {"index": i}})
    jax_write_synthetic_burst_val(root, samples)
    return root


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """A workspace with the tiny x4 network as ``dbsr/default_synthetic``
    (the ``dbsr_default`` experiment's)."""
    ws = tmp_path_factory.mktemp("ws")
    _save_port_tiny(ws / "dbsr" / "default_synthetic", 4)
    return str(ws)


def _ckpt(ws):
    return os.path.join(ws, "dbsr", "default_synthetic",
                        "dbsr_synthetic_ep0001.ckpt")


def test_synburst_scores_with_lpips_match_jax(val_root, ws, npz, weights,
                                              capsys):
    """Scoring with LPIPS against the JAX package's: the means, LPIPS per
    burst against JAX's metric on JAX's quantized prediction, and the
    port's PSNR / SSIM per burst equal to its scoring without LPIPS."""
    from dbsr_tpu.training.checkpoint import load_network as jax_load

    kw = dict(boundary_ignore=BOUNDARY, lpips_weights=npz)
    want = jax_synburst.compute_score(
        [JaxNetworkParam(checkpoint_path=_ckpt(ws), display_name="tiny")],
        val_root, **kw)
    per, per_plain, timing = {}, {}, {}
    nets = [NetworkParam(checkpoint_path=_ckpt(ws), display_name="tiny")]
    got = synburst.compute_score(nets, val_root, device="cpu",
                                 per_burst=per, timing=timing, **kw)
    assert list(got) == list(want) == ["psnr", "ssim", "lpips"]
    assert abs(got["psnr"]["tiny"] - want["psnr"]["tiny"]) <= PSNR_DB
    assert abs(got["ssim"]["tiny"] - want["ssim"]["tiny"]) <= SSIM_ABS
    np.testing.assert_allclose(got["lpips"]["tiny"], want["lpips"]["tiny"],
                               rtol=RTOL)
    assert all(timing["tiny"][k] is None for k in  # off the card
               ("device_ms", "forward_ms", "metrics_ms", "lpips_ms"))
    plain = synburst.compute_score(nets, val_root, device="cpu",
                                   boundary_ignore=BOUNDARY, with_lpips=False,
                                   per_burst=per_plain)
    assert list(plain) == ["psnr", "ssim"]
    for m in ("psnr", "ssim"):
        np.testing.assert_array_equal(per["tiny"][m], per_plain["tiny"][m])

    net, params, _ = jax_load(_ckpt(ws))
    lp = J.load_lpips(npz)
    ds = jax_synburst.SyntheticBurstVal(val_root)
    for i in range(2):
        burst, gt, _ = ds[i]
        pred = jax_synburst.quantize(jnp.clip(
            net.apply(params, jnp.asarray(burst)[None])[0][0], 0.0, 1.0))
        np.testing.assert_allclose(
            per["tiny"]["lpips"][i],
            float(lp(pred, jnp.asarray(gt), BOUNDARY)), rtol=RTOL)
    assert "LPIPS unavailable" not in capsys.readouterr().out


def test_scoring_without_weights_prints_the_jax_message(val_root, ws,
                                                        tmp_path, monkeypatch,
                                                        capsys):
    monkeypatch.setenv("DBSR_TPU_ENV", str(tmp_path / "env.json"))
    monkeypatch.delenv("DBSR_TPU_LPIPS_WEIGHTS", raising=False)
    monkeypatch.delenv("DBSR_TPU_PRETRAINED_NETS_DIR", raising=False)
    got = synburst.compute_score(
        [NetworkParam(checkpoint_path=_ckpt(ws), display_name="tiny")],
        val_root, boundary_ignore=BOUNDARY, device="cpu")
    out = capsys.readouterr().out
    jax_synburst.compute_score(
        [JaxNetworkParam(checkpoint_path=_ckpt(ws), display_name="tiny")],
        val_root, boundary_ignore=BOUNDARY)
    line = [x for x in out.splitlines() if x.startswith("LPIPS")]
    assert line == [x for x in capsys.readouterr().out.splitlines()
                    if x.startswith("LPIPS")]
    assert line[0].endswith("; skipping") and list(got) == ["psnr", "ssim"]


def test_cli_lpips_weights_gives_the_api_numbers(val_root, ws, npz,
                                                 tmp_path, monkeypatch):
    monkeypatch.setenv("DBSR_TPU_ENV", str(tmp_path / "env.json"))
    monkeypatch.setenv("DBSR_TPU_WORKSPACE_DIR", ws)
    out = tmp_path / "scores.json"
    run_evaluation.main(["synburst", "compute_score", "dbsr_default",
                         "--dataset_root", val_root, "--lpips_weights", npz,
                         "--json", str(out), "--device", "cpu"])
    with open(out) as f:
        cli = json.load(f)
    api = synburst.compute_score(
        [NetworkParam(module="dbsr", parameter="default_synthetic")],
        val_root, workspace_dir=ws, lpips_weights=npz, device="cpu")
    assert cli == api and set(cli) == {"psnr", "ssim", "lpips"}


@pytest.fixture(scope="module")
def gen_root(tmp_path_factory):
    """The port's generator: two val bursts of 4 frames of 16^2 (ground
    truth 128^2)."""
    root = str(tmp_path_factory.mktemp("gen"))
    gen.generate_dataset(root, bursts=2, lr=16, n_frames=4, split="val",
                         seed=1, device="cpu")
    return root


def _val(pkg, root):
    return pkg.IndexedBurstSampler(
        pkg.BurstSRDataset(root, "val"), burst_size=4,
        processing=pkg.BurstSRProcessing(crop_sz=16,
                                         substract_black_level=True,
                                         random_crop=False))


def test_burstsr_scores_with_lpips_match_jax(gen_root, tmp_path, npz):
    """LPIPS of the SCA-aligned prediction, as the JAX package takes it;
    PSNR / SSIM unchanged by it."""
    ckpt = _save_port_tiny(tmp_path, 8)
    kw = dict(boundary_ignore=16, sr_factor=4, lpips_weights=npz)
    want = jax_burstsr_eval.compute_score(
        [JaxNetworkParam(checkpoint_path=ckpt, display_name="tiny")], "",
        dataset=_val(jax_burstsr, gen_root), **kw)
    nets = [NetworkParam(checkpoint_path=ckpt, display_name="tiny")]
    per, timing = {}, {}
    got = ev.compute_score(nets, "", dataset=_val(burstsr, gen_root),
                           device="cpu", per_burst=per, timing=timing, **kw)
    assert list(got) == list(want) == ["psnr", "ssim", "lpips"]
    assert abs(got["psnr"]["tiny"] - want["psnr"]["tiny"]) <= PSNR_DB
    assert abs(got["ssim"]["tiny"] - want["ssim"]["tiny"]) <= SSIM_ABS
    np.testing.assert_allclose(got["lpips"]["tiny"], want["lpips"]["tiny"],
                               rtol=RTOL)
    assert per["tiny"]["lpips"].shape == (2,)
    assert timing["tiny"]["lpips_ms"] is None  # off the card
    plain = ev.compute_score(nets, "", dataset=_val(burstsr, gen_root),
                             device="cpu", with_lpips=False,
                             **{k: v for k, v in kw.items()
                                if k != "lpips_weights"})
    for m in ("psnr", "ssim"):
        assert plain[m]["tiny"] == got[m]["tiny"]
