"""The port's display path on the CPU against the JAX package's: the
forward ISP (``ops/camera.py``), ``utils/plotting.py``, the HTML viewer
and ``evaluation/visualize.py`` with its CLI.

``visualize_synburst`` runs a tiny network (``dbsrnet_tiny``, AlignLite,
x4, seeded, written by the port's checkpoint writer) on 2 bursts that the
JAX package synthesized and wrote with their ISP meta;
``visualize_burstsr`` runs the x8 tiny network on 2 bursts of the port's
BurstSR generator.

Tolerances: the ISP rtol 1e-6 (float32 colour math, the CCM summed in
another order); ``to_display``, ``tensor_grid``, ``describe`` and the
viewer's bytes exact; a PNG that ``save_tensor`` writes decodes to the
pixels of the JAX package's PIL-written one; the panes within 1 LSB on at
least 99.9% of their pixels and equal on at least 99% (a float32 rounding
can move a value across an 8-bit step, and SCA's alignment moves the
aligned pane a little more); the PSNR parsed from a panel's name within 0.01 dB (two
decimals can round the two ways).
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dbsr_tpu.data import burstsr as jax_burstsr
from dbsr_tpu.data.datasets import \
    write_synthetic_burst_val as jax_write_synthetic_burst_val
from dbsr_tpu.data.synthetic import BurstConfig as JaxBurstConfig
from dbsr_tpu.data.synthetic import rgb2rawburst as jax_rgb2rawburst
from dbsr_tpu.evaluation import html_viewer as jax_viewer
from dbsr_tpu.evaluation import visualize as jax_vis
from dbsr_tpu.evaluation.network_param import NetworkParam as JaxNetworkParam
from dbsr_tpu.ops import camera as jax_camera
from dbsr_tpu.utils import plotting as jax_plotting
from dbsr_tpu_torch import run_evaluation
from dbsr_tpu_torch.data import burstsr
from dbsr_tpu_torch.data import make_synthetic_burstsr as gen
from dbsr_tpu_torch.evaluation import burstsr as ev
from dbsr_tpu_torch.evaluation import html_viewer, synburst, visualize
from dbsr_tpu_torch.evaluation.network_param import NetworkParam
from dbsr_tpu_torch.ops import camera
from dbsr_tpu_torch.utils import plotting
from dbsr_tpu_torch.utils.png16 import read_png

ISP_RTOL = 1e-6
LSB_SHARE, EQUAL_SHARE, PSNR_NAME_DB = 0.999, 0.99, 0.01
CFG = JaxBurstConfig(burst_size=14, crop_sz=(32, 32), downsample_factor=2,
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


def _rand(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the forward ISP


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("batched", [False, True])
def test_apply_gains_matches_jax(channels, batched):
    shape = (2, 9, 7, channels) if batched else (9, 7, channels)
    im = _rand(shape, 0) * 0.8
    rng = np.random.RandomState(1)
    gains = [(rng.rand(2) + 0.8).astype(np.float32) if batched
             else float(rng.rand() + 0.8) for _ in range(3)]
    want = jax_camera.apply_gains(jnp.asarray(im), *map(jnp.asarray, gains))
    got = camera.apply_gains(torch.from_numpy(im),
                             *map(torch.as_tensor, gains))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ISP_RTOL)
    assert float(got.max()) <= 1.0 and float(got.min()) >= 0.0


def test_apply_gains_refuses_other_channel_counts():
    with pytest.raises(ValueError, match="3 or 4 channels"):
        camera.apply_gains(torch.zeros(4, 4, 2), 1.0, 1.0, 1.0)


def test_tone_curves_match_jax():
    x = np.concatenate([_rand((1000,), 2), [0.0, 1e-9, 1.0]]).astype(
        np.float32)
    for ours, theirs in ((camera.apply_smoothstep, jax_camera.apply_smoothstep),
                         (camera.gamma_compression,
                          jax_camera.gamma_compression)):
        np.testing.assert_allclose(ours(torch.from_numpy(x)).numpy(),
                                   np.asarray(theirs(jnp.asarray(x))),
                                   rtol=ISP_RTOL)


@pytest.mark.parametrize("flags", [{}, {"gamma": False},
                                   {"smoothstep": False},
                                   {"gamma": False, "smoothstep": False}])
def test_process_linear_image_rgb_matches_jax(flags):
    rng = np.random.RandomState(3)
    im = _rand((24, 20, 3), 4)
    ccm = (np.eye(3) + 0.2 * rng.randn(3, 3)).astype(np.float32)
    meta = dict(cam2rgb=ccm, rgb_gain=1.25, red_gain=1.9, blue_gain=1.6,
                **flags)
    want = jax_camera.process_linear_image_rgb(
        jnp.asarray(im), {k: jnp.asarray(v) for k, v in meta.items()})
    got = camera.process_linear_image_rgb(torch.from_numpy(im), meta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ISP_RTOL,
                               atol=1e-7)
    with pytest.raises(KeyError):
        camera.process_linear_image_rgb(torch.from_numpy(im),
                                        {"cam2rgb": ccm})


# ---------------------------------------------------------------------------
# plotting and the viewer


@pytest.mark.parametrize("shape", [(16, 12, 3), (3, 16, 12), (16, 12),
                                   (1, 16, 12, 4), (16, 12, 1), (16, 12, 5)])
@pytest.mark.parametrize("value_range", [(None, None), (0.0, 1.0)])
def test_to_display_matches_jax(shape, value_range):
    a = _rand(shape, 5) * 2 - 0.5
    want = jax_plotting.to_display(a, value_range)
    np.testing.assert_array_equal(plotting.to_display(a, value_range), want)
    np.testing.assert_array_equal(
        plotting.to_display(torch.from_numpy(a), value_range), want)


def test_to_display_refuses_a_5d_tensor():
    with pytest.raises(ValueError, match="cannot display"):
        plotting.to_display(np.zeros((2, 2, 3, 4, 5)))


def test_tensor_grid_and_describe_match_jax():
    tiles = [_rand((10, 8, 3), 6), _rand((6, 9), 7), _rand((4, 5, 5, 4), 8)[0],
             _rand((3, 7, 7), 9)]
    for cols in (1, 3, 4):
        np.testing.assert_array_equal(
            plotting.tensor_grid([torch.from_numpy(t) for t in tiles], cols),
            jax_plotting.tensor_grid(tiles, cols))
    a = _rand((2, 3, 4), 10)
    a[0, 0, :2] = (np.nan, np.inf)
    assert plotting.describe(a, "x") == jax_plotting.describe(a, "x")
    assert plotting.describe(torch.from_numpy(a), "x") == \
        jax_plotting.describe(a, "x")
    assert plotting.describe(np.full((2,), np.nan)) == \
        jax_plotting.describe(np.full((2,), np.nan))
    assert "dtype=float32" in plotting.describe(
        torch.ones(2, dtype=torch.bfloat16))


def test_save_tensor_decodes_to_the_jax_packages_pixels(tmp_path):
    """The port writes through its own PNG codec; the JAX package through
    PIL: the same pixels."""
    a = torch.from_numpy(_rand((3, 18, 14), 11))
    plotting.save_tensor(a, str(tmp_path / "port.png"), (0.0, 1.0))
    jax_plotting.save_tensor(a.numpy(), str(tmp_path / "jax.png"),
                             (0.0, 1.0))
    got = read_png(str(tmp_path / "port.png"))
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    assert got.dtype == np.uint8 and got.shape == (18, 14, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                                  want)


def test_write_viewer_writes_the_jax_packages_bytes(tmp_path):
    entries = [{"name": "0000", "info": "PSNR 31.25 dB <&>",
                "panes": {"base frame": "0000_base.png",
                          "prediction": "0000_prediction.png"}},
               {"name": "b\"1", "info": "", "panes": {"x": "x.png"}}]
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
    got = html_viewer.write_viewer(str(tmp_path / "port"), "t <1> & 'x'",
                                   entries)
    want = jax_viewer.write_viewer(str(tmp_path / "jax"), "t <1> & 'x'",
                                   entries)
    assert os.path.basename(got) == os.path.basename(want) == "index.html"
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    assert html_viewer._PAGE == jax_viewer._PAGE
    with pytest.raises(ValueError, match="no entries"):
        html_viewer.write_viewer(str(tmp_path), "t", [])


# ---------------------------------------------------------------------------
# visualize


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
    """Two bursts with the synthesis-time ISP meta (gains, CCM, tone
    flags), written by the JAX package."""
    root = str(tmp_path_factory.mktemp("synval"))
    samples = []
    for i in range(2):
        s = jax_rgb2rawburst(jax.random.key(i), jnp.asarray(
            _rand(CFG.pre_crop_sz + (3,), i)), CFG)
        samples.append({"burst": np.asarray(s["burst"]),
                        "frame_gt": np.asarray(s["frame_gt"]),
                        "meta": s["meta"]})
    jax_write_synthetic_burst_val(root, samples)
    return root


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    ws = tmp_path_factory.mktemp("ws")
    _save_port_tiny(ws / "dbsr" / "default_synthetic", 4)
    return str(ws)


def _ckpt(ws):
    return os.path.join(ws, "dbsr", "default_synthetic",
                        "dbsr_synthetic_ep0001.ckpt")


def _psnr_in_names(d, tag):
    out = {}
    for f in os.listdir(d):
        m = re.fullmatch(rf"(.+)_{tag}(-?[\d.]+)\.png", f)
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


def _compare_dirs(got_dir, want_dir, tag):
    """The same files; panes and panels within 1 LSB on >= 99.9% of their
    pixels and equal on >= 99%; the PSNRs in the panels' names within 0.01
    dB; the viewers' entries equal, their PSNRs within 0.01 dB."""
    named_got, named_want = (_psnr_in_names(d, tag)
                             for d in (got_dir, want_dir))
    assert named_got.keys() == named_want.keys() and named_got
    for k in named_got:
        assert abs(named_got[k] - named_want[k]) <= PSNR_NAME_DB + 1e-9
    strip = re.compile(rf"_{tag}-?[\d.]+\.png$")
    files = sorted(strip.sub("", f) for f in os.listdir(got_dir))
    assert files == sorted(strip.sub("", f) for f in os.listdir(want_dir))
    assert "index.html" in files
    by_stem = {strip.sub("", f): f for f in os.listdir(want_dir)}
    for f in os.listdir(got_dir):
        if not f.endswith(".png"):
            continue
        got = read_png(os.path.join(got_dir, f)).astype(np.int16)
        want = read_png(os.path.join(want_dir,
                                     by_stem[strip.sub("", f)])).astype(
            np.int16)
        assert got.shape == want.shape, f
        diff = np.abs(got - want)
        assert (diff <= 1).mean() >= LSB_SHARE, f
        assert (diff == 0).mean() >= EQUAL_SHARE, f
    got_data, want_data = (_viewer_data(d) for d in (got_dir, want_dir))
    assert [{**e, "info": None} for e in got_data] == \
        [{**e, "info": None} for e in want_data]
    for g, w in zip(got_data, want_data):
        db = [float(e["info"].split()[-2]) for e in (g, w)]
        assert abs(db[0] - db[1]) <= PSNR_NAME_DB + 1e-9
    return named_got


def _viewer_data(d):
    """The entries of a viewer page (its ``DATA`` literal)."""
    with open(os.path.join(d, "index.html")) as f:
        return json.loads(f.read().split("const DATA = ")[1].split(";\n")[0])


def test_visualize_synburst_matches_jax(val_root, ws, tmp_path):
    want_dir, got_dir = tmp_path / "jax", tmp_path / "port"
    jax_vis.visualize_synburst(
        [JaxNetworkParam(checkpoint_path=_ckpt(ws), display_name="tiny")],
        val_root, str(want_dir), max_bursts=2, boundary_ignore=BOUNDARY)
    visualize.visualize_synburst(
        [NetworkParam(checkpoint_path=_ckpt(ws), display_name="tiny")],
        val_root, str(got_dir), max_bursts=2, boundary_ignore=BOUNDARY,
        device="cpu")
    named = _compare_dirs(got_dir / "tiny", want_dir / "tiny", "psnr")
    assert len(os.listdir(got_dir / "tiny")) == 2 * 4 + 1
    # the PSNR in a name is the burst's score (unquantized prediction)
    per = {}
    synburst.compute_score(
        [NetworkParam(checkpoint_path=_ckpt(ws), display_name="tiny")],
        val_root, boundary_ignore=BOUNDARY, with_lpips=False, device="cpu",
        per_burst=per)
    for i, name in enumerate(sorted(named)):
        assert abs(named[name] - per["tiny"]["psnr"][i]) <= 0.01


def test_postprocess_shows_the_raw_image_without_isp_meta():
    im = torch.from_numpy(_rand((6, 5, 3), 12))
    assert visualize._postprocess(im, {"gains": 1.0}) is im
    meta = dict(cam2rgb=np.eye(3, dtype=np.float32), rgb_gain=1.0,
                red_gain=1.0, blue_gain=1.0, gamma=False, smoothstep=False)
    np.testing.assert_array_equal(visualize._postprocess(im, meta).numpy(),
                                  im.numpy())
    with pytest.raises(IndexError):  # a real ISP error is not hidden
        visualize._postprocess(im, dict(meta, cam2rgb=np.eye(2)))


def test_cli_visualize_synburst_writes_to_the_workspace(val_root, ws, tmp_path,
                                                        monkeypatch):
    """``run_evaluation synburst visualize dbsr_default``: the default
    output directory and the default ``max_bursts`` (10: both bursts)."""
    monkeypatch.setenv("DBSR_TPU_ENV", str(tmp_path / "env.json"))
    monkeypatch.setenv("DBSR_TPU_WORKSPACE_DIR", ws)
    monkeypatch.setenv("DBSR_TPU_SYNBURSTVAL_DIR", val_root)
    run_evaluation.main(["synburst", "visualize", "dbsr_default",
                         "--device", "cpu"])
    d = os.path.join(ws, "synburst_vis", "dbsr_default_synthetic")
    assert len(_psnr_in_names(d, "psnr")) == 2
    data = _viewer_data(d)
    assert [e["name"] for e in data] == ["0000", "0001"]
    assert list(data[0]["panes"]) == ["base frame", "prediction",
                                      "ground truth"]


def _val(pkg, root):
    return pkg.IndexedBurstSampler(
        pkg.BurstSRDataset(root, "val"), burst_size=4,
        processing=pkg.BurstSRProcessing(crop_sz=16,
                                         substract_black_level=True,
                                         random_crop=False))


@pytest.fixture(scope="module")
def gen_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gen"))
    gen.generate_dataset(root, bursts=2, lr=16, n_frames=4, split="val",
                         seed=1, device="cpu")
    return root


def test_visualize_burstsr_matches_jax(gen_root, tmp_path, monkeypatch):
    """At 16-px crops of 4 frames (both functions read the val set
    through ``get_burstsr_val_set``, here a sampler at that size); the
    aligned PSNR in each name against ``compute_score``'s per burst."""
    ckpt = _save_port_tiny(tmp_path / "ckpt", 8)
    for pkg in (jax_burstsr, burstsr):
        monkeypatch.setattr(pkg, "get_burstsr_val_set",
                            lambda root, pkg=pkg: _val(pkg, root))
    want_dir, got_dir = tmp_path / "jax", tmp_path / "port"
    jax_vis.visualize_burstsr(
        [JaxNetworkParam(checkpoint_path=ckpt, display_name="tiny")],
        gen_root, str(want_dir), max_bursts=2)
    nets = [NetworkParam(checkpoint_path=ckpt, display_name="tiny")]
    visualize.visualize_burstsr(nets, gen_root, str(got_dir), max_bursts=2,
                                device="cpu")
    named = _compare_dirs(got_dir / "tiny", want_dir / "tiny", "apsnr")
    per = {}
    ev.compute_score(nets, "", dataset=_val(burstsr, gen_root),
                     with_lpips=False, device="cpu", per_burst=per)
    for i, name in enumerate(sorted(named)):
        assert abs(named[name] - per["tiny"]["psnr"][i]) <= 0.01


def test_cli_visualize_burstsr_defaults(tmp_path, monkeypatch):
    """``run_evaluation burstsr visualize``: the val protocol's set (80-px
    crops) of a one-burst tree, ``<workspace>/burstsr_vis``."""
    root = str(tmp_path / "tree")
    gen.generate_dataset(root, bursts=1, lr=80, n_frames=3, split="val",
                         seed=2, device="cpu")
    ws = tmp_path / "ws"
    _save_port_tiny(ws / "dbsr" / "default_synthetic", 8)
    monkeypatch.setenv("DBSR_TPU_ENV", str(tmp_path / "env.json"))
    monkeypatch.setenv("DBSR_TPU_WORKSPACE_DIR", str(ws))
    monkeypatch.setenv("DBSR_TPU_BURSTSR_DIR", root)
    run_evaluation.main(["burstsr", "visualize", "dbsr_default",
                         "--device", "cpu"])
    d = ws / "burstsr_vis" / "dbsr_default_synthetic"
    assert len(_psnr_in_names(str(d), "apsnr")) == 1
    assert {f for f in os.listdir(d) if "apsnr" not in f} == {
        "0008_0001_base.png", "0008_0001_aligned.png", "0008_0001_DSLR.png",
        "index.html"}
