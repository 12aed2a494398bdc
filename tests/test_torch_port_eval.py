"""The port's SyntheticBurstVal protocol on the CPU against the JAX
package's: the PNG codec, the val-set reader and writer in both
directions, scoring end to end, the protocol's invariants, and the
``run_evaluation`` and generator entry points.

The val set is written by the JAX package: 3 bursts of 14 frames at the
small configuration of ``tests/test_eval.py`` (32^2 crops, x2, border 4),
scored with ``boundary_ignore=4``. The network is the JAX package's
``dbsrnet_tiny(flow_net="lite", upsample_factor=4)`` with seeded float32
parameters, saved by its ``save_checkpoint``.

Tolerances: PNG bytes, val-set arrays, ``quantize`` and the report are
exact. Scores: PSNR within 5e-3 dB, SSIM and MS-SSIM within 5e-5, per
burst and in the mean. The two packages' predictions differ by float32
rounding (3.0e-8 observed; no quantized value differed), and a prediction
that close to a multiple of 2^-14 can fall on the two sides of it, a whole
quantization step apart. Observed per burst: PSNR 2.9e-6 dB, SSIM 6.6e-7,
MS-SSIM 1.9e-6.
"""

import importlib.util
import json
import os
import pickle
import shutil
import struct
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dbsr_tpu.data import pipeline as jax_pipeline
from dbsr_tpu.data.datasets import SyntheticBurstVal as JaxSyntheticBurstVal
from dbsr_tpu.data.datasets import \
    write_synthetic_burst_val as jax_write_synthetic_burst_val
from dbsr_tpu.data.synthetic import BurstConfig as JaxBurstConfig
from dbsr_tpu.data.synthetic import rgb2rawburst as jax_rgb2rawburst
from dbsr_tpu.evaluation import synburst as jax_synburst
from dbsr_tpu.evaluation.display import \
    generate_formatted_report as jax_report
from dbsr_tpu.evaluation.network_param import NetworkParam as JaxNetworkParam
from dbsr_tpu.models.dbsr import dbsrnet_tiny as jax_dbsrnet_tiny
from dbsr_tpu.training.checkpoint import load_network as jax_load_network
from dbsr_tpu.training.checkpoint import save_checkpoint as jax_save_ckpt
from dbsr_tpu.training.state import TrainState
from dbsr_tpu.utils import png16 as jax_png16
from dbsr_tpu_torch import generate_synthetic_burst_val as gen
from dbsr_tpu_torch import run_evaluation
from dbsr_tpu_torch.data import pipeline
from dbsr_tpu_torch.data.datasets import (SyntheticBurstVal,
                                          write_synthetic_burst_val)
from dbsr_tpu_torch.evaluation import synburst
from dbsr_tpu_torch.evaluation.display import generate_formatted_report
from dbsr_tpu_torch.evaluation.network_param import NetworkParam
from dbsr_tpu_torch.utils import png16

REPO = Path(__file__).resolve().parents[1]
CFG = JaxBurstConfig(burst_size=14, crop_sz=(32, 32), downsample_factor=2,
                     border_crop=4, max_translation=3.0, max_rotation=0.5)
BOUNDARY = 4
PSNR_DB, SSIM_ABS = 5e-3, 5e-5
N_BURSTS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this module runs (the suite runs
    in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _samples():
    out = []
    for i in range(N_BURSTS):
        img = jnp.asarray(np.random.RandomState(i).rand(
            *CFG.pre_crop_sz, 3).astype(np.float32))
        s = jax_rgb2rawburst(jax.random.key(i), img, CFG)
        out.append({"burst": np.asarray(s["burst"]),
                    "frame_gt": np.asarray(s["frame_gt"]),
                    "meta": {"gains": 1.0, "index": i,
                             "rgb2cam": np.asarray(s["meta"]["rgb2cam"])}})
    return out


@pytest.fixture(scope="module")
def samples():
    return _samples()


@pytest.fixture(scope="module")
def val_root(tmp_path_factory, samples):
    root = str(tmp_path_factory.mktemp("synval"))
    jax_write_synthetic_burst_val(root, samples)
    return root


def _save_tiny(directory, net_name, epoch, seed):
    net = jax_dbsrnet_tiny(flow_net="lite", upsample_factor=4)
    burst = jnp.zeros((1, CFG.burst_size) + CFG.burst_hw + (4,))
    params = net.init(jax.random.key(seed), burst)
    state = TrainState.create(params, optax.adam(1e-4))
    return jax_save_ckpt(str(directory), net_name, epoch, state, net=net)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A workspace with two epochs of a ``dbsr/default_synthetic`` run."""
    ws = tmp_path_factory.mktemp("ws")
    d = ws / "dbsr" / "default_synthetic"
    for e, seed in ((1, 11), (2, 22)):
        _save_tiny(d, "dbsr_synthetic", e, seed)
    return str(ws)


@pytest.fixture(scope="module")
def tiny_ckpt(workspace):
    return os.path.join(workspace, "dbsr", "default_synthetic",
                        "dbsr_synthetic_ep0001.ckpt")


def _nets(ckpt, **kw):
    return [NetworkParam(checkpoint_path=ckpt, display_name="tiny", **kw)]


def _score(root, nets, **kw):
    kw = {"boundary_ignore": BOUNDARY, "with_lpips": False,
          "device": "cpu", **kw}
    return synburst.compute_score(nets, root, **kw)


# ---------------------------------------------------------------------------
# PNG codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_png_bytes_equal_jax_writer(tmp_path, dtype, channels):
    rng = np.random.default_rng(channels)
    arr = rng.integers(0, np.iinfo(dtype).max + 1, size=(7, 9, channels),
                       dtype=dtype)
    if channels == 1:
        arr = arr[..., 0]  # [H, W] is written as one channel
    png16.write_png(str(tmp_path / "port.png"), arr)
    jax_png16.write_png(str(tmp_path / "jax.png"), arr)
    assert (tmp_path / "port.png").read_bytes() == \
        (tmp_path / "jax.png").read_bytes()
    got = png16.read_png(str(tmp_path / "jax.png"))
    want = jax_png16.read_png(str(tmp_path / "jax.png"))
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.reshape(arr.shape), arr)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _filter_row(f, line, prev, bpp):
    """PNG encoder side of scanline filter ``f`` on one row of bytes."""
    out = []
    for x, v in enumerate(line):
        a = line[x - bpp] if x >= bpp else 0
        b = prev[x]
        c = prev[x - bpp] if x >= bpp else 0
        pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][f]
        out.append((v - pred) & 0xFF)
    return out


def _write_filtered_png(path, arr, filters):
    """A PNG whose row ``y`` uses filter ``filters[y % len(filters)]``."""
    H, W, C = arr.shape
    depth = 8 * arr.dtype.itemsize
    raw = arr.astype(">u2") if depth == 16 else arr
    rows = np.frombuffer(raw.tobytes(), np.uint8).reshape(H, -1)
    bpp = C * depth // 8
    body, prev = b"", [0] * rows.shape[1]
    for y in range(H):
        f = filters[y % len(filters)]
        line = [int(v) for v in rows[y]]
        body += bytes([f] + _filter_row(f, line, prev, bpp))
        prev = line
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[C]

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype,
                                            0, 0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(body)))
        fh.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
@pytest.mark.parametrize("dtype,channels", [(np.uint8, 3), (np.uint16, 4),
                                            (np.uint16, 1)])
def test_png_reads_every_filter_like_jax(tmp_path, filters, dtype, channels):
    rng = np.random.default_rng(len(filters) * 10 + channels)
    arr = rng.integers(0, np.iinfo(dtype).max + 1, size=(6, 5, channels),
                       dtype=dtype)
    path = str(tmp_path / "f.png")
    _write_filtered_png(path, arr, filters)
    got, want = png16.read_png(path), jax_png16.read_png(path)
    np.testing.assert_array_equal(want, arr)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The val set, read and written across packages
# ---------------------------------------------------------------------------

def _assert_same_item(got, want):
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[2].keys() == want[2].keys()
    for k in want[2]:
        np.testing.assert_array_equal(got[2][k], want[2][k])


@pytest.mark.parametrize("marker", [True, False])
def test_port_reads_jax_written_set(val_root, tmp_path, marker):
    """Bit-identical bursts, GTs and meta to the JAX reader's, with the
    ``format.json`` marker (RGB order) and without it (OpenCV order:
    first and third channels swapped by both readers)."""
    root = val_root
    if not marker:
        root = str(tmp_path / "cv2")
        shutil.copytree(val_root, root)
        os.remove(os.path.join(root, "format.json"))
    ours, theirs = SyntheticBurstVal(root), JaxSyntheticBurstVal(root)
    assert len(ours) == len(theirs) == N_BURSTS
    assert ours.cv2_channel_order == theirs.cv2_channel_order == (not marker)
    for i in range(N_BURSTS):
        got, want = ours[i], theirs[i]
        assert got[0].shape == (14, 8, 8, 4) and got[1].shape == (32, 32, 3)
        assert got[2]["burst_name"] == f"{i:04d}"
        _assert_same_item(got, want)


def test_jax_reads_port_written_set(val_root, samples, tmp_path):
    """The port's writer, given the same samples as torch tensors, writes
    the same PNG bytes and meta as the JAX writer; the JAX reader reads it
    bit-identically."""
    root = str(tmp_path / "port_set")
    write_synthetic_burst_val(root, [
        {"burst": torch.tensor(s["burst"]),
         "frame_gt": torch.tensor(s["frame_gt"]),
         "meta": {k: torch.tensor(v) for k, v in s["meta"].items()}}
        for s in samples])
    for sub in ("bursts", "gt"):
        for d in sorted(os.listdir(os.path.join(val_root, sub))):
            for f in sorted(os.listdir(os.path.join(val_root, sub, d))):
                a = Path(root, sub, d, f).read_bytes()
                b = Path(val_root, sub, d, f).read_bytes()
                if f.endswith(".png"):
                    assert a == b, (sub, d, f)
    with open(os.path.join(root, "gt", "0002", "meta_info.pkl"), "rb") as f:
        meta = pickle.load(f)
    assert meta["index"] == 2 and isinstance(meta["index"], int)
    assert isinstance(meta["rgb2cam"], np.ndarray)
    theirs, ours = JaxSyntheticBurstVal(root), SyntheticBurstVal(val_root)
    assert not theirs.cv2_channel_order
    for i in range(N_BURSTS):
        _assert_same_item(theirs[i], ours[i])


# ---------------------------------------------------------------------------
# Scoring end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_scores(val_root, tiny_ckpt):
    nets = [JaxNetworkParam(checkpoint_path=tiny_ckpt, display_name="tiny")]
    return jax_synburst.compute_score(nets, val_root,
                                      boundary_ignore=BOUNDARY,
                                      with_lpips=False, with_msssim=True)


@pytest.fixture(scope="module")
def port_scores(val_root, tiny_ckpt):
    return _score(val_root, _nets(tiny_ckpt), with_msssim=True)


def _close(got, want):
    assert abs(got["psnr"] - want["psnr"]) <= PSNR_DB, (got, want)
    for m in ("ssim", "msssim"):
        assert abs(got[m] - want[m]) <= SSIM_ABS, (m, got, want)


def test_compute_score_means_match_jax(port_scores, jax_scores):
    assert list(port_scores) == list(jax_scores) == ["psnr", "ssim",
                                                     "msssim"]
    got = {m: v["tiny"] for m, v in port_scores.items()}
    want = {m: v["tiny"] for m, v in jax_scores.items()}
    assert all(np.isfinite(v) for v in got.values())
    _close(got, want)


def test_per_burst_scores_match_jax(val_root, tiny_ckpt):
    """Per burst: the port's fused forward-quantize-score function against
    the JAX package's ``_make_score_batch`` on its own quantized
    predictions."""
    ds = SyntheticBurstVal(val_root)
    bursts = np.stack([ds[i][0] for i in range(N_BURSTS)])
    gts = np.stack([ds[i][1] for i in range(N_BURSTS)])

    jnet, jparams, _ = jax_load_network(tiny_ckpt)
    jpred = jax_synburst._forward_fn(jnet)(jparams, jnp.asarray(bursts))
    jq = jax_synburst.quantize(jpred)
    want = jax.device_get(jax_synburst._make_score_batch(BOUNDARY, True)(
        jq, jnp.asarray(gts)))

    net, _ = NetworkParam(checkpoint_path=tiny_ckpt).load_net("",
                                                              device="cpu")
    score = synburst._make_score_batch(BOUNDARY, True)
    got = synburst._scored_forward_fn(net, score)(
        torch.from_numpy(synburst._host_u16(bursts)),
        torch.from_numpy(synburst._host_u16(gts)))
    pred = synburst._forward_fn(net)(torch.from_numpy(bursts))
    assert np.abs(pred.numpy() - np.asarray(jpred)).max() <= 1e-5
    for i in range(N_BURSTS):
        _close({m: float(got[m][i]) for m in got},
               {m: float(want[m][i]) for m in want})


# ---------------------------------------------------------------------------
# Protocol invariants (as tests/test_eval.py holds the JAX package to them)
# ---------------------------------------------------------------------------

def test_saved_results_score_like_live(val_root, tiny_ckpt, port_scores,
                                       tmp_path):
    out = str(tmp_path / "saved")
    synburst.save_results(_nets(tiny_ckpt), val_root, out, device="cpu")
    assert sorted(os.listdir(os.path.join(out, "tiny"))) == [
        f"{i:04d}.png" for i in range(N_BURSTS)]
    by_root = _score(val_root, _nets(tiny_ckpt), with_msssim=True,
                     saved_results_root=out)
    by_path = _score(val_root, [NetworkParam(
        saved_results_path=os.path.join(out, "tiny"))], with_msssim=True)
    for m in port_scores:
        assert abs(by_root[m]["tiny"] - port_scores[m]["tiny"]) <= 1e-6
        assert abs(by_path[m]["tiny"] - port_scores[m]["tiny"]) <= 1e-6


def test_scores_do_not_depend_on_batch_size(val_root, tiny_ckpt):
    per = [_score(val_root, _nets(tiny_ckpt), batch_size=bs)
           for bs in (1, 2, 8)]
    for s in per[1:]:
        assert abs(s["psnr"]["tiny"] - per[0]["psnr"]["tiny"]) <= 1e-5
        assert abs(s["ssim"]["tiny"] - per[0]["ssim"]["tiny"]) <= 1e-6


def test_compute_score_fills_the_timing_dict(val_root, tiny_ckpt, capsys):
    """Each network's timing goes into ``timing`` under its display name,
    the numbers its ``[timing]`` line prints; off the card no device time."""
    timing = {}
    _score(val_root, _nets(tiny_ckpt), batch_size=2, timing=timing)
    assert list(timing) == ["tiny"]
    t = timing["tiny"]
    assert t["bursts"] == N_BURSTS and t["device_ms"] is None
    assert t["reader_s"] > 0.0
    for k in ("waited_s", "transfer_s", "fetch_s"):
        assert 0.0 <= t[k] <= t["wall_s"], k
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[timing] tiny:")]
    assert len(line) == 1 and "on the device not measured" in line[0]
    assert f"wall {t['wall_s']:.3f} s" in line[0]


def test_burst_size_override(val_root, tiny_ckpt):
    scores = _score(val_root, [NetworkParam(checkpoint_path=tiny_ckpt,
                                            burst_sz=2)])
    (name,) = scores["psnr"].keys()
    assert name == "dbsr_synthetic_ep0001.ckpt_bsz02"
    assert np.isfinite(scores["psnr"][name])


def test_trajectory_matches_per_epoch_scores(val_root, workspace):
    traj = synburst.compute_score_trajectory(
        "dbsr", "default_synthetic", val_root, workspace_dir=workspace,
        boundary_ignore=BOUNDARY, batch_size=2, device="cpu")
    assert sorted(traj["psnr"]) == ["dbsr_default_synthetic_ep0001",
                                    "dbsr_default_synthetic_ep0002"]
    for e in (1, 2):
        single = _score(val_root, [NetworkParam(
            module="dbsr", parameter="default_synthetic", epoch=e)],
            workspace_dir=workspace, batch_size=2)
        for m in ("psnr", "ssim"):
            assert traj[m][f"dbsr_default_synthetic_ep{e:04d}"] == \
                pytest.approx(list(single[m].values())[0], abs=1e-6)
    assert traj["psnr"]["dbsr_default_synthetic_ep0001"] != \
        traj["psnr"]["dbsr_default_synthetic_ep0002"]


def test_iter_burst_batches_pads_and_reraises(val_root):
    ds = SyntheticBurstVal(val_root)
    read_s = []
    batches = list(synburst._iter_burst_batches(ds, 3, 2, None,
                                                read_s=read_s))
    assert [b[1].shape[0] for b in batches] == [2, 1] and len(read_s) == 2
    assert [m["burst_name"] for metas, _, _ in batches for m in metas] == \
        ["0000", "0001", "0002"]
    tail = synburst._pad_to(batches[-1][1], 4)
    assert tail.shape[0] == 4
    np.testing.assert_array_equal(tail[1], tail[3])
    np.testing.assert_array_equal(synburst._pad_to(batches[-1][1], 4),
                                  jax_synburst._pad_to(batches[-1][1], 4))

    class Broken:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        list(synburst._iter_burst_batches(Broken(), 2, 2, None))


def test_u16_transfer_roundtrip_exact():
    rng = np.random.default_rng(0)
    ints = rng.integers(0, 2 ** 14 + 1, size=(2, 5, 6, 3), dtype=np.uint16)
    f = ints.astype(np.float32) / 2 ** 14
    u = synburst._host_u16(f)
    assert u.dtype == np.uint16
    np.testing.assert_array_equal(u, ints)
    back = synburst._dev_f32(torch.from_numpy(u))
    assert back.dtype == torch.float32
    np.testing.assert_array_equal(back.numpy(), f)
    same = torch.from_numpy(f)
    assert synburst._dev_f32(same) is same


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("scale_range,ar_range", [
    (None, None), ((0.5, 1.0), None), ((0.5, 0.9), (0.8, 1.25))])
@pytest.mark.parametrize("hw", [(48, 40), (20, 26)])
def test_crops_equal_jax(dtype, scale_range, ar_range, hw):
    """``random_resized_crop`` (its resize included: the jitter's scales,
    and a frame smaller than the crop) and ``center_crop`` equal the JAX
    package's on the same frame and the same numpy generator."""
    frame = np.random.default_rng(3).uniform(0, 255, (*hw, 3)).astype(dtype)
    crop_sz = (24, 24)
    got_rng, want_rng = np.random.default_rng(7), np.random.default_rng(7)
    resized = 0
    for _ in range(6):
        got = pipeline.random_resized_crop(got_rng, frame, crop_sz,
                                           scale_range, ar_range)
        want = jax_pipeline.random_resized_crop(want_rng, frame, crop_sz,
                                                scale_range, ar_range)
        assert got.dtype == want.dtype and got.shape == (*crop_sz, 3)
        np.testing.assert_array_equal(got, want)
        resized += got.dtype != frame.dtype or not np.shares_memory(got,
                                                                    frame)
    assert resized > 0 or (scale_range is None and min(hw) >= 24)
    for sz in ((16, 16), (15, 9), hw):
        np.testing.assert_array_equal(pipeline.center_crop(frame, sz),
                                      jax_pipeline.center_crop(frame, sz))


def test_quantize_equals_jax_bit_for_bit():
    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.uniform(-0.5, 1.5, 20000),
        np.arange(0, 2 ** 14 + 1) / 2 ** 14,                  # on the grid
        np.nextafter(np.arange(1, 2 ** 14) / 2 ** 14, 0),     # just below
        [0.0, -0.0, 1.0, 1e-30, -1e-30, 1 - 1e-8]]).astype(np.float32)
    got = synburst.quantize(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_synburst.quantize(jnp.asarray(x)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("case", [
    (["netA", "netB"], {"psnr": {"netA": 39.1, "netB": 38.2},
                        "ssim": {"netA": 0.95, "netB": 0.94}}, ""),
    (["a_much_longer_network_name", "x"],
     {"psnr": {"a_much_longer_network_name": 41.123456},
      "ssim": {"x": 0.5}, "msssim": {"x": 0.98765}}, "synburst"),
])
def test_report_string_equals_jax(case):
    names, scores, table = case
    got = generate_formatted_report(names, scores, table)
    assert got == jax_report(names, scores, table)
    assert "\n" in got and names[0] in got


@pytest.mark.parametrize("kw", [
    {"module": "dbsr", "parameter": "default_synthetic"},
    {"module": "dbsr", "parameter": "default_synthetic", "epoch": 7,
     "burst_sz": 8},
    {"checkpoint_path": "/a/b/net_ep0003.ckpt"},
    {"checkpoint_path": "/a/b/net_ep0003.ckpt", "burst_sz": 2},
    {"saved_results_path": "/a/b/saved_net/"},
    {"checkpoint_path": "/a/b/c.ckpt", "display_name": "shown"},
])
def test_network_param_names_equal_jax(kw):
    ours, theirs = NetworkParam(**kw), JaxNetworkParam(**kw)
    assert ours.get_display_name() == theirs.get_display_name()
    assert ours.get_unique_name() == theirs.get_unique_name()


def test_network_param_resolves_like_jax(workspace):
    for epoch in (None, 1):
        kw = {"module": "dbsr", "parameter": "default_synthetic",
              "epoch": epoch}
        assert NetworkParam(**kw).resolve_checkpoint(workspace) == \
            JaxNetworkParam(**kw).resolve_checkpoint(workspace)
    with pytest.raises(FileNotFoundError):
        NetworkParam(module="dbsr", parameter="nothing").resolve_checkpoint(
            workspace)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    """A JAX-written set of 2 bursts at 96^2 crops, large enough for the
    protocol's boundary of 40 px, which the CLI does not change."""
    root = str(tmp_path_factory.mktemp("synval96"))
    cfg = CFG._replace(crop_sz=(96, 96))
    samples = []
    for i in range(2):
        img = jnp.asarray(np.random.RandomState(10 + i).rand(
            *cfg.pre_crop_sz, 3).astype(np.float32))
        s = jax_rgb2rawburst(jax.random.key(10 + i), img, cfg)
        samples.append({"burst": s["burst"], "frame_gt": s["frame_gt"],
                        "meta": {}})
    jax_write_synthetic_burst_val(root, samples)
    return root


def test_cli_compute_score_json_equals_api(cli_root, workspace, tmp_path,
                                           monkeypatch, capsys):
    """``run_evaluation synburst compute_score dbsr_default`` on the CPU:
    its JSON equals the API's scores of the workspace's latest checkpoint,
    which are within the limits of the JAX package's."""
    monkeypatch.setenv("DBSR_TPU_ENV", str(tmp_path / "env.json"))
    monkeypatch.setenv("DBSR_TPU_WORKSPACE_DIR", workspace)
    monkeypatch.setenv("DBSR_TPU_SYNBURSTVAL_DIR", cli_root)
    out = str(tmp_path / "scores.json")
    run_evaluation.main(["synburst", "compute_score", "dbsr_default",
                         "--no_lpips", "--device", "cpu", "--json", out])
    assert "[timing]" in capsys.readouterr().out
    with open(out) as f:
        got = json.load(f)
    nets = [NetworkParam(module="dbsr", parameter="default_synthetic")]
    want = synburst.compute_score(nets, cli_root, workspace_dir=workspace,
                                  with_lpips=False, device="cpu")
    assert list(got["psnr"]) == ["dbsr_default_synthetic"]
    assert got == want
    jax_nets = [JaxNetworkParam(module="dbsr", parameter="default_synthetic")]
    theirs = jax_synburst.compute_score(jax_nets, cli_root,
                                        workspace_dir=workspace,
                                        with_lpips=False)
    name = "dbsr_default_synthetic"
    assert abs(got["psnr"][name] - theirs["psnr"][name]) <= PSNR_DB
    assert abs(got["ssim"][name] - theirs["ssim"][name]) <= SSIM_ABS


def test_cli_all_epochs_and_saved_results(cli_root, workspace, tmp_path,
                                          monkeypatch):
    monkeypatch.setenv("DBSR_TPU_ENV", str(tmp_path / "env.json"))
    monkeypatch.setenv("DBSR_TPU_WORKSPACE_DIR", workspace)
    common = ["--device", "cpu", "--dataset_root", cli_root]
    traj = str(tmp_path / "traj.json")
    run_evaluation.main(["synburst", "compute_score", "dbsr_default",
                         "--all_epochs", "--epochs", "2,1", "--json", traj,
                         *common])
    want = synburst.compute_score_trajectory(
        "dbsr", "default_synthetic", cli_root, workspace_dir=workspace,
        device="cpu")
    with open(traj) as f:
        assert json.load(f) == want
    saved = str(tmp_path / "saved")
    run_evaluation.main(["synburst", "save_results", "dbsr_default",
                         "--out_dir", saved, *common])
    live, from_saved = str(tmp_path / "live.json"), str(tmp_path / "s.json")
    run_evaluation.main(["synburst", "compute_score", "dbsr_default",
                         "--no_lpips", "--json", live, *common])
    run_evaluation.main(["synburst", "compute_score", "dbsr_default",
                         "--no_lpips", "--load_saved", "--out_dir", saved,
                         "--json", from_saved, *common])
    with open(live) as f, open(from_saved) as g:
        np.testing.assert_equal(json.load(f), json.load(g))


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_run_evaluation", REPO / "run_evaluation.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [
    ["synburst", "compute_score", "x", "--load_saved"],
    ["synburst", "save_results", "x", "--load_saved", "--out_dir", "o"],
    ["burstsr", "compute_score", "x", "--load_saved", "--out_dir", "o"],
    ["synburst", "save_results", "x", "--all_epochs"],
    ["burstsr", "compute_score", "x", "--all_epochs"],
    ["synburst", "compute_score", "x", "--all_epochs", "--load_saved",
     "--out_dir", "o"],
    ["synburst", "compute_score", "x", "--epochs", "1"],
    ["synburst", "compute_score", "x", "--all_epochs", "--epochs", "a,b"],
    ["synburst", "compute_score", "x", "--all_epochs", "--epochs", ","],
    ["synburst", "nothing", "x"],
])
def test_cli_refuses_what_the_jax_cli_refuses(argv, monkeypatch, capsys):
    errors = []
    monkeypatch.setattr("sys.argv", ["run_evaluation.py", *argv])
    for main in (lambda: run_evaluation.main(argv),
                 lambda: _jax_cli().main()):
        with pytest.raises(SystemExit) as exc:
            main()
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0].split("error:")[1] == errors[1].split("error:")[1]


def _pngs_close(got_dir, want_dir, tag):
    """Two visualize outputs: the same files up to the PSNR in the panels'
    names (within 0.01 dB: two decimals can round the two ways), each image
    within 1 LSB on at least 99.9% of its pixels and equal on at least 99%
    (SCA's alignment moves the aligned pane's values: 99.83% equal, none
    more than 1 LSB off, observed)."""
    import re

    strip = re.compile(rf"_{tag}(-?[\d.]+)\.png$")
    got, want = ({strip.sub("", f): f for f in os.listdir(d)}
                 for d in (got_dir, want_dir))
    assert got.keys() == want.keys() and "index.html" in got
    for stem, f in got.items():
        if f == "index.html":
            continue
        g = png16.read_png(os.path.join(got_dir, f)).astype(np.int16)
        w = png16.read_png(os.path.join(want_dir, want[stem])).astype(
            np.int16)
        assert g.shape == w.shape, f
        assert (np.abs(g - w) <= 1).mean() >= 0.999, f
        assert (g == w).mean() >= 0.99, f
        m, n = strip.search(f), strip.search(want[stem])
        assert (m is None) == (n is None)
        if m:
            assert abs(float(m.group(1)) - float(n.group(1))) <= 0.01 + 1e-9


@pytest.mark.parametrize("benchmark", ["burstsr", "synburst"])
def test_cli_visualize_matches_jax(benchmark, val_root, workspace, tmp_path,
                                   monkeypatch):
    """``visualize``, once refused, runs through the CLI on the CPU and
    writes what the JAX package's ``visualize_*`` writes: synburst on this
    module's val set and workspace, burstsr on a one-burst tree of the
    port's generator at the val protocol's size with a tiny x8 network."""
    from dbsr_tpu.evaluation import visualize as jax_vis

    monkeypatch.setenv("DBSR_TPU_ENV", str(tmp_path / "env.json"))
    ws, root = workspace, val_root
    if benchmark == "burstsr":
        from dbsr_tpu_torch.data import make_synthetic_burstsr
        from dbsr_tpu_torch.data.procedural import make_generator
        from dbsr_tpu_torch.models.dbsr import dbsrnet_tiny
        from dbsr_tpu_torch.models.layers import init_params
        from dbsr_tpu_torch.training.checkpoint import save_checkpoint
        from dbsr_tpu_torch.training.state import make_optimizer

        root = str(tmp_path / "tree")
        make_synthetic_burstsr.generate_dataset(
            root, bursts=1, lr=80, n_frames=3, split="val", seed=2,
            device="cpu")
        ws = str(tmp_path / "ws")
        net = init_params(dbsrnet_tiny(), make_generator("cpu", 4))
        save_checkpoint(os.path.join(ws, "dbsr", "default_synthetic"),
                        "dbsr_synthetic", 1, make_optimizer().init(net))
    monkeypatch.setenv("DBSR_TPU_WORKSPACE_DIR", ws)
    run_evaluation.main([benchmark, "visualize", "dbsr_default",
                         "--dataset_root", root, "--out_dir",
                         str(tmp_path / "port"), "--max_bursts", "2",
                         "--device", "cpu"])
    fn = getattr(jax_vis, f"visualize_{benchmark}")
    fn([JaxNetworkParam(module="dbsr", parameter="default_synthetic")],
       root, str(tmp_path / "jax"), workspace_dir=ws, max_bursts=2)
    name = "dbsr_default_synthetic"
    _pngs_close(tmp_path / "port" / name, tmp_path / "jax" / name,
                "apsnr" if benchmark == "burstsr" else "psnr")
    n = len(os.listdir(tmp_path / "port" / name))
    assert n == (5 if benchmark == "burstsr" else 2 * 4 + 1)


def test_dbsr_zoo_resolves_the_three_artifacts():
    from dbsr_tpu.evaluation.experiments import dbsr_zoo as jax_zoo
    from dbsr_tpu_torch.evaluation.experiments import dbsr_zoo

    nets = dbsr_zoo.main()
    assert [n.get_display_name() for n in nets] == [
        "dbsr_campaign_r3d", "dbsr_campaign_r4mix", "dbsr_campaign_r5"]
    assert [n.checkpoint_path for n in nets] == \
        [n.checkpoint_path for n in jax_zoo.main()]
    assert all(os.path.exists(n.checkpoint_path) for n in nets)


R3D_CFG = JaxBurstConfig(burst_size=14, crop_sz=(64, 64), downsample_factor=4,
                         border_crop=4, max_translation=3.0, max_rotation=0.5)


@pytest.fixture(scope="module")
def r3d_val_root(tmp_path_factory):
    """A JAX-written val set of two bursts at r3d's x8 (8x8 packed frames,
    64x64 ground truth)."""
    out = []
    for i in range(2):
        img = jnp.asarray(np.random.RandomState(30 + i).rand(
            *R3D_CFG.pre_crop_sz, 3).astype(np.float32))
        s = jax_rgb2rawburst(jax.random.key(30 + i), img, R3D_CFG)
        out.append({"burst": np.asarray(s["burst"]),
                    "frame_gt": np.asarray(s["frame_gt"]),
                    "meta": {"gains": 1.0, "index": i,
                             "rgb2cam": np.asarray(s["meta"]["rgb2cam"])}})
    root = str(tmp_path_factory.mktemp("r3dval"))
    jax_write_synthetic_burst_val(root, out)
    return root


def test_scoring_r3d_raises_the_pwc_refusal_before_any_read(r3d_val_root,
                                                            tmp_path):
    """r3d, the zoo's PWC-Net model, which the port once refused before
    reading a burst, is scored: the port and the JAX package on a float32
    copy of the checkpoint (it records bf16, which both score at by
    default), within this file's limits."""
    from dbsr_tpu_torch.evaluation.experiments import dbsr_zoo
    from dbsr_tpu_torch.training.checkpoint import (read_checkpoint,
                                                    write_checkpoint)

    r3d = dbsr_zoo.main()[0]
    assert r3d.get_display_name() == "dbsr_campaign_r3d"
    header, tree = read_checkpoint(r3d.checkpoint_path)
    assert header["net_spec"]["kwargs"]["dtype"] == {"__dtype__": "bfloat16"}
    header["net_spec"]["kwargs"]["dtype"] = None
    f32 = write_checkpoint(str(tmp_path / "r3d_f32.ckpt"), header, tree)
    want = jax_synburst.compute_score(
        [JaxNetworkParam(checkpoint_path=f32, display_name="r3d")],
        r3d_val_root, boundary_ignore=BOUNDARY, with_lpips=False,
        with_msssim=True)
    got = _score(r3d_val_root, [NetworkParam(checkpoint_path=f32,
                                             display_name="r3d")],
                 with_msssim=True)
    got = {m: v["r3d"] for m, v in got.items()}
    assert all(np.isfinite(v) for v in got.values())
    _close(got, {m: v["r3d"] for m, v in want.items()})


@pytest.mark.parametrize("entry", ["compute_score", "save_results",
                                   "trajectory", "cli", "generator"])
def test_cuda_without_a_card_raises(entry, val_root, tiny_ckpt, tmp_path,
                                    monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    calls = {
        "compute_score": lambda: synburst.compute_score(
            _nets(tiny_ckpt), val_root, with_lpips=False),
        "save_results": lambda: synburst.save_results(
            _nets(tiny_ckpt), val_root, str(tmp_path)),
        "trajectory": lambda: synburst.TrajectoryScorer(val_root),
        "cli": lambda: run_evaluation.main(
            ["synburst", "compute_score", "dbsr_default", "--dataset_root",
             val_root]),
        "generator": lambda: gen.main(
            ["--procedural", "2", "--num_bursts", "1", "--out_dir",
             str(tmp_path / "g")]),
    }
    monkeypatch.setenv("DBSR_TPU_ENV", str(tmp_path / "env.json"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_generator_flags(monkeypatch, tmp_path, capsys):
    seen = []
    monkeypatch.setattr(gen, "generate",
                        lambda *a, **kw: seen.append((a, kw)))
    gen.main(["--procedural", "150", "--num_bursts", "300", "--seed",
              "20260817", "--out_dir", "d"])
    (args, kw), = seen
    assert args[:3] == ("d", 300, 150) and kw["seed"] == 20260817
    assert kw["device"] == "cuda" and args[3] == gen.eval_burst_config()
    cfg = args[3]
    assert (cfg.burst_size, cfg.crop_sz, cfg.downsample_factor,
            cfg.border_crop, cfg.max_translation, cfg.max_rotation,
            cfg.fused_resample) == (14, (384, 384), 4, 24, 24.0, 1.0, False)
    assert cfg.burst_hw == (48, 48)
    gen.main(["--procedural", "2", "--out_dir", "d", "--burst_size", "8",
              "--fused_resample", "--device", "cpu"])
    assert seen[1][0][3] == gen.eval_burst_config(8, True)
    assert seen[1][1]["device"] == "cpu"
    gen.main(["--source_dir", "imgs", "--out_dir", "d"])
    assert seen[2][0][:3] == ("d", 300, None)
    assert seen[2][1]["source_dir"] == "imgs"
    for argv in (["--out_dir", "d"],
                 ["--source_dir", "i", "--procedural", "2", "--out_dir",
                  "d"]):
        with pytest.raises(SystemExit):
            gen.main(argv)
    assert "exactly one of --source_dir / --procedural" in \
        capsys.readouterr().err


def test_generated_set_is_read_alike_by_both_packages(tmp_path, capsys):
    """The generator at a small size on the CPU (2 procedural sources, 2
    bursts): both readers read the same arrays and meta."""
    root = str(tmp_path / "gen")
    cfg = gen.eval_burst_config(burst_size=3)._replace(
        crop_sz=(32, 32), border_crop=4, downsample_factor=2,
        max_translation=3.0)
    gen.generate(root, 2, 2, cfg, seed=3, device="cpu")
    assert "wrote 2 bursts" in capsys.readouterr().out
    ours = SyntheticBurstVal(root, burst_size=3)
    theirs = JaxSyntheticBurstVal(root, burst_size=3)
    assert len(ours) == len(theirs) == 2
    for i in range(2):
        got, want = ours[i], theirs[i]
        _assert_same_item(got, want)
        assert got[0].shape == (3, 8, 8, 4) and got[1].shape == (32, 32, 3)
        assert set(got[2]) == {"rgb2cam", "cam2rgb", "rgb_gain", "red_gain",
                               "blue_gain", "smoothstep", "gamma",
                               "shot_noise_level", "read_noise_level",
                               "burst_name"}
        assert 0.0 <= got[0].min() and got[0].max() <= 1.0
    assert not np.array_equal(ours[0][1], ours[1][1])
