"""The port's real-world (BurstSR) path on the CPU against the JAX
package's: the reader (``data/burstsr.py``) on fixture trees, the fixture
generator (``data/make_synthetic_burstsr.py``) against the JAX package's
``util_scripts/make_synthetic_burstsr.py``, aligned scoring
(``evaluation/burstsr.py``), the real-world actor's loss and gradients,
``default_realworld`` end to end with a resume, and ``run_evaluation
burstsr``.

Trees are written by the port (``utils/png16.py``, ``pickle``), with pixels
from numpy seeds or from the port's generator. The network is the JAX
package's ``dbsrnet_tiny(flow_net="lite")`` with its seeded float32
parameters (the port reads them from the JAX package's checkpoint).

Tolerances: the reader's samples, frame ids, metadata and the exposure
factor are exact; the generator's planted ground truth within one uint16
step of the JAX generator's formula; scores within 5e-3 dB and 5e-5 SSIM;
the actor's loss and every gradient rtol 1e-4 / atol 1e-6.
"""

import importlib.util
import json
import os
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbsr_tpu.data import burstsr as jax_burstsr
from dbsr_tpu.evaluation import burstsr as jax_eval
from dbsr_tpu.evaluation.network_param import NetworkParam as JaxNetworkParam
from dbsr_tpu.models.dbsr import dbsrnet_tiny as jax_dbsrnet_tiny
from dbsr_tpu.models.sca import make_sca as jax_make_sca
from dbsr_tpu.training.actors import \
    make_realworld_actor as jax_make_realworld_actor
from dbsr_tpu_torch import run_evaluation
from dbsr_tpu_torch.data import burstsr
from dbsr_tpu_torch.data import make_synthetic_burstsr as gen
from dbsr_tpu_torch.evaluation import burstsr as ev
from dbsr_tpu_torch.evaluation.network_param import NetworkParam
from dbsr_tpu_torch.utils.png16 import write_png

REPO = Path(__file__).resolve().parents[1]
PSNR_DB, SSIM_ABS = 5e-3, 5e-5
RTOL, ATOL = 1e-4, 1e-6


def _load_jax_generator():
    spec = importlib.util.spec_from_file_location(
        "jax_make_synthetic_burstsr",
        REPO / "util_scripts" / "make_synthetic_burstsr.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_gen = _load_jax_generator()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this module runs (the suite runs
    in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_fixture(root, split, names, lr=32, scale=4, n_frames=4, seed=0):
    """A BurstSR-format tree of random frames with plain-dict EXIF (the
    layout of ``tests/test_burstsr.py:_make_fixture``), written by the
    port."""
    rng = np.random.RandomState(seed)
    for name in names:
        d = os.path.join(root, split, name)
        for i in range(n_frames):
            fd = os.path.join(d, f"samsung_{i:02d}")
            os.makedirs(fd, exist_ok=True)
            write_png(os.path.join(fd, "im_raw.png"),
                      rng.randint(64, 1023, (lr, lr, 4)).astype(np.uint16))
            with open(os.path.join(fd, "meta_info.pkl"), "wb") as f:
                pickle.dump({
                    "black_level": [64, 64, 64, 64],
                    "cam_wb": [2.0, 1.0, 1.0, 1.5],
                    "daylight_wb": [2.0, 1.0, 1.0, 1.5],
                    "color_matrix": np.eye(3).tolist(),
                    "exif_data": {"exposure": 0.01, "f_number": 1.7,
                                  "iso": 100, "noise_profile": np.array(
                                      [[1e-3, 1e-5]] * 3)}}, f)
        gd = os.path.join(d, "canon")
        os.makedirs(gd, exist_ok=True)
        write_png(os.path.join(gd, "im_raw.png"), rng.randint(
            512, 16383, (lr * scale, lr * scale, 3)).astype(np.uint16))
        with open(os.path.join(gd, "meta_info.pkl"), "wb") as f:
            pickle.dump({
                "black_level": [512, 512, 512, 512],
                "cam_wb": [2.1, 1.0, 1.0, 1.6],
                "daylight_wb": [2.1, 1.0, 1.0, 1.6],
                "rgb_xyz_matrix": np.eye(4, 3).tolist(),
                "exif_data": {"exposure": 0.02, "f_number": 4.0,
                              "iso": 200}}, f)


@pytest.fixture(scope="module")
def random_root(tmp_path_factory):
    """Random trees: val (0008, 0010; 14 frames of 84^2, ground truth 8x:
    the val protocol's 80-px crop fits) and train (0001, 0002; 4 frames of
    32^2, ground truth 4x)."""
    root = str(tmp_path_factory.mktemp("burstsr"))
    _make_fixture(root, "val", ("0008_0001", "0010_0002"), lr=84, scale=8,
                  n_frames=14)
    _make_fixture(root, "train", ("0001_0001", "0002_0001", "0002_0002"),
                  seed=1)
    return root


@pytest.fixture(scope="module")
def gen_root(tmp_path_factory):
    """The port's generator on the CPU: two val bursts of 4 frames of 16^2
    (ground truth 128^2) with the planted misregistration."""
    root = str(tmp_path_factory.mktemp("gen"))
    names = gen.generate_dataset(root, bursts=2, lr=16, n_frames=4,
                                 split="val", seed=1, device="cpu")
    assert names == ["0008_0001", "0010_0001"]
    return root


def _equal_samples(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_equal(got[k], want[k], err_msg=k)


def _record_ids(dataset):
    """Wrap ``dataset.get_burst`` to record the frame ids it is asked for."""
    ids = []
    real = dataset.get_burst

    def get_burst(burst_id, im_ids, info=None):
        ids.append((burst_id, list(im_ids)))
        return real(burst_id, im_ids, info)

    dataset.get_burst = get_burst
    return ids


# ---------------------------------------------------------------------------
# the reader


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_split_lists_are_the_jax_packages(split):
    assert burstsr.load_split_ids(split) == jax_burstsr._load_split_ids(split)


def test_val_set_matches_jax_exactly(random_root):
    port = burstsr.get_burstsr_val_set(random_root)
    jax_set = jax_burstsr.get_burstsr_val_set(random_root)
    assert len(port) == len(jax_set) == 2
    for i in range(2):
        got, want = port[i], jax_set[i]
        assert got["burst"].shape == (14, 80, 80, 4)
        assert got["frame_gt"].shape == (640, 640, 3)
        _equal_samples(got, want)


@pytest.mark.parametrize("options", [
    dict(substract_black_level=True, random_flip=True),
    dict(white_balance=True, random_flip=True),
    dict(substract_black_level=True, noise_level=(1e-3, 1e-2)),
])
def test_random_sampler_matches_jax_exactly(random_root, options):
    """The same seed draws the same bursts, frame ids, crops and flips (and
    noise): equal samples, bit for bit."""
    samples, ids = [], []
    for pkg in (burstsr, jax_burstsr):
        ds = pkg.BurstSRDataset(random_root, split="train")
        ids.append(_record_ids(ds))
        sampler = pkg.RandomBurstSampler(
            ds, burst_size=3, samples_per_epoch=8,
            processing=pkg.BurstSRProcessing(crop_sz=16, **options), seed=3)
        samples.append([sampler[i] for i in range(8)])
    assert ids[0] == ids[1]
    for got, want in zip(*samples):
        assert got["burst"].shape[1:] == (16, 16, 4)
        assert got["frame_gt"].shape == (64, 64, 3)
        _equal_samples(got, want)


def test_frame_id_selection_matches_jax():
    for ref in (False, True):
        port = burstsr.IndexedBurstSampler(None, burst_size=6,
                                           random_reference_image=ref, seed=5)
        jax_s = jax_burstsr.IndexedBurstSampler(
            None, burst_size=6, random_reference_image=ref, seed=5)
        for available in (4, 14, 6):
            got = port._select_ids(available)
            assert got == jax_s._select_ids(available)
            assert len(got) == 6 and all(0 <= i < available for i in got)


def test_images_and_display_path_match_jax(random_root):
    port = burstsr.BurstSRDataset(random_root, split="train")
    jax_ds = jax_burstsr.BurstSRDataset(random_root, split="train")
    assert port.burst_list == jax_ds.burst_list
    assert port.get_burst_info(0) == jax_ds.get_burst_info(0)
    (f, *_), gt, _ = port.get_burst(0, [0, 1])
    (jf, *_), jgt, _ = jax_ds.get_burst(0, [0, 1])
    assert f.shape() == (32, 32, 4) and gt.shape() == (128, 128, 3)
    for a, b in ((f, jf), (gt, jgt)):
        for kw in ({}, {"substract_black_level": True, "normalize": True},
                   {"white_balance": True}):
            np.testing.assert_array_equal(a.get_image_data(**kw),
                                          b.get_image_data(**kw))
        np.testing.assert_equal(a.get_all_meta_data(), b.get_all_meta_data())
        assert (a.get_exposure_time(), a.get_f_number(), a.get_iso()) == \
            (b.get_exposure_time(), b.get_f_number(), b.get_iso())
    np.testing.assert_array_equal(f.get_noise_profile(),
                                  jf.get_noise_profile())
    meta = dict(gt.get_all_meta_data(), black_level_subtracted=False,
                while_balance_applied=False)
    im = gt.get_image_data(normalize=True)
    np.testing.assert_array_equal(
        burstsr.CanonImage.generate_processed_image(im, meta),
        jax_burstsr.CanonImage.generate_processed_image(im, meta))


# ---------------------------------------------------------------------------
# the fixture generator


def test_generator_plants_the_jax_constants():
    assert gen.GT_SHIFT == jax_gen.GT_SHIFT
    np.testing.assert_array_equal(gen.COLOR_M, jax_gen.COLOR_M)
    assert gen.SAMSUNG_EXIF == jax_gen.SAMSUNG_EXIF
    assert gen.CANON_EXIF == jax_gen.CANON_EXIF
    assert (gen.SAMSUNG_BLACK, gen.SAMSUNG_MAX, gen.CANON_BLACK,
            gen.CANON_MAX) == (jax_gen.SAMSUNG_BLACK, jax_gen.SAMSUNG_MAX,
                               jax_gen.CANON_BLACK, jax_gen.CANON_MAX)
    assert gen.exp_scale_factor() == jax_gen.exp_scale_factor()


def test_generated_tree_reads_alike_and_holds_the_planted_transform(gen_root):
    """The JAX package's reader reads the port's tree into the samples the
    port's reader gives; its ground truth is the JAX generator's Canon
    content of the stored scene (shift, colour transform, exposure), to
    one uint16 step."""
    proc = dict(crop_sz=16, substract_black_level=True, random_crop=False)
    got = burstsr.IndexedBurstSampler(
        burstsr.BurstSRDataset(gen_root, "val"), burst_size=4,
        processing=burstsr.BurstSRProcessing(**proc))
    want = jax_burstsr.IndexedBurstSampler(
        jax_burstsr.BurstSRDataset(gen_root, "val"), burst_size=4,
        processing=jax_burstsr.BurstSRProcessing(**proc))
    es = jax_gen.exp_scale_factor()
    for i in range(2):
        a, b = got[i], want[i]
        _equal_samples(a, b)
        assert a["burst"].shape == (4, 16, 16, 4)
        assert a["exp_scale_factor"] == pytest.approx(es, rel=1e-12)
        assert 0.0 <= a["burst"].min() and a["burst"].max() <= 1.0
        scene = np.load(os.path.join(gen_root, "val", a["burst_name"],
                                     "scene_linear.npy"))
        assert scene.shape == (128, 128, 3)
        content = jax_gen.canon_from_scene(scene)
        stored = np.clip(np.round(jax_gen.CANON_BLACK + content / es * (
            jax_gen.CANON_MAX - jax_gen.CANON_BLACK)), 0, jax_gen.CANON_MAX)
        read = (stored - jax_gen.CANON_BLACK) / 16383.0 * es
        np.testing.assert_allclose(a["frame_gt"], read, rtol=0,
                                   atol=es / 16383.0 + 1e-6)


# ---------------------------------------------------------------------------
# scoring and the actor, with the JAX package's tiny network


def _save_port_tiny(directory, seed, **kw):
    """A ``dbsr_synthetic`` epoch-1 checkpoint of the port's tiny network
    (AlignLite, x8 unless ``upsample_factor`` says otherwise) with seeded
    parameters, which the JAX package's ``load_network`` reads too.
    Returns its path and its state dict."""
    from dbsr_tpu_torch.data.procedural import make_generator
    from dbsr_tpu_torch.models.dbsr import dbsrnet_tiny
    from dbsr_tpu_torch.models.layers import init_params
    from dbsr_tpu_torch.training.checkpoint import save_checkpoint
    from dbsr_tpu_torch.training.state import make_optimizer

    net = dbsrnet_tiny(**kw)
    init_params(net, make_generator("cpu", seed))
    path = save_checkpoint(str(directory), "dbsr_synthetic", 1,
                           make_optimizer().init(net))
    return path, {k: v.clone() for k, v in net.state_dict().items()}


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    return _save_port_tiny(tmp_path_factory.mktemp("tiny"), 4)[0]


def _val(pkg, root):
    return pkg.IndexedBurstSampler(
        pkg.BurstSRDataset(root, "val"), burst_size=4,
        processing=pkg.BurstSRProcessing(crop_sz=16,
                                         substract_black_level=True,
                                         random_crop=False))


def test_compute_score_matches_jax(gen_root, tiny_ckpt, capsys):
    """Two bursts of the generator's tree, the tiny network's prediction
    (x8: 128^2) aligned by SCA with its own AlignLite, coarse to fine."""
    kw = dict(boundary_ignore=16, with_lpips=False, sr_factor=4)
    want = jax_eval.compute_score(
        [JaxNetworkParam(checkpoint_path=tiny_ckpt, display_name="tiny")],
        "", dataset=_val(jax_burstsr, gen_root), **kw)
    timing = {}
    got = ev.compute_score(
        [NetworkParam(checkpoint_path=tiny_ckpt, display_name="tiny")], "",
        dataset=_val(burstsr, gen_root), device="cpu", timing=timing, **kw)
    assert set(got) == {"psnr", "ssim"}
    assert abs(got["psnr"]["tiny"] - want["psnr"]["tiny"]) <= PSNR_DB
    assert abs(got["ssim"]["tiny"] - want["ssim"]["tiny"]) <= SSIM_ABS
    assert np.isfinite(got["psnr"]["tiny"]) and got["psnr"]["tiny"] > 0
    t = timing["tiny"]
    assert t["bursts"] == 2 and t["forward_ms"] is None  # off the card
    assert "[timing] tiny: 2 bursts" in capsys.readouterr().out


def test_save_results_writes_the_quantised_prediction(gen_root, tiny_ckpt,
                                                      tmp_path):
    from dbsr_tpu_torch.utils.png16 import read_png

    nets = [NetworkParam(checkpoint_path=tiny_ckpt, display_name="tiny")]
    ev.save_results(nets, "", str(tmp_path), dataset=_val(burstsr, gen_root),
                    device="cpu")
    net, _ = nets[0].load_net("", device="cpu")
    sampler = _val(burstsr, gen_root)  # the draws of save_results' pass
    for sample in (sampler[0], sampler[1]):
        pred = ev._forward_fn(net)(torch.from_numpy(sample["burst"]))
        want = (pred.numpy() * 2 ** 14).astype(np.uint16)
        got = read_png(str(tmp_path / "tiny"
                           / f"{sample['burst_name']}.png"))
        np.testing.assert_array_equal(got, want)


def test_realworld_actor_loss_and_gradients_match_jax(gen_root, tiny_ckpt):
    """One loss and every trainable gradient of the tiny network under
    10 x masked L1 after SCA (B=2), against ``jax.value_and_grad`` of the
    JAX actor on the same parameters and batch."""
    from dbsr_tpu_torch.evaluation.burstsr import _alignment_apply_from
    from dbsr_tpu_torch.models.sca import make_sca
    from dbsr_tpu_torch.serving import float32_math
    from dbsr_tpu_torch.training.actors import make_realworld_actor
    from dbsr_tpu_torch.training.checkpoint import load_network
    from dbsr_tpu_torch.utils.convert import params_to_flax

    sampler = _val(burstsr, gen_root)
    batch = {k: np.stack([sampler[i][k] for i in range(2)])
             for k in ("burst", "frame_gt")}
    net, _ = load_network(tiny_ckpt, device="cpu", dtype=None)
    actor = make_realworld_actor(net, make_sca(
        _alignment_apply_from(net.encoder.alignment_net), sr_factor=4))
    with float32_math():
        loss, stats = actor({k: torch.from_numpy(v) for k, v in
                             batch.items()})
        loss.backward()
    grads = params_to_flax({k: p.grad for k, p in net.named_parameters()
                            if p.requires_grad})

    jnet = jax_dbsrnet_tiny(flow_net="lite")
    params = {"params": jax.tree_util.tree_map(
        jnp.asarray, params_to_flax(net.state_dict()))}
    sub = params["params"]["encoder"]["alignment_net"]
    from dbsr_tpu.models.align_lite import AlignLiteNet, coarse_to_fine_flow
    jlite = AlignLiteNet()
    jactor = jax_make_realworld_actor(jnet, jax_make_sca(
        lambda s, t: coarse_to_fine_flow(
            lambda a, b: jlite.apply({"params": sub}, a, b), s, t),
        sr_factor=4))
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        jactor, has_aux=True))(params, jax.tree_util.tree_map(
            jnp.asarray, batch))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(float(stats["Stat/psnr"]),
                               float(jstats["Stat/psnr"]), rtol=RTOL)
    assert loss.item() > 0

    def walk(got, want, path=""):
        for k, v in got.items():
            if isinstance(v, dict):
                walk(v, want[k], f"{path}/{k}")
            else:
                np.testing.assert_allclose(v, np.asarray(want[k]), rtol=RTOL,
                                           atol=ATOL, err_msg=f"{path}/{k}")

    walk(grads, jgrads["params"])
    assert "alignment_net" not in grads["encoder"]  # frozen, as in JAX


# ---------------------------------------------------------------------------
# default_realworld and the CLI


def test_default_realworld_trains_and_resumes(random_root, tmp_path,
                                              monkeypatch):
    """Restore from the synthetic checkpoint (an epoch-0 warm start), two
    steps of one epoch at B=2, then a second epoch resumed from the first
    (``tests/test_burstsr.py:169`` on the port)."""
    from dbsr_tpu_torch.run_training import run_training
    from dbsr_tpu_torch.training.checkpoint import (read_checkpoint,
                                                    resolve_checkpoint)
    from dbsr_tpu_torch.utils.convert import params_from_flax

    ws = str(tmp_path / "ws")
    # x4: the train fixture's ground truth is 4x its packed frames
    _, synthetic = _save_port_tiny(
        os.path.join(ws, "dbsr", "default_synthetic"), 7, upsample_factor=4)
    monkeypatch.setenv("DBSR_TPU_ENV", str(tmp_path / "env.json"))
    monkeypatch.setenv("DBSR_TPU_WORKSPACE_DIR", ws)
    monkeypatch.setenv("DBSR_TPU_BURSTSR_DIR", random_root)
    kw = dict(device="cpu", batch_size=2, crop_sz=16, burst_sz=3,
              sr_factor=2, steps_per_epoch=2, print_interval=1)
    run_training("dbsr", "default_realworld", epochs=1, **kw)
    rw = os.path.join(ws, "dbsr", "default_realworld")
    header, tree = read_checkpoint(resolve_checkpoint(rw, "dbsr_realworld"))
    assert header["epoch"] == 1 and tree["step"] == 2
    assert np.isfinite(header["stats"]["train"]["Loss/total"])
    _, tree0 = read_checkpoint(resolve_checkpoint(rw, "dbsr_realworld", 0))
    for k, v in params_from_flax(tree0["params"]).items():
        torch.testing.assert_close(v, synthetic[k], rtol=0, atol=0)
    trained = params_from_flax(tree["params"])
    assert any(not torch.equal(trained[k], synthetic[k]) for k in synthetic)

    run_training("dbsr", "default_realworld", epochs=2, **kw)
    header, tree = read_checkpoint(resolve_checkpoint(rw, "dbsr_realworld"))
    assert header["epoch"] == 2 and tree["step"] == 4


def test_default_realworld_needs_a_synthetic_checkpoint(random_root, tmp_path,
                                                        monkeypatch):
    from dbsr_tpu_torch.run_training import run_training

    monkeypatch.setenv("DBSR_TPU_ENV", str(tmp_path / "env.json"))
    monkeypatch.setenv("DBSR_TPU_WORKSPACE_DIR", str(tmp_path / "ws"))
    monkeypatch.setenv("DBSR_TPU_BURSTSR_DIR", random_root)
    with pytest.raises(FileNotFoundError, match="default_synthetic first"):
        run_training("dbsr", "default_realworld", device="cpu")


def test_default_realworld_on_cuda_without_card_raises(tmp_path,
                                                       monkeypatch):
    from dbsr_tpu_torch.run_training import run_training

    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid device here")
    monkeypatch.setenv("DBSR_TPU_WORKSPACE_DIR", str(tmp_path / "ws"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_training("dbsr", "default_realworld")


def test_cli_scores_a_burstsr_tree(tmp_path, monkeypatch, capsys):
    """``run_evaluation burstsr compute_score dbsr_default`` on the port's
    generated tree at the val protocol's size (one burst of 80^2 frames,
    ground truth 640^2), the workspace's tiny x8 network: finite scores in
    its JSON and its ``[timing]`` line; then ``save_results`` from the
    environment's ``burstsr_dir`` writes the burst's PNG."""
    root = str(tmp_path / "tree")
    gen.generate_dataset(root, bursts=1, lr=80, n_frames=3, split="val",
                         seed=2, device="cpu")
    ws = tmp_path / "ws"
    _save_port_tiny(ws / "dbsr" / "default_synthetic", 8)
    monkeypatch.setenv("DBSR_TPU_ENV", str(tmp_path / "env.json"))
    monkeypatch.setenv("DBSR_TPU_WORKSPACE_DIR", str(ws))
    out = tmp_path / "scores.json"
    run_evaluation.main(["burstsr", "compute_score", "dbsr_default",
                         "--dataset_root", root, "--no_lpips", "--json",
                         str(out), "--device", "cpu"])
    with open(out) as f:
        cli = json.load(f)
    name = "dbsr_default_synthetic"
    assert set(cli) == {"psnr", "ssim"} and np.isfinite(cli["psnr"][name])
    assert "[timing] dbsr_default_synthetic: 1 bursts" in \
        capsys.readouterr().out
    monkeypatch.setenv("DBSR_TPU_BURSTSR_DIR", root)
    out_dir = tmp_path / "saved"
    run_evaluation.main(["burstsr", "save_results", "dbsr_default",
                         "--out_dir", str(out_dir), "--device", "cpu"])
    assert (out_dir / name / "0008_0001.png").exists()
