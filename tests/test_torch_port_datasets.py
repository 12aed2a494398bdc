"""The port's image datasets and JPEG binding against the JAX package on CPU:
``ZurichRAW2RGB`` and ``ImageFolder`` on fixture trees written here with PIL
(JPEG and 8-bit PNG, RGB, greyscale and RGBA), bit-equal arrays; the native
libjpeg binding (``utils/native_io.py``) bit-equal to the JAX package's
``read_jpeg``; the error when nothing can decode a file; ``make_data``'s
Zurich branch; ``generate_synthetic_burst_val --source_dir``'s crops equal
to the JAX script's sequence. No Zurich RAW2RGB data is in the repository:
every tree is a fixture.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from dbsr_tpu.data import datasets as jds
from dbsr_tpu.data import pipeline as jpipe
from dbsr_tpu.utils import native_io as jax_native_io
from dbsr_tpu_torch import generate_synthetic_burst_val as gen
from dbsr_tpu_torch.configs.dbsr import default_synthetic as config
from dbsr_tpu_torch.data import datasets
from dbsr_tpu_torch.data.pipeline import CropBatcher
from dbsr_tpu_torch.data.procedural import make_generator
from dbsr_tpu_torch.data.synthetic import BurstConfig
from dbsr_tpu_torch.environment import Settings
from dbsr_tpu_torch.utils import native_io
from dbsr_tpu_torch.utils.png16 import write_png


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this module runs (the suite runs
    in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(seed, hw=(50, 60)):
    """A smooth RGB image with edges, uint8."""
    rng = np.random.RandomState(seed)
    low = rng.rand(hw[0] // 5 + 1, hw[1] // 5 + 1, 3)
    img = np.kron(low, np.ones((5, 5, 1)))[:hw[0], :hw[1]]
    return (img * 255).astype(np.uint8)


def _zurich_tree(root, n_train=5, n_test=2, hw=(50, 60)):
    for split, n in (("train", n_train), ("test", n_test)):
        d = os.path.join(root, split, "canon")
        os.makedirs(d)
        for i in range(n):
            Image.fromarray(_image(100 * (split == "test") + i, hw)).save(
                os.path.join(d, f"{i}.jpg"), quality=90)
    return root


@pytest.fixture
def folder(tmp_path):
    """A folder of PIL-written images: JPEGs (RGB, greyscale), 8-bit PNGs
    (RGB, greyscale, RGBA, palette) and a BMP."""
    d = tmp_path / "imgs"
    d.mkdir()
    Image.fromarray(_image(1)).save(d / "a.jpg", quality=85)
    Image.fromarray(_image(2)[..., 0]).save(d / "b.jpeg")
    Image.fromarray(_image(3)).save(d / "c.png")
    Image.fromarray(_image(4)[..., 1]).save(d / "d.png")
    Image.fromarray(np.concatenate([_image(5), _image(6)[..., :1]], -1),
                    "RGBA").save(d / "e.png")
    Image.fromarray(_image(7)).convert("P").save(d / "f.png")
    Image.fromarray(_image(8)).save(d / "g.bmp")
    (d / "notes.txt").write_text("not an image")
    return str(d)


def test_native_jpeg_is_bit_equal_to_jax_and_pil(folder):
    if not native_io.native_available():
        pytest.skip("the native JPEG decoder does not build here (it needs "
                    "g++ and libjpeg)")
    for name in ("a.jpg", "b.jpeg"):
        path = os.path.join(folder, name)
        got = native_io.read_jpeg(path)
        assert got.dtype == np.uint8 and got.shape == (50, 60, 3)
        np.testing.assert_array_equal(got, jax_native_io.read_jpeg(path))
        with Image.open(path) as im:
            np.testing.assert_array_equal(got, np.asarray(im.convert("RGB")))
    assert os.path.dirname(native_io._LIB_PATH).endswith("_native_build")


def test_image_folder_is_bit_equal_to_jax(folder):
    got, want = datasets.ImageFolder(folder), jds.ImageFolder(folder)
    assert got.image_list == want.image_list == [
        "a.jpg", "b.jpeg", "c.png", "d.png", "e.png", "f.png", "g.bmp"]
    assert len(got) == got.get_num_images() == 7
    for i in range(len(got)):
        g, info = got.get_image(i)
        w, _ = want.get_image(i)
        assert info == {} and g.dtype == np.uint8 and g.shape == (50, 60, 3)
        np.testing.assert_array_equal(g, w, err_msg=got.image_list[i])
    assert got.get_image(0, info={"k": 1})[1] == {"k": 1}


def test_zurich_tree_is_bit_equal_to_jax_and_trusts_a_partial_listing(
        tmp_path):
    root = _zurich_tree(str(tmp_path / "zurich"))
    for split, n in (("train", 5), ("test", 2)):
        got, want = (datasets.ZurichRAW2RGB(root, split),
                     jds.ZurichRAW2RGB(root, split))
        assert got.get_num_images() == want.get_num_images() == n
        assert got.image_list == want.image_list
        for i in range(n):
            np.testing.assert_array_equal(got.get_image(i)[0],
                                          want.get_image(i)[0])
    assert datasets.ZurichRAW2RGB(str(tmp_path / "none")).get_num_images() \
        == 46839
    assert datasets.ZurichRAW2RGB(root, "test").get_name() == "ZurichRAW2RGB"
    with pytest.raises(ValueError, match="unknown split"):
        datasets.ZurichRAW2RGB(root, "val")


def test_load_image_names_what_is_missing(folder, monkeypatch):
    """Without the native decoder and without PIL, a JPEG and a BMP raise an
    error naming both; an 8-bit PNG still loads through png16; a 16-bit
    PNG is refused."""
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_error", "g++ is not installed")
    with pytest.raises(RuntimeError, match="native JPEG decoder is "
                       "unavailable.*g\\+\\+ is not installed.*PIL is not "
                       "installed"):
        datasets._load_image(os.path.join(folder, "a.jpg"))
    with pytest.raises(RuntimeError, match="no decoder of the port reads "
                       ".bmp.*PIL is not installed"):
        datasets._load_image(os.path.join(folder, "g.bmp"))
    with pytest.raises(RuntimeError, match="palette.*PIL is not installed"):
        datasets._load_image(os.path.join(folder, "f.png"))
    png = datasets._load_image(os.path.join(folder, "c.png"))
    np.testing.assert_array_equal(png, _image(3))
    path16 = os.path.join(folder, "deep.png")
    write_png(path16, np.zeros((4, 4, 3), np.uint16))
    with pytest.raises(ValueError, match="16-bit PNG"):
        datasets._load_image(path16)


def test_make_data_zurich_branch(tmp_path, monkeypatch):
    """A staged Zurich tree: host ``CropBatcher``s on its train and test
    splits, seeded ``seed`` and ``seed + 1``, uint8 crops through
    ``device_put`` (tensors on the CPU here), and the prepare step that
    casts them to [0, 1] and synthesizes: the batches equal the JAX
    package's for the same seed."""
    root = _zurich_tree(str(tmp_path / "zurich"), hw=(48, 56))
    monkeypatch.setenv("DBSR_TPU_ENV", str(tmp_path / "env.json"))
    monkeypatch.setenv("DBSR_TPU_ZURICHRAW2RGB_DIR", root)
    settings = Settings()
    settings.batch_size, settings.seed = 2, 3
    assert settings.env.zurichraw2rgb_dir == root
    cfg = BurstConfig(burst_size=3, crop_sz=(32, 32), border_crop=4,
                      max_translation=3.0, fused_resample=True)
    loaders, prepare, put = config.make_data(settings, cfg, 4, "cpu",
                                             val_batches=2, val_interval=5)
    train, val = loaders
    assert (train.training, val.training, val.epoch_interval) == \
        (True, False, 5)
    assert isinstance(train.batcher, CropBatcher) and len(train.batcher) == 4
    assert len(val.batcher) == 2
    for spec, split, seed, n in ((train, "train", 3, 4), (val, "test", 4, 2)):
        want = jpipe.CropBatcher(jpipe.RandomImageSampler(
            [jds.ZurichRAW2RGB(root, split)], [1.0], samples_per_epoch=2 * n),
            2, cfg.pre_crop_sz, random_flip=True, seed=seed)
        for _ in range(2):
            np.testing.assert_array_equal(spec.batcher.next_batch(),
                                          want.next_batch())
    crops = put(train.batcher.next_batch())
    assert torch.is_tensor(crops) and crops.dtype == torch.uint8
    batch = prepare(make_generator("cpu", 1), crops)
    assert batch["burst"].shape == (2, 3, 4, 4, 4)
    assert batch["frame_gt"].shape == (2, 32, 32, 3)
    assert 0.0 <= float(batch["frame_gt"].min()) \
        and float(batch["frame_gt"].max()) <= 1.0


def test_source_dir_crops_equal_the_jax_scripts(tmp_path):
    """The generator's ``--source_dir`` images and crops follow the JAX
    script's ``rng`` sequence (an image too small for the crop skips its
    burst), on a folder of 8-bit PNGs."""
    d = tmp_path / "src"
    d.mkdir()
    for i, hw in enumerate(((70, 80), (40, 90), (64, 64), (90, 70))):
        write_png(str(d / f"{i}.png"), _image(i, hw))
    cfg = BurstConfig(burst_size=3, crop_sz=(48, 48), border_crop=4)
    got = list(gen.source_crops(datasets.ImageFolder(str(d)), 9, cfg,
                                seed=5))
    ds = jds.ImageFolder(str(d))
    rng = np.random.default_rng(5)
    want = []
    for i in range(9):                   # util_scripts' loop, as written
        idx = int(rng.integers(0, len(ds)))
        frame = ds.get_image(idx)[0].astype(np.float32) / 255.0
        if min(frame.shape[:2]) < max(cfg.pre_crop_sz):
            continue
        want.append((i, jpipe.random_resized_crop(rng, frame,
                                                  cfg.pre_crop_sz)))
    assert [i for i, _ in got] == [i for i, _ in want] and len(got) < 9
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_source_dir_generates_a_set_from_an_image_folder(tmp_path):
    """``main(["--source_dir", ...])`` on the CPU at a small size reads the
    folder through ``ImageFolder`` and writes a set the reader reads."""
    d = tmp_path / "src"
    d.mkdir()
    for i in range(2):
        write_png(str(d / f"{i}.png"), _image(i, (60, 60)))
    cfg = BurstConfig(burst_size=3, crop_sz=(32, 32), border_crop=4,
                      downsample_factor=4, max_translation=2.0)
    out = str(tmp_path / "set")
    gen.generate(out, 2, None, cfg, seed=1, device="cpu",
                 source_dir=str(d))
    ds = datasets.SyntheticBurstVal(out, burst_size=3)
    assert len(ds) == 2
    burst, gt, meta = ds[1]
    assert burst.shape == (3, 4, 4, 4) and gt.shape == (32, 32, 3)
    assert meta["burst_name"] == "0001"
