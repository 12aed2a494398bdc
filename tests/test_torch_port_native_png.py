"""The PNG half of the port's native IO binding (``utils/native_io.py`` on
its copy of the source, ``utils/csrc/dbsr_io.cpp``) against the JAX
package's ``native_io`` and the port's pure-Python ``png16``: ``read_png``
(8- and 16-bit; 1, 2, 3 and 4 channels; files written by png16 and by PIL,
whose 8-bit writer filters its rows), ``load_burst``, ``load_jpeg_batch``,
the fallbacks (no library at all: png16 and PIL; a library built without
libjpeg, as on a host with no ``jpeglib.h``), and the BurstSR reader and
``ImageFolder`` through either path. Every comparison is bit for bit.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
from PIL import Image

from dbsr_tpu.utils import native_io as jax_native_io
from dbsr_tpu_torch.data import burstsr, datasets
from dbsr_tpu_torch.utils import native_io, png16


@pytest.fixture
def no_native(monkeypatch):
    """The library unavailable, as on a host without g++ or zlib."""
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_error", "g++ is not installed")


def _arrays():
    rng = np.random.RandomState(11)
    out = {}
    for depth, dtype in ((8, np.uint8), (16, np.uint16)):
        hi = np.iinfo(dtype).max
        for c in (1, 2, 3, 4):
            out[f"png16_{depth}bit_{c}ch"] = rng.randint(
                0, hi + 1, (23, 37, c)).astype(dtype)
    return out


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """PNGs written by png16 (every depth and channel count) and by PIL
    (8-bit grey, RGB and RGBA with filtered rows; 16-bit grey)."""
    d = tmp_path_factory.mktemp("png")
    want = {}
    for name, a in _arrays().items():
        png16.write_png(str(d / f"{name}.png"), a)
        want[name] = a
    rng = np.random.RandomState(12)
    smooth = (np.cumsum(rng.randint(0, 5, (31, 29, 4)), axis=1) % 256
              ).astype(np.uint8)
    for mode, sl in (("L", np.s_[..., 0]), ("RGB", np.s_[..., :3]),
                     ("RGBA", np.s_[...])):
        Image.fromarray(smooth[sl], mode).save(d / f"pil_{mode}.png")
        want[f"pil_{mode}"] = smooth[sl].reshape(31, 29, -1)
    deep = (rng.randint(0, 2 ** 16, (19, 21))).astype(np.uint16)
    Image.fromarray(deep).save(d / "pil_I16.png")
    want["pil_I16"] = deep[..., None]
    return {k: str(d / (k + ".png")) for k in want}, want


def test_read_png_is_bit_equal_to_jax_and_png16(pngs):
    paths, want = pngs
    assert native_io.native_available() and native_io.png_path() == "native"
    for k, path in paths.items():
        got = native_io.read_png(path)
        assert got.dtype == want[k].dtype and got.shape == want[k].shape, k
        np.testing.assert_array_equal(got, want[k], err_msg=k)
        np.testing.assert_array_equal(got, jax_native_io.read_png(path),
                                      err_msg=k)
        np.testing.assert_array_equal(got, png16.read_png(path), err_msg=k)
    assert os.path.dirname(native_io._LIB_PATH).endswith("_native_build")


def test_read_png_falls_back_to_png16(pngs, no_native):
    paths, want = pngs
    assert not native_io.native_available()
    assert native_io.png_path() == "png16"
    for k, path in paths.items():
        np.testing.assert_array_equal(native_io.read_png(path), want[k],
                                      err_msg=k)


@pytest.mark.parametrize("threads", [0, 1, 3])
def test_load_burst_is_bit_equal_to_jax_and_png16(tmp_path, threads):
    rng = np.random.RandomState(13)
    frames = rng.randint(0, 2 ** 14, (14, 24, 20, 4)).astype(np.uint16)
    paths = []
    for i, f in enumerate(frames):
        paths.append(str(tmp_path / f"im_raw_{i:02d}.png"))
        png16.write_png(paths[-1], f)
    got = native_io.load_burst(paths, num_threads=threads)
    assert got.dtype == np.uint16 and got.shape == frames.shape
    np.testing.assert_array_equal(got, frames)
    np.testing.assert_array_equal(
        got, jax_native_io.load_burst(paths, num_threads=threads))
    np.testing.assert_array_equal(native_io.load_burst(paths[:1]),
                                  frames[:1])


def test_load_burst_falls_back_and_names_a_bad_frame(tmp_path, monkeypatch):
    """A frame of another size is refused by its index before it is
    decoded (the repository's source decodes it into the shared buffer
    first and overruns it); without the library, png16 frames."""
    rng = np.random.RandomState(14)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"{i}.png"))
        png16.write_png(paths[-1], rng.randint(0, 256, (8, 9, 3)).astype(
            np.uint8))
    png16.write_png(str(tmp_path / "odd.png"), np.zeros((8, 10, 3), np.uint8))
    with pytest.raises(ValueError, match="file index 1"):
        native_io.load_burst([paths[0], str(tmp_path / "odd.png")])
    want = native_io.load_burst(paths)
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_error", "no zlib")
    np.testing.assert_array_equal(native_io.load_burst(paths), want)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpg")
    rng = np.random.RandomState(15)
    paths = []
    for i in range(4):
        im = (np.cumsum(rng.randint(0, 9, (26, 34, 3)), axis=0) % 256
              ).astype(np.uint8)
        paths.append(str(d / f"{i}.jpg"))
        Image.fromarray(im).save(paths[-1], quality=85)
    return paths


@pytest.mark.parametrize("threads", [0, 2])
def test_load_jpeg_batch_is_bit_equal_to_jax(jpegs, threads):
    got = native_io.load_jpeg_batch(jpegs, num_threads=threads)
    assert got.shape == (4, 26, 34, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(
        got, jax_native_io.load_jpeg_batch(jpegs, num_threads=threads))
    for p, g in zip(jpegs, got):
        np.testing.assert_array_equal(g, native_io.read_jpeg(p))


def test_load_jpeg_batch_falls_back_to_pil(jpegs, no_native):
    want = jax_native_io.load_jpeg_batch(jpegs)
    np.testing.assert_array_equal(native_io.load_jpeg_batch(jpegs), want)
    with pytest.raises(native_io.NativeUnavailable, match="g\\+\\+"):
        native_io.read_jpeg(jpegs[0])


def test_the_png_half_builds_without_libjpeg(tmp_path, pngs, jpegs,
                                             monkeypatch):
    """``-DDBSR_IO_NO_JPEG``, zlib alone (the card's host has no
    ``jpeglib.h``): ``dbsr_io_has_jpeg()`` 0, the same PNG arrays, JPEGs
    refused by ``read_jpeg`` and decoded by PIL in ``load_jpeg_batch``."""
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    lib_path = str(tmp_path / "libdbsr_io_png.so")
    out = subprocess.run(
        ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-DDBSR_IO_NO_JPEG",
         "-o", lib_path, native_io._SOURCE, "-lz", "-lpthread"],
        capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert ctypes.CDLL(lib_path).dbsr_io_has_jpeg() == 0
    assert not hasattr(ctypes.CDLL(lib_path), "dbsr_jpeg_decode")
    monkeypatch.setattr(native_io, "_LIB_PATH", lib_path)
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_error", None)
    monkeypatch.setattr(native_io, "_jpeg_error", None)
    assert native_io.native_available() and not native_io.jpeg_available()
    paths, want = pngs
    for k, path in paths.items():
        np.testing.assert_array_equal(native_io.read_png(path), want[k],
                                      err_msg=k)
    with pytest.raises(native_io.NativeUnavailable, match="without libjpeg"):
        native_io.read_jpeg(jpegs[0])
    np.testing.assert_array_equal(native_io.load_jpeg_batch(jpegs),
                                  jax_native_io.load_jpeg_batch(jpegs))


@pytest.mark.parametrize("path", ["native", "png16"])
def test_burstsr_reader_is_bit_equal_through_either_path(tmp_path, path,
                                                         monkeypatch):
    """The BurstSR val protocol's samples through the native decoder and
    through png16, against the JAX package's reader."""
    from dbsr_tpu.data import burstsr as jax_burstsr
    from dbsr_tpu_torch.data.make_synthetic_burstsr import generate_dataset

    root = str(tmp_path / "bsr")
    generate_dataset(root, bursts=2, lr=32, n_frames=5, split="val",
                     device="cpu")
    if path == "png16":
        monkeypatch.setattr(native_io, "_lib", None)
        monkeypatch.setattr(native_io, "_error", "no zlib")
    got, want = burstsr.get_burstsr_val_set(root), \
        jax_burstsr.get_burstsr_val_set(root)
    for i in range(2):
        g, w = got[i], want[i]
        for k in ("burst", "frame_gt"):
            np.testing.assert_array_equal(g[k], np.asarray(w[k]),
                                          err_msg=f"{i} {k}")


@pytest.mark.parametrize("path", ["native", "png16"])
def test_image_folder_is_bit_equal_through_either_path(tmp_path, path,
                                                       monkeypatch):
    from dbsr_tpu.data import datasets as jds

    rng = np.random.RandomState(16)
    for i, c in enumerate((1, 2, 3, 4)):
        im = (np.cumsum(rng.randint(0, 7, (20, 30, c)), axis=1) % 256
              ).astype(np.uint8)
        Image.fromarray(im if c > 1 else im[..., 0],
                        {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[c]).save(
            tmp_path / f"{i}.png")
    if path == "png16":
        monkeypatch.setattr(native_io, "_lib", None)
        monkeypatch.setattr(native_io, "_error", "no zlib")
    got, want = datasets.ImageFolder(str(tmp_path)), \
        jds.ImageFolder(str(tmp_path))
    for i in range(4):
        np.testing.assert_array_equal(got.get_image(i)[0],
                                      want.get_image(i)[0])
        assert got.get_image_shape(i) == (20, 30)
