"""ctypes binding of the native IO runtime (port of
``dbsr_tpu/utils/native_io.py``), built from the port's copy of its source,
``utils/csrc/dbsr_io.cpp``:

  * ``read_png(path)`` — PNG decode (8/16-bit, 1-4 channels), falling back
    to the port's pure-Python ``utils/png16.py`` when the library cannot be
    had, as the JAX package's does;
  * ``load_burst(paths, num_threads)`` — a burst's PNGs decoded
    concurrently on native threads into one ``[N, H, W, C]`` array;
  * ``read_jpeg(path)`` / ``load_jpeg_batch(paths, num_threads)`` —
    libjpeg's RGB decode.

The library is built at first use into ``dbsr_tpu_torch/utils/_native_build/``
(git-ignored; built under a name of this process's own, then renamed into
place): ``g++ -O3 -std=c++17 -fPIC -shared ... -lz -ljpeg -lpthread``, or,
where libjpeg's header or library is missing, the PNG half alone with zlib
(``-DDBSR_IO_NO_JPEG -lz``; ``jpeg_available()`` is then False and
``read_jpeg`` raises :class:`NativeUnavailable`, which names what failed).
With neither, every call raises :class:`NativeUnavailable` but ``read_png``
and ``load_burst``, which decode with png16.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional

import numpy as np

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "dbsr_io.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_native_build")


def _lib_path() -> str:
    """The library's path, named by the source's hash: an edited source
    builds anew."""
    try:
        with open(_SOURCE, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:12]
    except OSError:
        tag = "missing"
    return os.path.join(_BUILD_DIR, f"libdbsr_io_{tag}.so")


_LIB_PATH = _lib_path()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_jpeg_error: Optional[str] = None


class NativeUnavailable(RuntimeError):
    """The native library (or its JPEG half) could not be built or loaded
    on this host."""


def _compile(cxx: str, tmp: str, jpeg: bool):
    flags = [] if jpeg else ["-DDBSR_IO_NO_JPEG"]
    libs = ["-lz", "-ljpeg", "-lpthread"] if jpeg else ["-lz", "-lpthread"]
    return subprocess.run(
        [cxx, "-O3", "-std=c++17", "-fPIC", "-shared", *flags, "-o", tmp,
         _SOURCE, *libs], capture_output=True, text=True)


def _build() -> None:
    """Build with libjpeg, else the PNG half with zlib alone."""
    if not os.path.exists(_SOURCE):
        raise NativeUnavailable(f"no native source at {_SOURCE}")
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeUnavailable("g++ is not installed")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # build under a name of this process's own, then rename: processes that
    # build at once never load a half-written library
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    out = _compile(cxx, tmp, jpeg=True)
    if out.returncode != 0:
        full = out.stderr.strip()[-400:]
        out = _compile(cxx, tmp, jpeg=False)
        if out.returncode != 0:
            raise NativeUnavailable(
                "building utils/csrc/dbsr_io.cpp failed (it needs zlib's "
                f"header and library): {out.stderr.strip()[-400:]}; with "
                f"libjpeg: {full}")
        with open(f"{_LIB_PATH}.nojpeg", "w") as f:
            f.write(full)
    os.replace(tmp, _LIB_PATH)


def _sig(fn, *argtypes):
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at first use; raises
    :class:`NativeUnavailable` (every call, with the first cause) when it
    cannot be had."""
    global _lib, _error, _jpeg_error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise NativeUnavailable(_error)
        try:
            if not os.path.exists(_LIB_PATH):
                _build()
            try:
                lib = ctypes.CDLL(_LIB_PATH)
            except OSError:
                # a library built on another machine (a copied tree) that
                # does not load here: build it anew
                _build()
                lib = ctypes.CDLL(_LIB_PATH)
        except (NativeUnavailable, OSError) as e:
            _error = str(e)
            raise NativeUnavailable(_error) from e
        i, size, p = ctypes.c_int, ctypes.c_size_t, ctypes.POINTER
        _sig(lib.dbsr_png_info, ctypes.c_char_p, size, p(i), p(i), p(i), p(i))
        _sig(lib.dbsr_png_decode, ctypes.c_char_p, size, ctypes.c_void_p)
        _sig(lib.dbsr_load_burst, p(ctypes.c_char_p), i, ctypes.c_void_p,
             size, i)
        _sig(lib.dbsr_io_has_jpeg)
        if lib.dbsr_io_has_jpeg():
            _sig(lib.dbsr_jpeg_info, ctypes.c_char_p, size, p(i), p(i), p(i))
            _sig(lib.dbsr_jpeg_decode, ctypes.c_char_p, size,
                 ctypes.c_void_p)
            _sig(lib.dbsr_load_jpeg_batch, p(ctypes.c_char_p), i,
                 ctypes.c_void_p, size, i)
        else:
            why = ""
            if os.path.exists(f"{_LIB_PATH}.nojpeg"):
                with open(f"{_LIB_PATH}.nojpeg") as f:
                    why = f.read()
            _jpeg_error = ("the native library was built without libjpeg "
                           f"(it needs jpeglib.h and libjpeg): {why}")
        _lib = lib
        return _lib


def native_available() -> bool:
    try:
        get_lib()
        return True
    except NativeUnavailable:
        return False


def jpeg_available() -> bool:
    """The library, built with its JPEG half."""
    return native_available() and _jpeg_error is None


def png_path() -> str:
    """``'native'`` or ``'png16'``: what :func:`read_png` decodes with."""
    return "native" if native_available() else "png16"


def _jpeg_lib() -> ctypes.CDLL:
    lib = get_lib()
    if _jpeg_error is not None:
        raise NativeUnavailable(_jpeg_error)
    return lib


def read_png(path: str) -> np.ndarray:
    """Decode a PNG to ``[H, W, C]`` uint8/uint16 (native fast path with
    pure-Python fallback)."""
    try:
        lib = get_lib()
    except NativeUnavailable:
        from dbsr_tpu_torch.utils.png16 import read_png as py_read
        return py_read(path)

    with open(path, "rb") as f:
        buf = f.read()
    w, h, c, d = (ctypes.c_int(), ctypes.c_int(), ctypes.c_int(),
                  ctypes.c_int())
    rc = lib.dbsr_png_info(buf, len(buf), ctypes.byref(w), ctypes.byref(h),
                           ctypes.byref(c), ctypes.byref(d))
    if rc != 0:
        raise ValueError(f"{path}: bad PNG (rc={rc})")
    dtype = np.uint16 if d.value == 16 else np.uint8
    out = np.empty((h.value, w.value, c.value), dtype)
    rc = lib.dbsr_png_decode(buf, len(buf),
                             out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"{path}: PNG decode failed (rc={rc})")
    return out


def load_burst(paths: List[str], num_threads: int = 0) -> np.ndarray:
    """Concurrently decode ``paths`` (same shape/dtype) into
    ``[N, H, W, C]``. Falls back to sequential reads without the native
    lib."""
    if not native_available():
        return np.stack([read_png(p) for p in paths])
    lib = get_lib()

    first = read_png(paths[0])
    out = np.empty((len(paths),) + first.shape, first.dtype)
    out[0] = first
    if len(paths) == 1:
        return out
    arr = (ctypes.c_char_p * len(paths))(
        *[p.encode() for p in paths])
    rc = lib.dbsr_load_burst(arr, len(paths),
                             out.ctypes.data_as(ctypes.c_void_p),
                             first.nbytes, num_threads)
    if rc != 0:
        raise ValueError(f"burst load failed (rc={rc}, "
                         f"file index {-rc - 100})")
    return out


def read_jpeg(path: str) -> np.ndarray:
    """Decode a JPEG to ``[H, W, 3]`` uint8 RGB with libjpeg."""
    lib = _jpeg_lib()
    with open(path, "rb") as f:
        buf = f.read()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.dbsr_jpeg_info(buf, len(buf), ctypes.byref(w), ctypes.byref(h),
                            ctypes.byref(c))
    if rc != 0:
        raise ValueError(f"{path}: bad JPEG (rc={rc})")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.dbsr_jpeg_decode(buf, len(buf),
                              out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"{path}: JPEG decode failed (rc={rc})")
    return out


def _read_jpeg_pil(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def load_jpeg_batch(paths: List[str], num_threads: int = 0) -> np.ndarray:
    """Concurrently decode same-sized JPEGs into ``[N, H, W, 3]`` uint8;
    without the native JPEG decoder, PIL one by one (bit-exact with the
    native path — both are libjpeg), as the JAX package falls back."""
    if not jpeg_available():
        return np.stack([_read_jpeg_pil(p) for p in paths])
    lib = _jpeg_lib()

    first = read_jpeg(paths[0])
    out = np.empty((len(paths),) + first.shape, np.uint8)
    out[0] = first
    if len(paths) == 1:
        return out
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    rc = lib.dbsr_load_jpeg_batch(arr, len(paths),
                                  out.ctypes.data_as(ctypes.c_void_p),
                                  first.nbytes, num_threads)
    if rc != 0:
        raise ValueError(f"jpeg batch load failed (rc={rc}, "
                         f"file index {-rc - 100})")
    return out
