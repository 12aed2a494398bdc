"""ctypes binding of the repository's native JPEG decoder
(``native/dbsr_io.cpp``, libjpeg): ``read_jpeg(path)`` -> ``[H, W, 3]``
uint8 RGB.

The shared library is built from that source, as it is, at first use:
``g++ -O3 -std=c++17 -fPIC -shared ... -lz -ljpeg -lpthread`` into
``dbsr_tpu_torch/utils/_native_build/`` (git-ignored; the source tree's
``native/`` is never written). Building needs ``g++`` with libjpeg's and
zlib's headers and libraries on the host; without them ``read_jpeg``
raises :class:`NativeUnavailable`, which names what failed.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "dbsr_io.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_native_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libdbsr_io.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


class NativeUnavailable(RuntimeError):
    """The native decoder could not be built or loaded on this host."""


def _build() -> None:
    if not os.path.exists(_SOURCE):
        raise NativeUnavailable(f"no native source at {_SOURCE}")
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeUnavailable("g++ is not installed")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # build under a name of this process's own, then rename: processes that
    # build at once never load a half-written library
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    out = subprocess.run(
        [cxx, "-O3", "-std=c++17", "-fPIC", "-shared", "-o", tmp, _SOURCE,
         "-lz", "-ljpeg", "-lpthread"], capture_output=True, text=True)
    if out.returncode != 0:
        raise NativeUnavailable(
            "building native/dbsr_io.cpp failed (it needs libjpeg's and "
            f"zlib's headers and libraries): {out.stderr.strip()[-400:]}")
    os.replace(tmp, _LIB_PATH)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at first use; raises
    :class:`NativeUnavailable` (every call, with the first cause) when it
    cannot be had."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise NativeUnavailable(_error)
        try:
            if not os.path.exists(_LIB_PATH):
                _build()
            lib = ctypes.CDLL(_LIB_PATH)
        except (NativeUnavailable, OSError) as e:
            _error = str(e)
            raise NativeUnavailable(_error) from e
        lib.dbsr_jpeg_info.restype = ctypes.c_int
        lib.dbsr_jpeg_info.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.dbsr_jpeg_decode.restype = ctypes.c_int
        lib.dbsr_jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    try:
        get_lib()
        return True
    except NativeUnavailable:
        return False


def read_jpeg(path: str) -> np.ndarray:
    """Decode a JPEG to ``[H, W, 3]`` uint8 RGB with libjpeg."""
    lib = get_lib()
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
