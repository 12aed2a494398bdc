"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). Libraries are built at first
use into ``_build/<hash>/``, where ``<hash>`` covers the sources and flags,
so a changed source is rebuilt and a stale library is never loaded.
:func:`build` compiles several sources in parallel, one ``nvcc`` each.

C entries take device pointers, ``int`` sizes and the CUDA stream, launch
on that stream, allocate nothing, and return ``cudaGetLastError()``;
:func:`launch` raises when that is not ``cudaSuccess``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = ("warp", "correlation", "merge", "resample", "warp_bwd", "merge_bwd",
           "correlation_bwd", "conv_s2d", "conv_s2d_dweight",
           "dead_leaves")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# (library, entry) -> (the library, the entry with its types set)
_BOUND: Dict[Tuple[str, str], Tuple[ctypes.CDLL, Any]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return path


def build_dir() -> Path:
    """Directory of the libraries for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile the missing libraries of ``names``, all ``nvcc`` processes
    started together; returns the wall seconds. Raises with the compiler's
    output if any build fails. ``nvcc``'s report (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside each library as ``<lib>.log``."""
    t0 = time.perf_counter()
    out_dir = build_dir()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return time.perf_counter() - t0
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        (out_dir / f"lib{name}.so.log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc rc {proc.returncode}):\n"
                          + log.decode(errors="replace"))
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    p = build_dir() / f"lib{name}.so.log"
    return p.read_text(errors="replace") if p.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.dbsr_error_string.argtypes = [ctypes.c_int]
        lib.dbsr_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


# the C entry's suffix for each element type a kernel has an instantiation of
DTYPE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def entry(op: str, fn: str, dtype: torch.dtype) -> str:
    """The C entry of ``fn`` for ``dtype`` (``dbsr_warp`` and bfloat16 ->
    ``dbsr_warp_bf16``); raise for a type that has none."""
    suffix = DTYPE_SUFFIX.get(dtype)
    if suffix is None:
        raise TypeError(f"{op}: kernel takes "
                        f"{' or '.join(map(str, DTYPE_SUFFIX))}, got {dtype}")
    return f"{fn}_{suffix}"


def require_cuda(op: str, *tensors: torch.Tensor,
                 dtypes: Sequence[torch.dtype] = ()) -> None:
    """Raise unless every tensor is a contiguous, 16-byte-aligned CUDA tensor
    on one device, of its type in ``dtypes`` (one per tensor; float32 for
    all when empty): what the kernels take."""
    dtypes = tuple(dtypes) or (torch.float32,) * len(tensors)
    if len(dtypes) != len(tensors):
        raise ValueError(f"{op}: {len(dtypes)} dtypes for {len(tensors)} "
                         "tensors")
    dev = tensors[0].device
    for t, dtype in zip(tensors, dtypes):
        if t.device.type != "cuda":
            raise ValueError(f"{op}: expected a CUDA or CPU tensor, got "
                             f"{t.device}")
        if t.device != dev:
            raise ValueError(f"{op}: tensors on {dev} and {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{op}: kernel takes {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: kernel takes contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: kernel takes 16-byte-aligned tensors")


def launch(lib_name: str, fn_name: str, tensors: Sequence[torch.Tensor],
           ints: Sequence[int]) -> None:
    """Call C entry ``fn_name(ptrs..., ints..., stream)`` of library
    ``lib_name`` on the current stream of the tensors' device, with that
    device current for the call (the C entry launches, and sets kernel
    attributes, on the CUDA runtime's current device); raise on a CUDA error
    from the launch. The device is switched only when another one is
    current, and the previous one is current again afterwards, also when
    the entry fails. The entry's ``argtypes`` and ``restype`` are set at its
    first call only: a later call costs the host the int checks, the
    device check, the pointers, the stream and the call."""
    bound = _BOUND.get((lib_name, fn_name))
    if bound is None:
        lib = library(lib_name)
        fn = getattr(lib, fn_name)
        fn.argtypes = ([ctypes.c_void_p] * len(tensors)
                       + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        bound = _BOUND[(lib_name, fn_name)] = (lib, fn)
    lib, fn = bound
    for v in ints:
        if not 0 <= v < 2 ** 31:
            raise ValueError(f"{fn_name}: size {v} out of int32 range")
    device = tensors[0].device
    stream = torch.cuda.current_stream(device).cuda_stream
    args = (*[t.data_ptr() for t in tensors], *ints, stream)
    # an index of None is the current device ("cuda")
    prev = None if device.index is None else torch.cuda.current_device()
    if prev is None or prev == device.index:
        err = fn(*args)
    else:
        torch.cuda.set_device(device.index)
        try:
            err = fn(*args)
        finally:
            torch.cuda.set_device(prev)
    if err != 0:
        msg = lib.dbsr_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{fn_name}: CUDA error {err} ({msg})")
