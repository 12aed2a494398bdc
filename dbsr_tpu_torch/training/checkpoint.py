"""Checkpoints of the JAX package's format, read and written by the port
(port of ``dbsr_tpu/training/checkpoint.py:77-101,198-299``).

A checkpoint is ``b"DBSRTPU1"``, a little-endian ``uint64`` header length,
a JSON header (epoch, net_name, stats, settings, ``net_spec``), then a flax
msgpack blob of the state tree. The blob is decoded by :func:`msgpack_unpack`
and encoded by :func:`msgpack_pack`, a small pure-Python msgpack reader and
writer, so the port needs neither ``msgpack`` nor ``flax``. flax stores each
ndarray as msgpack ext type 1 whose payload is the msgpack array
``[shape, dtype_name, raw_bytes]`` (C order), and arrays above 2**30 bytes
as ``{'__msgpack_chunked_array__': True, 'shape': {...}, 'chunks': {...}}``
dicts (read only; the port's arrays are far smaller).

The port writes ``{"params": {"params": <flax tree>}, "opt_state": {"count",
"mu", "nu"}, "step"}``: the parameters in the JAX package's layout (its
``load_network`` rebuilds and runs a port-trained net from the ``net_spec``),
and the port's own Adam moments under the same flax paths (the trainable
parameters only).
"""

from __future__ import annotations

import glob
import json
import os
import re
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dbsr_tpu_torch import resolve_device
from dbsr_tpu_torch.models.align_lite import BurstAlignLite
from dbsr_tpu_torch.models.dbsr import DBSRNet
from dbsr_tpu_torch.utils.convert import params_from_flax, params_to_flax

_MAGIC = b"DBSRTPU1"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """Decoder of one msgpack document held in ``buf``."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {  # code: (kind, length format)
            0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
        }
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "ext":
                return self.ext(n)
            return getattr(self, kind)(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype, raw = msgpack_unpack(data, flax_tree=False)
            arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
            return arr if code == _EXT_NDARRAY else arr[()]
        if code == _EXT_COMPLEX:
            re, im = msgpack_unpack(data, flax_tree=False)
            return complex(re, im)
        raise ValueError(f"msgpack: unknown ext type {code}")


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_unpack(blob: bytes, flax_tree: bool = True) -> Any:
    """Decode one msgpack document (maps, arrays, str, bin, ints, floats,
    nil/bool, ext). With ``flax_tree`` (the default), flax's chunked arrays
    are joined back, as ``flax.serialization.msgpack_restore`` does."""
    reader = _Reader(blob)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("msgpack: trailing bytes after the document")
    return _unchunk(out) if flax_tree else out


_WIDTHS = ((">B", 1 << 8), (">H", 1 << 16), (">I", 1 << 32))


def _pack_len(out: bytearray, n: int, fix: Optional[int], fix_max: int,
              codes: Tuple[Optional[int], int, int]) -> None:
    """Type byte and length: the fix form (``fix | n``) below ``fix_max``,
    else the 8/16/32-bit form of ``codes`` (None where msgpack has no 8-bit
    form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, (fmt, limit) in zip(codes, _WIDTHS):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        if 0 <= obj < 0x80 or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        elif obj >= 0:
            for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"),
                              (0xCF, ">Q")):
                if obj < 1 << (8 * struct.calcsize(fmt)):
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    return
            raise ValueError(f"msgpack: int {obj} too large")
        else:
            for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"),
                              (0xD3, ">q")):
                if obj >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    return
            raise ValueError(f"msgpack: int {obj} too small")
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        payload = msgpack_pack([list(arr.shape), arr.dtype.name,
                                arr.tobytes("C")])
        code = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(payload) in fixext:
            out.append(fixext[len(payload)])
        else:
            _pack_len(out, len(payload), None, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", code)
        out += payload
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def msgpack_pack(obj: Any) -> bytes:
    """Encode ``obj`` (dicts, lists/tuples, str, bytes, int, float, bool,
    None, numpy arrays and scalars) as one msgpack document, numpy values
    as flax's ext types; the inverse of :func:`msgpack_unpack`."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def read_header(path: str) -> dict:
    """The JSON header alone."""
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path}: not a dbsr_tpu checkpoint")
        (hlen,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(hlen).decode())


def read_checkpoint(path: str) -> Tuple[dict, Dict[str, Any]]:
    """``(header, state tree)``, the tree a nested dict of numpy arrays."""
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path}: not a dbsr_tpu checkpoint")
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode())
        blob = f.read()
    return header, msgpack_unpack(blob)


def write_checkpoint(path: str, header: dict, tree: Any) -> str:
    """Write ``header`` and ``tree`` atomically (tmp file + rename)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    header_bytes = json.dumps(header).encode()
    blob = msgpack_pack(tree)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(header_bytes)))
        f.write(header_bytes)
        f.write(blob)
    os.replace(tmp, path)
    return path


def network_spec(net) -> Dict[str, Any]:
    """The JAX package's ``net_spec`` of a port network (``DBSRNet``,
    ``BurstAlignLite``): the JAX module's path and class (``net.jax_spec``)
    and the constructor kwargs (dtypes as ``{"__dtype__": name}``), so
    ``dbsr_tpu.training.checkpoint.load_network`` rebuilds it."""
    kwargs = {}
    for k, v in net.spec_kwargs.items():
        if isinstance(v, torch.dtype):
            v = {"__dtype__": str(v).replace("torch.", "")}
        kwargs[k] = v
    module, cls = net.jax_spec
    return {"module": module, "cls": cls, "kwargs": kwargs}


def save_checkpoint(directory: str, net_name: str, epoch: int, state,
                    stats: Optional[dict] = None,
                    settings: Optional[dict] = None) -> str:
    """Atomically write ``<directory>/<net_name>_ep{epoch:04d}.ckpt`` from a
    ``training.state.TrainState``: parameters, Adam moments and step."""
    header = {"epoch": int(epoch), "net_name": net_name,
              "stats": stats or {}, "settings": settings or {},
              "net_spec": network_spec(state.net)}
    opt = state.opt_state()
    tree = {"params": {"params": params_to_flax(state.net.state_dict())},
            "opt_state": {"count": int(opt["count"]),
                          "mu": params_to_flax(opt["mu"]),
                          "nu": params_to_flax(opt["nu"])},
            "step": int(state.step)}
    return write_checkpoint(
        os.path.join(directory, f"{net_name}_ep{epoch:04d}.ckpt"), header,
        tree)


def list_checkpoints(directory: str, net_name: str) -> List[Tuple[int, str]]:
    """Sorted ``(epoch, path)`` pairs of ``net_name`` in ``directory``."""
    out = []
    for p in glob.glob(os.path.join(directory, f"{net_name}_ep*.ckpt")):
        m = re.search(r"_ep(\d+)\.ckpt$", p)
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out)


def resolve_checkpoint(directory: str, net_name: str,
                       epoch: Optional[int] = None) -> Optional[str]:
    """The latest checkpoint (``epoch=None``) or that of ``epoch``; None
    when there is none."""
    ckpts = list_checkpoints(directory, net_name)
    if not ckpts:
        return None
    if epoch is None:
        return ckpts[-1][1]
    for e, p in ckpts:
        if e == epoch:
            return p
    raise FileNotFoundError(
        f"no checkpoint for epoch {epoch} of {net_name} in {directory}")


def load_train_state(path: str, state) -> dict:
    """Restore ``state`` (a ``training.state.TrainState``) in place from a
    checkpoint that :func:`save_checkpoint` wrote: parameters, Adam moments
    and the step. Returns the header."""
    header, tree = read_checkpoint(path)
    state.net.load_state_dict(params_from_flax(tree["params"]), strict=True)
    opt = tree["opt_state"]
    state.load_opt_state({"mu": params_from_flax(opt["mu"]),
                          "nu": params_from_flax(opt["nu"]),
                          "count": int(opt["count"])}, int(tree["step"]))
    return header


# net_spec (module, cls) of the JAX package -> the port's class
_NETWORKS = {cls.jax_spec: cls for cls in (DBSRNet, BurstAlignLite)}


def load_network(path: str, device="cuda", **kwarg_overrides):
    """Rebuild ``(net, header)`` from a checkpoint alone: the network named
    by the header's ``net_spec`` with its recorded kwargs (``overrides``
    win), the checkpoint's parameters loaded, in eval mode on ``device``."""
    dev = resolve_device(device)
    header, state = read_checkpoint(path)
    spec = header.get("net_spec")
    if spec is None:
        raise ValueError(f"{path} has no net_spec; cannot rebuild network")
    cls = _NETWORKS.get((spec["module"], spec["cls"]))
    if cls is None:
        raise ValueError(f"{path}: network {spec['module']}.{spec['cls']} is "
                         "not ported")
    kwargs = dict(spec["kwargs"])
    for k, v in kwargs.items():
        if isinstance(v, dict) and "__dtype__" in v:
            kwargs[k] = v["__dtype__"]
    kwargs.update(kwarg_overrides)
    net = cls(**kwargs)
    params = state["params"] if "params" in state else state
    net.load_state_dict(params_from_flax(params), strict=True)
    return net.to(dev).eval(), header
