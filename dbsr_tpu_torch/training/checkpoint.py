"""Read the JAX package's checkpoints and rebuild the network from them
(port of ``dbsr_tpu/training/checkpoint.py:198-237,267-299``).

A checkpoint is ``b"DBSRTPU1"``, a little-endian ``uint64`` header length,
a JSON header (epoch, stats, settings, ``net_spec``), then a flax msgpack
blob of the state tree. The blob is decoded by :func:`msgpack_unpack`, a
small pure-Python msgpack reader, so the port needs neither ``msgpack`` nor
``flax``. flax stores each ndarray as msgpack ext type 1 whose payload is
the msgpack array ``[shape, dtype_name, raw_bytes]`` (C order), and arrays
above 2**30 bytes as ``{'__msgpack_chunked_array__': True, 'shape': {...},
'chunks': {...}}`` dicts.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, Tuple

import numpy as np

from dbsr_tpu_torch import resolve_device
from dbsr_tpu_torch.models.dbsr import DBSRNet
from dbsr_tpu_torch.utils.convert import params_from_flax

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


def read_checkpoint(path: str) -> Tuple[dict, Dict[str, Any]]:
    """``(header, state tree)``, the tree a nested dict of numpy arrays."""
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path}: not a dbsr_tpu checkpoint")
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode())
        blob = f.read()
    return header, msgpack_unpack(blob)


# net_spec (module, cls) of the JAX package -> the port's class
_NETWORKS = {("dbsr_tpu.models.dbsr", "DBSRNet"): DBSRNet}


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
