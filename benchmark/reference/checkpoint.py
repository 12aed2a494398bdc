"""Reader of the JAX package's checkpoint files, and its parameter trees as
``state_dict``s (a frozen copy of the port's ``training/checkpoint.py``
reader and ``utils/convert.py:params_from_flax``).

A checkpoint is ``b"DBSRTPU1"``, a little-endian ``uint64`` header length,
a JSON header (epoch, net_name, settings, ``net_spec``), then a flax
msgpack blob of the state tree; flax stores each ndarray as msgpack ext
type 1 whose payload is ``[shape, dtype_name, raw_bytes]``.
"""

from __future__ import annotations

import json
import struct
from collections import OrderedDict
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

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


# modules whose ``kernel`` is a transposed conv's (PWC-Net's up-convs)
TRANSPOSED_MODULES = ("upflow", "upfeat")


def _kernel_order(path, conv_order: tuple) -> tuple:
    """The axes permutation of the kernel of the module at ``path``:
    ``conv_order`` for a conv, ``(2, 3, 0, 1)`` (its own inverse) for a
    transposed conv."""
    if path and path[-1] in TRANSPOSED_MODULES:
        return (2, 3, 0, 1)  # [kh, kw, in, out] <-> [in, out, kh, kw]
    return conv_order


def _strip_params(tree: Mapping) -> Mapping:
    """Unwrap ``{'params': ...}`` levels (flax variables, checkpoints)."""
    while isinstance(tree, Mapping) and set(tree) == {"params"}:
        tree = tree["params"]
    return tree


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (nested dicts of arrays) -> ``state_dict``."""
    out: Dict[str, torch.Tensor] = OrderedDict()

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
                continue
            a = np.array(v, dtype=np.float32)  # a writable copy
            if k == "kernel":
                if a.ndim != 4:
                    raise ValueError(f"{'/'.join(path + (k,))}: expected an "
                                     f"HWIO kernel, got shape {a.shape}")
                a = a.transpose(_kernel_order(path, (3, 2, 0, 1)))
                k = "weight"
            elif k != "bias":
                raise ValueError(f"unexpected parameter {'/'.join(path + (k,))}")
            out[".".join(path + (k,))] = torch.from_numpy(
                np.ascontiguousarray(a))

    walk(_strip_params(tree), ())
    return out


def load_reference_net(path: str, device, **overrides):
    """``(net, header)``: the reference ``DBSRNet`` of a checkpoint's
    ``net_spec`` with its parameters, in eval mode on ``device``."""
    from benchmark.reference.dbsr import DBSRNet

    header, tree = read_checkpoint(path)
    spec = header["net_spec"]
    if spec["cls"] != "DBSRNet":
        raise ValueError(f"{path}: a {spec['cls']}, not a DBSRNet")
    kwargs = {k: v for k, v in spec["kwargs"].items()
              if not (isinstance(v, dict) and "__dtype__" in v)}
    kwargs.update(overrides)
    net = DBSRNet(**kwargs)
    params = tree["params"] if "params" in tree else tree
    net.load_state_dict(params_from_flax(params), strict=True)
    return net.to(device).eval(), header


def graft_aligner(net, path: str) -> None:
    """Load a pretrained aligner checkpoint's ``alignment_net`` subtree into
    ``net.encoder.alignment_net``."""
    _, tree = read_checkpoint(path)
    sub = params_from_flax(tree["params"]["params"]["alignment_net"])
    net.encoder.alignment_net.load_state_dict(sub, strict=True)
