"""JAX package parameters <-> the port's ``state_dict``.

The port's modules carry the flax module names, so the key of a parameter
is its flax path joined by dots, with ``kernel`` renamed ``weight``:

    encoder/embed/ConvBlock_0/Conv_0/kernel  [3, 3, 4, 64]   (HWIO)
 -> encoder.embed.ConvBlock_0.Conv_0.weight  [64, 4, 3, 3]   (OIHW)

Biases keep their shape. :func:`params_to_flax` is the exact inverse of
:func:`params_from_flax` (checkpoints the port writes, and gradients or
Adam moments compared by flax path). (``PixShuffleUpsampler_0/Conv_0`` has no bias: the
flagship decoder uses ICNR init, which drops it.)
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch


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
                a = a.transpose(3, 2, 0, 1)
                k = "weight"
            elif k != "bias":
                raise ValueError(f"unexpected parameter {'/'.join(path + (k,))}")
            out[".".join(path + (k,))] = torch.from_numpy(
                np.ascontiguousarray(a))

    walk(_strip_params(tree), ())
    return out


def params_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """``state_dict`` (or any name -> tensor map with its keys) -> flax
    parameter tree of float32 numpy arrays, OIHW kernels back to HWIO."""
    tree: Dict = {}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        a = t.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight":
            if a.ndim != 4:
                raise ValueError(f"{key}: expected an OIHW weight, got shape "
                                 f"{a.shape}")
            a, leaf = a.transpose(2, 3, 1, 0), "kernel"
        elif leaf != "bias":
            raise ValueError(f"unexpected parameter {key}")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree
