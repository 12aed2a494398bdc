"""JAX package parameters -> the port's ``state_dict``.

The port's modules carry the flax module names, so the key of a parameter
is its flax path joined by dots, with ``kernel`` renamed ``weight``:

    encoder/embed/ConvBlock_0/Conv_0/kernel  [3, 3, 4, 64]   (HWIO)
 -> encoder.embed.ConvBlock_0.Conv_0.weight  [64, 4, 3, 3]   (OIHW)

Biases keep their shape. (``PixShuffleUpsampler_0/Conv_0`` has no bias: the
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
