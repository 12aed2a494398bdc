"""JAX package parameters <-> the port's ``state_dict``.

The port's modules carry the flax module names, so the key of a parameter
is its flax path joined by dots, with ``kernel`` renamed ``weight``:

    encoder/embed/ConvBlock_0/Conv_0/kernel  [3, 3, 4, 64]   (HWIO)
 -> encoder.embed.ConvBlock_0.Conv_0.weight  [64, 4, 3, 3]   (OIHW)

Biases keep their shape. The transposed convs of PWC-Net's decoders
(modules named ``upflow`` and ``upfeat``, ``models/layers.py:
TorchConvTranspose``) keep torch's ``[in, out, kh, kw]`` weight, whose flax
kernel is ``[kh, kw, in, out]``: ``transpose(2, 3, 0, 1)`` both ways. The
rule is keyed on the module's name, never on the shape: ``upflow`` maps 2
channels to 2, so its kernel has the same shape in both layouts and a
wrong transposition would pass every shape check. :func:`params_to_flax` is the exact inverse of
:func:`params_from_flax` (checkpoints the port writes, and gradients or
Adam moments compared by flax path). (``PixShuffleUpsampler_0/Conv_0`` has no bias: the
flagship decoder uses ICNR init, which drops it.)
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch

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
            a = a.transpose(_kernel_order(path, (2, 3, 1, 0)))
            leaf = "kernel"
        elif leaf != "bias":
            raise ValueError(f"unexpected parameter {key}")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree
