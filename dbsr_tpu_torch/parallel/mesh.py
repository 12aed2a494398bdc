"""The device list of one process (port of ``dbsr_tpu/parallel/mesh.py``).

The JAX package's mesh is a ``jax.sharding.Mesh`` whose ``data`` axis
shards the batch while XLA replicates the parameters. One PyTorch process
drives its devices explicitly, so the mesh here is a list of
``torch.device`` s and sharding a batch is cutting it into one slice per
device, in order; a caller keeps one replica of the network per device
(``serving.Predictor(devices=...)``). Across processes, data parallelism is
``torch.distributed`` (``parallel/multihost.py``).

* :func:`make_mesh` <-> JAX ``make_mesh`` (one axis: the devices in order);
* :func:`shard_batch` <-> JAX ``shard_batch`` (``device_put`` with the
  batch sharded over ``data``).

JAX's ``data_sharding`` and ``replicated_sharding`` have no counterpart: a
replica is a copy of the network on its device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


def make_mesh(n_devices: Optional[int] = None,
              device_type: Optional[str] = None) -> List[torch.device]:
    """The first ``n_devices`` devices of ``device_type`` (``cuda`` where
    CUDA is available, else ``cpu``; default: every card, or one CPU).
    ``cpu`` may be asked for several times: replicas on one host, as JAX's
    virtual CPU devices."""
    device_type = device_type or ("cuda" if torch.cuda.is_available()
                                  else "cpu")
    if device_type == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if n > count:
        raise ValueError(f"{n} devices asked for, {count} cards present")
    return [torch.device("cuda", i) for i in range(n)]


def shard_batch(devices: Sequence, tree) -> list:
    """``tree`` (an array or tensor, or a dict / list / tuple of them, every
    leaf with the same leading batch dim) cut into ``len(devices)`` equal
    slices in order, slice i moved to ``devices[i]``: one tree per
    device."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)

    def leaves(x):
        if isinstance(x, dict):
            return [l for v in x.values() for l in leaves(v)]
        if isinstance(x, (list, tuple)):
            return [l for v in x for l in leaves(v)]
        return [x]

    B = leaves(tree)[0].shape[0]
    if B % n:
        raise ValueError(f"batch_size {B} not divisible by the mesh 'data' "
                         f"axis ({n} devices)")
    per = B // n

    def cut(x, i):
        if isinstance(x, dict):
            return {k: cut(v, i) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cut(v, i) for v in x)
        part = x[i * per:(i + 1) * per]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.ascontiguousarray(part))
        return part.to(devices[i])

    return [cut(tree, i) for i in range(n)]
