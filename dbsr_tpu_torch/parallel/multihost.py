"""Multi-process data parallelism over ``torch.distributed`` (port of
``dbsr_tpu/parallel/multihost.py``).

The JAX package runs one process per host, whose devices form the ``data``
axis of a mesh; ``batch_size`` is the host's batch, and across hosts each
process folds its index into its loaders' seeds. PyTorch runs one process
per card, so here **the ranks of one node together play one JAX host**:

* every rank of a node runs the same loader stream (the same seed, folded
  by *node* index, never by rank) and draws the per-sample randomness of
  the node's whole batch; it keeps its slice
  (:func:`process_local_batch_slice`, :func:`local_rows`) and makes only
  that;
* the trainer averages the gradients over all ranks with an all-reduce, so
  a node of W cards takes the steps one card takes at the same
  ``batch_size``, up to the all-reduce's order of summation; the global
  batch is ``batch_size`` x nodes.

* :func:`maybe_initialize_distributed` — env-gated
  ``init_process_group`` (no-op single-process, so the same entry point runs
  from one card to a node of eight);
* :func:`process_local_batch_slice` — which rows of the node's batch this
  rank makes.

``global_batch_from_local`` has no counterpart: there is no global array
under one process per card; each rank's slice stays its own and only the
gradients and the stats are reduced.

Launch (one node of 8 cards; ``torch.distributed.run`` sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``)::

    DBSR_TPU_DIST=1 python -m torch.distributed.run --nproc_per_node=8 \\
        -m dbsr_tpu_torch.run_training dbsr default_synthetic
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

# seconds a collective may wait for the other ranks before it raises (a
# rank that crashed leaves the others blocked in the next all-reduce)
DEFAULT_TIMEOUT_S = 600.0

# set by maybe_initialize_distributed: this rank's place on its node
_local = {"rank": None, "size": None}


def distributed_requested() -> bool:
    return os.environ.get("DBSR_TPU_DIST", "0") not in ("", "0", "false")


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def maybe_initialize_distributed(init_method: Optional[str] = None,
                                 world_size: Optional[int] = None,
                                 rank: Optional[int] = None,
                                 backend: Optional[str] = None,
                                 local_rank: Optional[int] = None,
                                 local_world_size: Optional[int] = None,
                                 timeout_s: float = DEFAULT_TIMEOUT_S,
                                 device_type: Optional[str] = None) -> bool:
    """``torch.distributed.init_process_group`` iff multi-process is asked
    for (``DBSR_TPU_DIST=1``, or an explicit ``init_method``). Returns True
    when a process group is active.

    Explicit arguments override torchrun's ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` (``init_method`` defaults to
    ``env://``, which reads ``MASTER_ADDR`` / ``MASTER_PORT``). The ranks
    train on ``device_type`` (``cuda`` where CUDA is available, else
    ``cpu``); the backend follows it, ``nccl`` for ``cuda`` and ``gloo``
    for ``cpu``, unless the caller names one. On ``cuda``,
    ``torch.cuda.set_device(local_rank)`` runs first, before any CUDA
    work. A failed initialisation raises: training never carries on
    single-process in its place. The group's collectives time out after
    ``timeout_s``. Must run before first device use."""
    if not (distributed_requested() or init_method):
        return False
    if dist.is_initialized():
        return True
    world_size = world_size if world_size is not None \
        else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if world_size is None or rank is None:
        raise RuntimeError(
            "DBSR_TPU_DIST=1 but no WORLD_SIZE / RANK: launch with "
            "`python -m torch.distributed.run --nproc_per_node=N ...`, or "
            "pass world_size and rank")
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK")
    if local_rank is None:
        local_rank = rank
    if local_world_size is None:
        local_world_size = _env_int("LOCAL_WORLD_SIZE") or world_size
    if world_size % local_world_size:
        raise ValueError(f"world size {world_size} is not a whole number of "
                         f"nodes of {local_world_size} ranks")
    device_type = device_type or ("cuda" if torch.cuda.is_available()
                                  else "cpu")
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if device_type == "cuda":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    _local.update(rank=local_rank, size=local_world_size)
    return True


def world_size() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Rank 0, or no process group: the process that writes checkpoints,
    artifacts and TensorBoard."""
    return rank() == 0


def local_world_size() -> int:
    """Ranks on this node: as initialised, else ``LOCAL_WORLD_SIZE``, else
    every rank (one node)."""
    if not dist.is_initialized():
        return 1
    return _local["size"] or _env_int("LOCAL_WORLD_SIZE") or world_size()


def node_index() -> int:
    """This rank's node (what JAX's ``process_index`` is to a host)."""
    return rank() // local_world_size()


def node_count() -> int:
    return world_size() // local_world_size()


def process_local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """(start, size) of this rank's slice of its node's batch: the batch
    split evenly over the node's ranks in rank order; ``(0, global_batch)``
    without a process group."""
    n = local_world_size()
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by process count {n}")
    per = global_batch // n
    return (rank() % n) * per, per


def local_rows(tree, global_batch: int):
    """``tree`` (a tensor, or a dict / list / tuple of them, every leaf with
    a leading dim of ``global_batch``) cut to this rank's rows; unchanged
    single-process."""
    start, size = process_local_batch_slice(global_batch)
    if size == global_batch:
        return tree

    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cut(v) for v in x)
        return x[start:start + size]

    return cut(tree)


def global_mean_weight(count: torch.Tensor) -> torch.Tensor:
    """``W * count / (count summed over the W ranks)``, 1 single-process: a
    rank's mean over its ``count`` items times this, averaged over the ranks
    (as the trainer averages gradients and stats), is one mean over every
    rank's items."""
    W = world_size()
    count = count.detach().float()
    if W == 1:
        return torch.ones_like(count)
    total = count.clone()
    dist.all_reduce(total)
    return W * count / total.clamp_min(1e-12)


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def _buckets(tensors):
    """The tensors grouped by (dtype, device), in order."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return groups.values()


def all_reduce_mean_(tensors) -> None:
    """Average ``tensors`` over the ranks in place: one flat all-reduce
    bucket per dtype, divided by the world size. Every rank ends with the
    same bits."""
    W = world_size()
    if W == 1:
        return
    for group in _buckets(list(tensors)):
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat.div_(W)
        off = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n


def broadcast_(tensors, src: int = 0) -> None:
    """Rank ``src``'s values of ``tensors`` on every rank, in place (one
    flat broadcast per dtype)."""
    if world_size() == 1:
        return
    for group in _buckets(list(tensors)):
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src)
        off = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n
