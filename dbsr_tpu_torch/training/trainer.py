"""Trainer: train and eval steps with on-device synthesis, the epoch loop
with divergence guards and fail-safe restart, per-epoch checkpoints
(written on a thread of their own with ``async_checkpoint``), resume (also
from a params-only checkpoint), TensorBoard scalars per epoch and
``DBSR_TPU_TRACE_DIR`` step traces, and data parallelism over a
``torch.distributed`` process group (port of
``dbsr_tpu/training/trainer.py:71-541``).

One train step is: prepare (the loader's pool -> crop draw and burst
synthesis on the device) -> forward -> loss -> ``backward`` -> Adam, under
TF32-off float32 math (``serving.float32_math``). Every loader's batches
come through a ``DevicePrefetcher``: one worker thread calls
``next_batch()`` (and the trainer's ``device_put``) in order, ahead of the
steps. Per-step stats stay on the device and are fetched in one copy at
``print_interval``. Every cycle
draws from its own ``torch.Generator`` on the device, seeded from
``(seed, epoch, training, retry_salt)`` as the JAX trainer folds its key.

Under a process group of W > 1 ranks (``parallel/multihost.py``), the port
of the JAX trainer's ``data`` mesh: every rank runs the same streams and
draws the node's whole batch, and the loaders and prepare functions keep
the rank's rows (``multihost.local_rows``); the gradients are averaged by
one all-reduce per dtype after ``backward`` and before Adam (so gradient
clipping reads the reduced norm), the per-step stats likewise before they
are printed or read by the divergence guards, so every rank takes the
same rollback decisions; the parameters are broadcast from rank 0 after
every init and load, and every rank applies the same reduced bits.
Checkpoints and TensorBoard are rank 0's; a barrier precedes every load.
Across nodes each loader's ``fold_in_process(node_index)`` decorrelates
the nodes' streams, as the JAX trainer folds its process index. A crash
under W > 1 re-raises instead of restarting: the other ranks would wait
in the next collective for one that retried alone (the group's timeout
ends them).
"""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from dbsr_tpu_torch import resolve_device
from dbsr_tpu_torch.data.pipeline import DevicePrefetcher
from dbsr_tpu_torch.data.procedural import make_generator
from dbsr_tpu_torch.models.layers import init_params
from dbsr_tpu_torch.parallel import multihost
from dbsr_tpu_torch.serving import float32_math
from dbsr_tpu_torch.training import checkpoint as ckpt
from dbsr_tpu_torch.training.state import Adam, TrainState
from dbsr_tpu_torch.training.stats import StatsDict
from dbsr_tpu_torch.training.tblogger import TensorboardWriter
from dbsr_tpu_torch.utils.convert import params_from_flax
from dbsr_tpu_torch.utils.profiling import annotate, maybe_trace


def is_divergent(loss_avg: Optional[float], best: Optional[float],
                 factor: Optional[float]) -> bool:
    """Epoch-level divergence: a non-finite loss always counts; otherwise
    the average must exceed ``factor`` x the best epoch so far. ``factor``
    None disables; no verdict before a best exists."""
    if factor is None or loss_avg is None:
        return False
    if not np.isfinite(loss_avg):
        return True
    return best is not None and loss_avg > factor * best


class MidEpochDivergence(RuntimeError):
    """One print interval's mean loss blew past the intra-epoch guard: the
    cycle is aborted and training rolls back to the last good checkpoint
    on a reseeded stream."""

    def __init__(self, interval_avg: float, best: Optional[float],
                 step: int):
        super().__init__(
            f"interval loss {interval_avg:.6g} at step {step} vs best "
            f"epoch {best if best is None else format(best, '.6g')}")
        self.interval_avg = interval_avg
        self.best = best
        self.step = step


@dataclass
class LoaderSpec:
    """One loader: a batcher (``next_batch()``, ``len``) and its schedule."""
    name: str
    batcher: object
    training: bool = True
    epoch_interval: int = 1

    def num_batches(self) -> int:
        return len(self.batcher)


class Trainer:
    # divergence guards: an epoch's mean loss above 1.4x the best epoch's,
    # or one print interval's above 3x, rolls back (None turns one off)
    divergence_factor: Optional[float] = 1.4
    intra_divergence_factor: Optional[float] = 3.0

    def __init__(self, net: torch.nn.Module, actor_fn: Callable, tx: Adam,
                 loaders: List[LoaderSpec], prepare_fn: Callable,
                 workspace_dir: str, net_name: str = "dbsr",
                 print_interval: int = 50, seed: int = 0,
                 header_settings: Optional[dict] = None, device="cuda",
                 device_put: Optional[Callable] = None,
                 async_checkpoint: bool = False,
                 tensorboard_dir: Optional[str] = None,
                 description: str = "", data_parallel: bool = True):
        """``prepare_fn(generator, loader_output) -> batch`` maps a loader's
        output to the training batch on the device (crop draw and burst
        synthesis). ``actor_fn(batch) -> (loss, stats)`` is bound to
        ``net``. ``device_put`` (on the prefetch worker) moves a host
        batch to the device; None for loaders whose batches are device
        tensors already or that ``prepare_fn`` transfers.
        ``async_checkpoint`` writes each epoch's checkpoint on a thread
        of its own while the next epoch trains; ``tensorboard_dir`` logs
        each epoch's averages there (a no-op without ``tensorboard``).
        ``data_parallel`` (a config's ``multi_device``) False refuses a
        process group of more than one rank."""
        self.world = multihost.world_size()
        if self.world > 1 and not data_parallel:
            raise ValueError(
                f"multi_device=False (--single_device) under a process group "
                f"of {self.world} ranks: launch a single process instead")
        self.is_main = multihost.is_main_process()
        if multihost.node_count() > 1:
            # every node runs this constructor with the same config seed:
            # fold the node's index into every loader's stream (the ranks of
            # one node share theirs and each keeps its rows)
            node = multihost.node_index()
            for l in loaders:
                fold = getattr(l.batcher, "fold_in_process", None)
                if fold is not None:
                    fold(node)
                else:
                    print(f"WARNING: loader '{l.name}' batcher has no "
                          "fold_in_process(); multi-host processes may feed "
                          "duplicate data", flush=True)
        self.device = resolve_device(device)
        self.net = net.to(self.device)
        self.actor_fn = actor_fn
        self.tx = tx
        self.loaders = loaders
        self.prepare_fn = prepare_fn
        self.device_put = device_put
        self.workspace_dir = workspace_dir
        self.net_name = net_name
        self.header_settings = dict(header_settings or {})
        self.print_interval = print_interval
        self.seed = seed
        self.epoch = 0
        self._best_train_loss: Optional[float] = None
        self._retry_salt = 0
        self.stats: Dict[str, StatsDict] = {l.name: StatsDict()
                                            for l in loaders}
        # per loader, the last cycle's feed: seconds the steps waited on
        # the prefetch queue, seconds the worker made batches, the cycle's
        # seconds from its start to its last stats fetched, batches
        self.feed: Dict[str, Dict[str, float]] = {}
        self._ckpt_writer = ckpt.AsyncCheckpointWriter() \
            if async_checkpoint and self.is_main else None
        self.tb = TensorboardWriter(tensorboard_dir,
                                    [l.name for l in loaders]) \
            if tensorboard_dir and self.is_main else None
        if self.tb:
            self.tb.write_info(net_name, description)

    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        """Fresh parameters (the JAX package's initialisers, drawn from
        ``seed``) and a fresh Adam."""
        init_params(self.net, make_generator(self.device, self.seed))
        self._broadcast_params()
        return self.tx.init(self.net)

    def _broadcast_params(self) -> None:
        """Rank 0's parameters and buffers on every rank."""
        multihost.broadcast_(list(self.net.state_dict().values()))

    def train_step(self, state: TrainState, generator: torch.Generator,
                   data) -> Dict[str, torch.Tensor]:
        with annotate("train.step"), float32_math():
            with annotate("train.prepare"):
                batch = self.prepare_fn(generator, data)
            with annotate("train.optimizer"):
                state.optimizer.zero_grad(set_to_none=True)
            with annotate("train.forward"):
                loss, stats = self.actor_fn(batch)
            with annotate("train.backward"):
                loss.backward()
                if self.world > 1:
                    multihost.all_reduce_mean_(
                        [p.grad for p in state.trainable().values()
                         if p.grad is not None])
            with annotate("train.optimizer"):
                state.apply_gradients()
        return stats

    @torch.no_grad()
    def eval_step(self, generator: torch.Generator,
                  data) -> Dict[str, torch.Tensor]:
        with float32_math():
            _, stats = self.actor_fn(self.prepare_fn(generator, data))
        return stats

    # ------------------------------------------------------------------
    def cycle_generator(self, loader: LoaderSpec) -> torch.Generator:
        """The stream of one pass over ``loader`` in the current epoch. After
        a divergence rollback the epoch is retried on a different stream:
        replaying the same batches could reproduce the blow-up."""
        return make_generator(self.device, self.seed + 1,
                              self.epoch * 131 + (0 if loader.training else 1)
                              + 1_000_003 * self._retry_salt)

    def _cycle(self, state: TrainState, loader: LoaderSpec) -> TrainState:
        """One pass over a loader."""
        stats = self.stats[loader.name]
        stats.new_epoch()
        n = loader.num_batches()
        g = self.cycle_generator(loader)
        t0 = time.perf_counter()
        samples_done = 0
        pending: List[tuple] = []

        def flush(step: int):
            if not pending:
                return
            with annotate("train.flush"):
                keys = list(pending[0][0])
                rows = torch.stack([torch.stack([s[k].float() for k in keys])
                                    for s, _ in pending])
                # the ranks' means of equal slices: the node batch's means
                multihost.all_reduce_mean_([rows])
                host = rows.cpu().tolist()
                loss_sum = loss_n = 0.0
                for vals, (_, b) in zip(host, pending):
                    row = dict(zip(keys, vals))
                    stats.update_from(row, n=b)
                    loss_sum += row["Loss/total"] * b
                    loss_n += b
                pending.clear()
                if loader.training:
                    interval_avg = loss_sum / loss_n
                    if is_divergent(interval_avg, self._best_train_loss,
                                    self.intra_divergence_factor):
                        raise MidEpochDivergence(interval_avg,
                                                 self._best_train_loss, step)

        prefetch = DevicePrefetcher(loader.batcher.next_batch, n,
                                    self.device_put)
        try:
            for i, data in enumerate(prefetch):
                with maybe_trace(i):
                    if loader.training:
                        step_stats = self.train_step(state, g, data)
                    else:
                        step_stats = self.eval_step(g, data)
                bs = getattr(loader.batcher, "batch_size", None) \
                    or data.shape[0]
                samples_done += bs
                pending.append((step_stats, bs))
                if (i + 1) % self.print_interval == 0 or (i + 1) == n:
                    flush(i + 1)
                    fps = samples_done / (time.perf_counter() - t0)
                    if self.is_main:
                        print(f"[{loader.name}: {self.epoch}, {i + 1}/{n}] "
                              f"FPS: {fps:.1f}, " + ", ".join(
                                  f"{k}: {m.avg:.5f}"
                                  for k, m in stats.items()), flush=True)
            flush(n)
        finally:
            # an abandoned cycle (divergence abort, crash) releases the
            # worker, or a retried epoch's prefetcher would race it for the
            # batcher's stream
            prefetch.close()
            self.feed[loader.name] = {"wait_s": prefetch.wait_s,
                                      "batch_s": prefetch.batch_s,
                                      "cycle_s": time.perf_counter() - t0,
                                      "batches": n}
        return state

    def _train_loss_avg(self) -> Optional[float]:
        """This epoch's average ``Loss/total`` over the first training loader
        that ran."""
        for loader in self.loaders:
            if not loader.training or self.epoch % loader.epoch_interval:
                continue
            return float(self.stats[loader.name]["Loss/total"].avg)
        return None

    def _save(self, state: TrainState) -> None:
        if not self.is_main:
            return
        stats = {name: s.averages() for name, s in self.stats.items()}
        epoch, settings = self.epoch, dict(self.header_settings)
        # a write on the writer's thread runs while the next steps update
        # the parameters and Adam's moments in place: it gets copies taken
        # now, in stream order after this epoch's last step
        contents = ckpt.snapshot_train_state(state)

        def write():
            ckpt.write_train_state(self.workspace_dir, self.net_name, epoch,
                                   contents, stats=stats, settings=settings)

        if self._ckpt_writer is not None:
            self._ckpt_writer.submit(write)
        else:
            write()

    def _load_latest(self, state: TrainState) -> TrainState:
        if self._ckpt_writer is not None:
            # never resolve a half-landed epoch; a failed write is logged,
            # not raised: this runs inside the fail-safe's handlers, and
            # the rollback resumes from the last epoch that did land
            self._ckpt_writer.flush(raise_on_error=False)
        # rank 0's writes have landed before any rank resolves the latest
        multihost.barrier()
        path = ckpt.resolve_checkpoint(self.workspace_dir, self.net_name)
        if path is None:
            return state
        if ckpt.read_header(path).get("params_only"):
            state = self._resume_params_only(path, state)
            self._broadcast_params()
            return state
        header = ckpt.load_train_state(path, state)
        self._broadcast_params()
        self.epoch = int(header["epoch"])
        print(f"resumed from {path} (epoch {self.epoch}, step {state.step})",
              flush=True)
        return state

    def _resume_params_only(self, path: str, state: TrainState) -> TrainState:
        """Resume from a params-only checkpoint dropped into the workspace
        (a banked best seeded back after the full checkpoints were lost):
        the parameters grafted at their recorded epoch, a fresh Adam (zero
        moments, count 0), and ``step`` fast-forwarded to ``epoch x`` the
        training loaders' most batches, so that the StepLR schedule, which
        reads ``step`` here, resumes on its rung. (The JAX package's
        schedule is optax's and reads Adam's count, which such a resume
        restarts at 0.)"""
        header, tree = ckpt.read_checkpoint(path)
        state.net.load_state_dict(params_from_flax(tree["params"]),
                                  strict=True)
        self.epoch = int(header["epoch"])
        steps_per_epoch = max(
            (l.num_batches() for l in self.loaders if l.training), default=0)
        state.step = self.epoch * steps_per_epoch
        print(f"resumed PARAMS-ONLY from {path} (epoch {self.epoch}, fresh "
              f"optimizer state, step fast-forwarded to {state.step})",
              flush=True)
        return state

    # ------------------------------------------------------------------
    def train(self, max_epochs: int, load_latest: bool = True,
              fail_safe: bool = True, max_failures: int = 10) -> TrainState:
        """Epoch loop from the latest checkpoint (unless ``load_latest`` is
        False), with checkpoints, divergence rollback and crash restart
        (``fail_safe``; at most ``max_failures`` rollbacks and restarts)."""
        state = self.init_state()
        if load_latest:
            state = self._load_latest(state)

        failures = 0
        while self.epoch < max_epochs:
            try:
                self.epoch += 1
                for loader in self.loaders:
                    if self.epoch % loader.epoch_interval == 0:
                        state = self._cycle(state, loader)
                loss_avg = self._train_loss_avg()
                if is_divergent(loss_avg, self._best_train_loss,
                                self.divergence_factor):
                    failures += 1
                    if failures > max_failures:
                        raise RuntimeError(
                            f"diverged at epoch {self.epoch} (train loss "
                            f"{loss_avg} vs best {self._best_train_loss}) "
                            "and failure budget exhausted")
                    print(f"Divergence detected at epoch {self.epoch}: "
                          f"train loss {loss_avg:.6g} vs best "
                          f"{self._best_train_loss} (factor "
                          f"{self.divergence_factor}); NOT checkpointing -- "
                          "rolling back to the last good checkpoint with a "
                          f"reseeded stream (failure {failures}/"
                          f"{max_failures})", flush=True)
                    self._retry_salt += 1
                    self.epoch -= 1
                    state = self._load_latest(self.init_state())
                    continue
                if loss_avg is not None and np.isfinite(loss_avg):
                    self._best_train_loss = loss_avg \
                        if self._best_train_loss is None \
                        else min(self._best_train_loss, loss_avg)
                self._save(state)
                if self.tb:
                    for loader in self.loaders:
                        if self.epoch % loader.epoch_interval == 0:
                            self.tb.write_epoch(
                                loader.name,
                                self.stats[loader.name].averages(),
                                self.epoch)
            except MidEpochDivergence as e:
                if not fail_safe:
                    raise
                failures += 1
                if failures > max_failures:
                    raise
                print(f"Mid-epoch divergence at epoch {self.epoch}: {e}; "
                      "aborting the cycle -- rolling back to the last good "
                      "checkpoint with a reseeded stream (failure "
                      f"{failures}/{max_failures})", flush=True)
                self._retry_salt += 1
                self.epoch -= 1
                state = self._load_latest(self.init_state())
            except Exception:
                # under W > 1 ranks a restart of this rank alone would leave
                # the others waiting in a collective: re-raise
                if not fail_safe or self.world > 1:
                    raise
                failures += 1
                if failures > max_failures:
                    raise
                print(f"Training crashed at epoch {self.epoch}; restarting "
                      f"from the last checkpoint (failure {failures}/"
                      f"{max_failures})", flush=True)
                print(traceback.format_exc(), flush=True)
                self.epoch -= 1
                state = self._load_latest(self.init_state())
        if self._ckpt_writer is not None:
            self._ckpt_writer.flush()
        print("Finished training!", flush=True)
        return state
