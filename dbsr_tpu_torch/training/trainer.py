"""Trainer: train and eval steps with on-device synthesis, the epoch loop
with divergence guards and fail-safe restart, per-epoch checkpoints and
resume (port of ``dbsr_tpu/training/trainer.py:71-541``; no mesh, no
asynchronous checkpoint writer, no TensorBoard).

One train step is: prepare (the loader's pool -> crop draw and burst
synthesis on the device) -> forward -> loss -> ``backward`` -> Adam, under
TF32-off float32 math (``serving.float32_math``). Per-step stats stay on
the device and are fetched in one copy at ``print_interval``. Every cycle
draws from its own ``torch.Generator`` on the device, seeded from
``(seed, epoch, training, retry_salt)`` as the JAX trainer folds its key.
"""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from dbsr_tpu_torch import resolve_device
from dbsr_tpu_torch.data.procedural import make_generator
from dbsr_tpu_torch.models.layers import init_params
from dbsr_tpu_torch.serving import float32_math
from dbsr_tpu_torch.training import checkpoint as ckpt
from dbsr_tpu_torch.training.state import Adam, TrainState
from dbsr_tpu_torch.training.stats import StatsDict


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
    max_failures = 10  # rollbacks and crash restarts before giving up

    def __init__(self, net: torch.nn.Module, actor_fn: Callable, tx: Adam,
                 loaders: List[LoaderSpec], prepare_fn: Callable,
                 workspace_dir: str, net_name: str = "dbsr",
                 print_interval: int = 50, seed: int = 0,
                 header_settings: Optional[dict] = None, device="cuda"):
        """``prepare_fn(generator, loader_output) -> batch`` maps a loader's
        output to the training batch on the device (crop draw and burst
        synthesis). ``actor_fn(batch) -> (loss, stats)`` is bound to
        ``net``."""
        self.device = resolve_device(device)
        self.net = net.to(self.device)
        self.actor_fn = actor_fn
        self.tx = tx
        self.loaders = loaders
        self.prepare_fn = prepare_fn
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

    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        """Fresh parameters (the JAX package's initialisers, drawn from
        ``seed``) and a fresh Adam."""
        init_params(self.net, make_generator(self.device, self.seed))
        return self.tx.init(self.net)

    def train_step(self, state: TrainState, generator: torch.Generator,
                   data) -> Dict[str, torch.Tensor]:
        with float32_math():
            batch = self.prepare_fn(generator, data)
            state.optimizer.zero_grad(set_to_none=True)
            loss, stats = self.actor_fn(batch)
            loss.backward()
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
            keys = list(pending[0][0])
            host = torch.stack([torch.stack([s[k].float() for k in keys])
                                for s, _ in pending]).cpu().tolist()
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

        for i in range(n):
            data = loader.batcher.next_batch()
            if loader.training:
                step_stats = self.train_step(state, g, data)
            else:
                step_stats = self.eval_step(g, data)
            bs = getattr(loader.batcher, "batch_size", None) or data.shape[0]
            samples_done += bs
            pending.append((step_stats, bs))
            if (i + 1) % self.print_interval == 0 or (i + 1) == n:
                flush(i + 1)
                fps = samples_done / (time.perf_counter() - t0)
                print(f"[{loader.name}: {self.epoch}, {i + 1}/{n}] "
                      f"FPS: {fps:.1f}, " + ", ".join(
                          f"{k}: {m.avg:.5f}" for k, m in stats.items()),
                      flush=True)
        flush(n)
        return state

    def _train_loss_avg(self) -> Optional[float]:
        """This epoch's average ``Loss/total`` over the first training loader
        that ran."""
        for loader in self.loaders:
            if not loader.training or self.epoch % loader.epoch_interval:
                continue
            return float(self.stats[loader.name]["Loss/total"].avg)
        return None

    def save(self, state: TrainState) -> str:
        stats = {name: s.averages() for name, s in self.stats.items()}
        return ckpt.save_checkpoint(self.workspace_dir, self.net_name,
                                    self.epoch, state, stats=stats,
                                    settings=self.header_settings)

    def _load_latest(self, state: TrainState) -> TrainState:
        path = ckpt.resolve_checkpoint(self.workspace_dir, self.net_name)
        if path is None:
            return state
        header = ckpt.load_train_state(path, state)
        self.epoch = int(header["epoch"])
        print(f"resumed from {path} (epoch {self.epoch}, step {state.step})",
              flush=True)
        return state

    # ------------------------------------------------------------------
    def train(self, max_epochs: int) -> TrainState:
        """Epoch loop from the latest checkpoint, with checkpoints,
        divergence rollback and crash restart."""
        state = self._load_latest(self.init_state())

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
                    if failures > self.max_failures:
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
                          f"{self.max_failures})", flush=True)
                    self._retry_salt += 1
                    self.epoch -= 1
                    state = self._load_latest(self.init_state())
                    continue
                if loss_avg is not None and np.isfinite(loss_avg):
                    self._best_train_loss = loss_avg \
                        if self._best_train_loss is None \
                        else min(self._best_train_loss, loss_avg)
                self.save(state)
            except MidEpochDivergence as e:
                failures += 1
                if failures > self.max_failures:
                    raise
                print(f"Mid-epoch divergence at epoch {self.epoch}: {e}; "
                      "aborting the cycle -- rolling back to the last good "
                      "checkpoint with a reseeded stream (failure "
                      f"{failures}/{self.max_failures})", flush=True)
                self._retry_salt += 1
                self.epoch -= 1
                state = self._load_latest(self.init_state())
            except Exception:
                failures += 1
                if failures > self.max_failures:
                    raise
                print(f"Training crashed at epoch {self.epoch}; restarting "
                      f"from the last checkpoint (failure {failures}/"
                      f"{self.max_failures})", flush=True)
                print(traceback.format_exc(), flush=True)
                self.epoch -= 1
                state = self._load_latest(self.init_state())
        print("Finished training!", flush=True)
        return state
