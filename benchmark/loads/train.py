"""The trainer's own loop: whole epochs of ``Trainer._cycle`` over the
configuration's training loader, as ``Trainer.train`` runs each epoch
(``configs/dbsr/default_synthetic.make_trainer``: the procedural pool
rendered on the card once an epoch, burst synthesis in each step, the
network's forward and backward, Adam), without the val pass and the
checkpoint save.

Set-up: the kernels built, the trainer made from the seed (a fresh network
with its output conv made positive, :func:`oracle.live_output`, the
configuration's aligner grafted and frozen), then a first epoch to warm up
every shape and the render; the first ``check_steps`` steps of it keep
their losses, the first gradient (Adam's first moment) and the parameters'
change for the comparison with the reference. The window runs epochs until
one ends after ``--seconds``; it counts every sample trained over its whole
time, and keeps the pool and the first batch of its last epoch, which the
reference renders and synthesizes again from the seed. With ``--trace 1``
one further epoch is traced.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, Optional

import torch

from benchmark import harness, oracle
from benchmark.yardstick import recording_bounds

PREPARE_LABEL = "bench.prepare"


def _settings(cfg: dict, batch: int, seed: int):
    from dbsr_tpu_torch.environment import Settings

    s = Settings()
    s.env.tensorboard_dir = ""
    s.batch_size = batch
    s.steps_per_epoch = cfg["steps_per_epoch"]
    s.pool_size = cfg["pool_size"]
    s.seed = seed
    s.pwc_checkpoint = harness.repo_path(cfg["train_aligner_checkpoint"])
    s.compute_dtype = cfg["compute_dtype"]
    s.fused_s2d_decoder = cfg["fused_s2d_decoder"]
    s.fused_resample = cfg["train_burst"]["fused_resample"]
    return s


def _check_structure(net, cfg: dict) -> Optional[str]:
    """The program's network against the configuration's: the same
    parameters by name and shape (the reference is built from the
    configuration)."""
    from benchmark.reference.dbsr import DBSRNet

    with torch.device("meta"):
        ref = DBSRNet(**cfg["net"])
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))[:4]
        return f"the program's network is not the configuration's: {diff}"
    return None


class _FirstSteps:
    """Wraps ``trainer.train_step`` for the first ``n`` steps: the first
    step's prediction (a forward hook on the network), each step's loss,
    the first gradient's norm by leaf as Adam got it (its first moment
    after one step over ``1 - beta1``) and each leaf's change after step
    ``n``, as device tensors; then hands the trainer its own step back."""

    def __init__(self, trainer, n: int, beta1: float):
        self.trainer, self.n, self.beta1 = trainer, n, beta1
        self.losses, self.grad, self.change = [], {}, {}
        self.pred: Optional[torch.Tensor] = None
        self._start: Dict[str, torch.Tensor] = {}
        self._step = trainer.train_step
        trainer.train_step = self
        self._hook = trainer.net.register_forward_hook(self._keep_pred)

    def _keep_pred(self, module, args, out):
        self.pred = out[0].detach().float().clone()
        self._hook.remove()

    def __call__(self, state, generator, data):
        i = len(self.losses)
        if i == 0:
            self._start = {k: p.detach().clone()
                           for k, p in state.trainable().items()}
        stats = self._step(state, generator, data)
        self.losses.append(stats["Loss/total"].detach().float().clone())
        if i == 0:
            self.grad = {k: (m.double() / (1.0 - self.beta1)).norm()
                         for k, m in state.opt_state()["mu"].items()}
        if i + 1 == self.n:
            self.change = {k: (p.detach().double() - self._start[k]).norm()
                           for k, p in state.trainable().items()}
            self._start = {}
            del self.trainer.train_step  # the class's own from here on
        return stats

    def readings(self) -> Dict[str, object]:
        return {"pred": self.pred.cpu(),
                "losses": [float(v) for v in self.losses],
                "grad_norms": {k: float(v) for k, v in self.grad.items()},
                "change_norms": {k: float(v) for k, v in self.change.items()}}


def _labelled(fn, label: str):
    def call(*args):
        with torch.profiler.record_function(label):
            return fn(*args)
    return call


class _EpochFirstBatch:
    """Wraps ``trainer.prepare_fn``: after :meth:`arm` keeps the next batch
    it prepares (its ``burst`` and ``frame_gt``, the tensors themselves),
    the first of the epoch that follows."""

    def __init__(self, trainer):
        self.trainer = trainer
        self._prepare = trainer.prepare_fn
        self._armed = False
        self.batch: Optional[Dict[str, torch.Tensor]] = None
        trainer.prepare_fn = self

    def arm(self) -> None:
        self._armed = True

    def __call__(self, generator, data):
        out = self._prepare(generator, data)
        if self._armed:
            self.batch = {k: out[k] for k in ("burst", "frame_gt")}
            self._armed = False
        return out

    def stop(self) -> None:
        self.trainer.prepare_fn = self._prepare


def run(ctx: harness.Context) -> Optional[harness.Run]:
    from dbsr_tpu_torch import kernels
    from dbsr_tpu_torch.configs.dbsr.default_synthetic import (
        graft_alignment_params, make_trainer)

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    B, steps_check = tr["batch_size"], tr["check_steps"]
    device = ctx.device
    on_card = torch.device(device).type == "cuda"
    out = harness.Run(cell=ctx.cell)
    if on_card:
        kernels.build()
    trainer, flow_ckpt = make_trainer(_settings(cfg, B, ctx.seed), device)
    problem = _check_structure(trainer.net, cfg)
    if problem:
        out.errors.append(problem)
    state = trainer.init_state()
    oracle.live_output(trainer.net)
    graft_alignment_params(trainer.net, flow_ckpt)
    loader = next(l for l in trainer.loaders if l.training)
    n = loader.num_batches()

    first = _FirstSteps(trainer, steps_check, cfg["optimizer"]["betas"][0])
    trainer.epoch = 1
    trainer._cycle(state, loader)
    harness.sync(device)
    out.metrics["setup_s"] = ctx.setup_s()

    last = _EpochFirstBatch(trainer)
    epochs, wait_s = 0, 0.0
    t0 = time.perf_counter()
    while True:
        trainer.epoch += 1
        last.arm()
        trainer._cycle(state, loader)
        epochs += 1
        wait_s += trainer.feed[loader.name]["wait_s"]
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    harness.sync(device)
    window_s = time.perf_counter() - t0
    last.stop()
    # the pool the last epoch trained on: round ``epoch - 1`` (the set-up
    # epoch, 1, rendered round 0)
    last_epoch = {"epoch": trainer.epoch, "pool": loader.batcher.pool.pool,
                  **last.batch}
    out.metrics["train_samples_per_s"] = epochs * n * B / window_s
    out.attempted = epochs * n
    out.counters.update({"train.steps": epochs * n, "train.batch": B,
                         "train.window_s": window_s,
                         "train.feed_wait_s": wait_s})

    if ctx.trace:
        step_prepare = trainer.prepare_fn
        trainer.prepare_fn = _labelled(step_prepare, PREPARE_LABEL)
        with harness.Trace(torch.device(device).index or 0) as trace, \
                recording_bounds(trace.launches):
            trainer.epoch += 1
            trainer._cycle(state, loader)
        trainer.prepare_fn = step_prepare
        out.trace = trace
        out.counters["train.traced_steps"] = n

    readings = first.readings()
    out.device = harness.device_info(1, device)
    loaded = harness.forbidden_loaded()
    if loaded:
        out.errors.append(f"loaded {', '.join(loaded)}")
    del trainer, state, first, last
    harness.free_device()

    ref = oracle.train_reference(cfg, ctx.seed, B, device, steps=steps_check)
    if not any(v > 0 for v in ref["grad_norms"].values()):
        out.errors.append("the reference's network moved no leaf: nothing "
                          "to compare the backward with")
    for name, value in oracle.compare_train(readings, ref).items():
        out.checks[name] = (value, ctx.cell.limits[name])
    left_out = oracle.left_out_leaves(ref)
    if left_out:
        print("benchmark: leaves left out of the gradient and change "
              f"comparison (reference gradient under {oracle.LEAF_FLOOR} of "
              f"the median leaf's): {', '.join(left_out)}", file=sys.stderr)
    del ref
    for name, value in oracle.compare_epoch(
            last_epoch, cfg, ctx.seed, B, device).items():
        out.checks[name] = (value, ctx.cell.limits[name])
    return out
