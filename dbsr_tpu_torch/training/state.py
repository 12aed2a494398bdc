"""Train state and optimizer (port of ``dbsr_tpu/training/state.py:32-83``).

``make_optimizer`` returns the optimizer's recipe (``Adam``): Adam with
betas (0.9, 0.999) and eps 1e-8 outside the square root (optax's and
torch's convention alike), the learning rate from a step-indexed StepLR
schedule, and optional global-norm clipping. ``Adam.init(net)`` builds the
``TrainState``: ``torch.optim.Adam`` over the network's *trainable*
parameters only -- with the aligner frozen, that is the JAX package's
masked Adam (``set_to_zero`` on ``alignment_net``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch


def step_lr_schedule(base_lr: float, step_size_epochs: int, gamma: float,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """StepLR as a function of the number of updates already applied
    (optax's ``count``): ``base_lr * gamma ** ((count // steps_per_epoch)
    // step_size_epochs)``. The first update of epoch e (1-based) has
    ``count == (e - 1) * steps_per_epoch``."""

    def schedule(count: int) -> float:
        epoch = count // steps_per_epoch
        return base_lr * gamma ** (epoch // step_size_epochs)

    return schedule


BETAS, EPS = (0.9, 0.999), 1e-8


@dataclass(frozen=True)
class Adam:
    """Recipe of the optimizer; ``init(net)`` gives a :class:`TrainState`."""
    schedule: Callable[[int], float]
    clip_norm: Optional[float] = None

    def init(self, net: torch.nn.Module) -> "TrainState":
        params = [p for p in net.parameters() if p.requires_grad]
        opt = torch.optim.Adam(params, lr=self.schedule(0), betas=BETAS,
                               eps=EPS)
        return TrainState(net, opt, self)


def make_optimizer(base_lr: float = 1e-4, step_size_epochs: int = 40,
                   gamma: float = 0.2, steps_per_epoch: int = 1000,
                   clip_norm: Optional[float] = None) -> Adam:
    """Adam with the reference's StepLR decay (1e-4, x0.2 every 40 epochs
    for the synthetic config). ``clip_norm`` (off by default) clips the
    global gradient norm as ``optax.clip_by_global_norm`` does."""
    return Adam(step_lr_schedule(base_lr, step_size_epochs, gamma,
                                 steps_per_epoch), clip_norm)


class TrainState:
    """The network, its Adam and ``step``, the number of updates applied."""

    def __init__(self, net: torch.nn.Module, optimizer: torch.optim.Adam,
                 tx: Adam):
        self.net = net
        self.optimizer = optimizer
        self.tx = tx
        self.step = 0

    def trainable(self) -> Dict[str, torch.nn.Parameter]:
        return {k: p for k, p in self.net.named_parameters()
                if p.requires_grad}

    def apply_gradients(self) -> None:
        """One Adam update from the parameters' ``.grad`` at the schedule's
        learning rate for ``step``; clipping first when asked."""
        params = [p for p in self.trainable().values() if p.grad is not None]
        if self.tx.clip_norm is not None and params:
            norm = torch.sqrt(sum((p.grad.float() ** 2).sum() for p in params))
            scale = torch.where(norm < self.tx.clip_norm,
                                torch.ones_like(norm), self.tx.clip_norm / norm)
            for p in params:
                p.grad.mul_(scale)
        lr = self.tx.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1

    def opt_state(self) -> Dict[str, object]:
        """Adam's moments by parameter name (zeros before the first update)
        and its update count."""
        mu, nu = {}, {}
        for k, p in self.trainable().items():
            st = self.optimizer.state.get(p, {})
            mu[k] = st.get("exp_avg", torch.zeros_like(p))
            nu[k] = st.get("exp_avg_sq", torch.zeros_like(p))
        return {"mu": mu, "nu": nu, "count": self.step}

    def load_opt_state(self, opt: Dict[str, object], step: int) -> None:
        """Restore the moments of :meth:`opt_state` and the step."""
        self.optimizer.state.clear()
        if opt["count"] > 0:
            for k, p in self.trainable().items():
                self.optimizer.state[p] = {
                    "step": torch.tensor(float(opt["count"])),
                    "exp_avg": opt["mu"][k].to(p.device, p.dtype).clone(),
                    "exp_avg_sq": opt["nu"][k].to(p.device, p.dtype).clone()}
        self.step = int(step)
