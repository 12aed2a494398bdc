"""The comparisons that decide ``correct``: the plain reference
(``benchmark/reference``, float32, no kernel) run on what the timed path
was given, and the gaps between its answers and the program's.

Serving: every sampled answer against the reference's prediction for its
burst, as a relative L2 distance (the widest of the sample is compared).
Training: the first three steps of the window's own training call, the
reference following them from the same seed: the first step's prediction,
each step's loss, the norm of the first gradient by leaf (the program's
from Adam's first moment after one step, ``m / (1 - beta1)``), and the
norm of each leaf's change after three steps. A norm is compared by the
worst leaf: the gap between the program's norm and the reference's, over
the reference's norm of that leaf or of the median leaf, whichever is
larger (the median of the leaves that have a gradient). Leaves whose
reference gradient is under a thousandth of the median leaf's are left out
of both. And the window's last epoch: its pool and its first batch,
rendered and synthesized again from the seed.

The control (:func:`fp8_round`): the reference with every conv's input,
weight and output, and their gradients, rounded to float8 e4m3 under a
per-tensor scale, the precision below the configuration's bf16.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import numpy as np
import torch

E4M3_MAX = 448.0
LEAF_FLOOR = 1e-3  # of the median leaf's reference gradient norm
OUTPUT_CONV = ("decoder.ConvBlock_1.Conv_0.weight",
               "decoder.ConvBlock_1.Conv_0.bias")


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return ((x.float() / scale).to(torch.float8_e4m3fn).float()
            * scale).to(x.dtype)


class _RoundFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale (its absolute
    maximum at e4m3's largest value), the gradient likewise."""
    return _RoundFP8.apply(x)


# ---------------------------------------------------------------------------
# serving

@torch.no_grad()
def serve_reference(checkpoint: str, bursts: torch.Tensor, device,
                    quant=None, batch: int = 8) -> torch.Tensor:
    """The reference's predictions ``[n, H, W, 3]`` (float32, clipped to
    [0, 1], on the CPU) of a checkpoint for ``bursts`` ``[n, N, h, w, 4]``,
    in blocks of ``batch``."""
    from benchmark.reference.checkpoint import load_reference_net
    from benchmark.reference.layers import set_quant

    with _float32_math():
        net, _ = load_reference_net(checkpoint, device)
        set_quant(net, quant)
        out = [net(bursts[i:i + batch].to(device)).clamp(0.0, 1.0).cpu()
               for i in range(0, bursts.shape[0], batch)]
    del net
    return torch.cat(out)


def rel_l2(pred, ref) -> float:
    """``||pred - ref|| / ||ref||`` over one answer, in float64 (0 where
    both are 0)."""
    p = np.asarray(pred, np.float64)
    r = np.asarray(ref, np.float64)
    if p.shape != r.shape:
        return float("inf")
    diff = np.linalg.norm(p - r)
    return 0.0 if diff == 0 else float(diff / max(np.linalg.norm(r), 1e-30))


class _float32_math:
    """TF32 off for cuDNN convs and matmuls inside the block."""

    def __enter__(self):
        b = torch.backends
        self.saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
        b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        b = torch.backends
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = self.saved
        return False


# ---------------------------------------------------------------------------
# training

def burst_config(config: dict):
    from benchmark.reference.synthetic import BurstConfig

    return BurstConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in config["train_burst"].items()})


def live_output(net: torch.nn.Module) -> None:
    """The output conv's weights and bias made positive (their absolute
    values), on the program's network and the reference's alike. Its input
    is a ReLU's output, so its pre-activation is at least its bias at every
    pixel: the output ReLU passes everything, and every leaf upstream gets
    a gradient. Drawn as published, about one network in ten has all three
    output channels below zero everywhere: its output ReLU is dead, no leaf
    gets a gradient, and a training step moves nothing on either side."""
    with torch.no_grad():
        params = dict(net.named_parameters())
        for name in OUTPUT_CONV:
            params[name].abs_()


def epoch_inputs(config: dict, seed: int, batch: int, steps: int, device,
                 epoch: int = 1):
    """The pool of training epoch ``epoch`` (1 the first) and its first
    ``steps`` batches, worked out again: the dead-leaves pool of round
    ``epoch - 1`` from ``seed``, each step's crops and synthesis drawn from
    the epoch's stream ``(seed + 1, 131 * epoch)``
    (``Trainer.cycle_generator``). Returns ``(pool, [(burst, frame_gt),
    ...])``."""
    from benchmark.reference.procedural import (crops_from_draws,
                                                draw_crops, make_generator,
                                                render_pool)
    from benchmark.reference.synthetic import (rgb2rawburst_from_draws,
                                               sample_draws)

    cfg = burst_config(config)
    pool_size = config["pool_size"]
    with torch.no_grad():
        pool = render_pool(pool_size, cfg.pre_crop_sz, seed, epoch - 1,
                           device)
        g = make_generator(device, seed + 1, 131 * epoch)
        batches = []
        for _ in range(steps):
            crops = draw_crops(g, batch, pool_size)
            draws = sample_draws(g, batch, cfg)
            out = rgb2rawburst_from_draws(crops_from_draws(pool, crops),
                                          draws, cfg)
            batches.append((out["burst"], out["frame_gt"]))
    return pool, batches


def train_reference(config: dict, seed: int, batch: int, device,
                    steps: int = 3, quant=None,
                    rows: Optional[int] = None) -> Dict[str, object]:
    """The reference's first ``steps`` training steps from ``seed``: a
    fresh network drawn as the program draws it, its output conv made
    positive (:func:`live_output`), the configured aligner grafted and
    frozen, L1 with the configured boundary, Adam. Returns each
    step's loss, the first gradient's norm by leaf and each leaf's change
    after the last step. ``rows`` takes the loss over the first ``rows``
    rows of each batch only: half of them is the fault of a step that
    leaves half of the batch out, which the comparison has to catch."""
    from benchmark.harness import repo_path
    from benchmark.reference.checkpoint import graft_aligner
    from benchmark.reference.dbsr import DBSRNet
    from benchmark.reference.layers import init_params, set_quant
    from benchmark.reference.procedural import make_generator

    if config["loss"] != "l1" or config["optimizer"]["name"] != "adam":
        raise NotImplementedError("the reference trains L1 with Adam")
    b = config["loss_boundary_ignore"]
    with _float32_math():
        net = DBSRNet(**config["net"]).to(device)
        init_params(net, make_generator(device, seed))
        live_output(net)
        graft_aligner(net, repo_path(config["train_aligner_checkpoint"]))
        set_quant(net, quant)
        params = {k: p for k, p in net.named_parameters() if p.requires_grad}
        start = {k: p.detach().clone() for k, p in params.items()}
        o = config["optimizer"]
        opt = torch.optim.Adam(list(params.values()), lr=o["lr"],
                               betas=tuple(o["betas"]), eps=o["eps"])
        losses: List[float] = []
        first_grad: Dict[str, float] = {}
        first_pred = None
        _, batches = epoch_inputs(config, seed, batch, steps, device)
        for i, (burst, gt) in enumerate(batches):
            if rows is not None:
                burst, gt = burst[:rows], gt[:rows]
            opt.zero_grad(set_to_none=True)
            pred = net(burst)
            if i == 0:
                first_pred = pred.detach().cpu()
            loss = (pred[:, b:-b, b:-b] - gt[:, b:-b, b:-b]).abs().mean()
            loss.backward()
            losses.append(float(loss.detach()))
            if i == 0:
                first_grad = {k: float(p.grad.double().norm())
                              for k, p in params.items()}
            opt.step()
        change = {k: float((p.detach() - start[k]).double().norm())
                  for k, p in params.items()}
    del net, opt, params, start
    return {"pred": first_pred, "losses": losses, "grad_norms": first_grad,
            "change_norms": change}


def _median_moved(norms) -> float:
    """The median of the leaves' norms that are not zero; infinite where
    every leaf's is zero (nothing moved: no gap can be read)."""
    moved = [v for v in norms if v > 0]
    return statistics.median(moved) if moved else float("inf")


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float],
               keep: List[str]) -> List[float]:
    floor = _median_moved(want[k] for k in keep)
    return [abs(got[k] - want[k]) / max(want[k], floor) for k in keep]


def compare_train(got: Dict[str, object],
                  want: Dict[str, object]) -> Dict[str, float]:
    """The numbers compared for a training cell: ``pred_gap`` (the first
    step's prediction, relative L2 over the batch), ``loss_gap`` (the worst
    step's relative gap of the loss), ``grad_gap`` and ``change_gap`` (the
    worst leaf's gap of norms, see the module's docstring) and
    ``grad_median_gap`` (the median leaf's gap of the first gradient's
    norms: steady from seed to seed, where the worst leaf swings)."""
    pred_gap = rel_l2(got["pred"].numpy(), want["pred"].numpy())
    gl, wl = got["losses"], want["losses"]
    loss_gap = max(abs(g - w) / abs(w) for g, w in zip(gl, wl))
    if len(gl) != len(wl):
        loss_gap = float("inf")
    wg = want["grad_norms"]
    median = _median_moved(wg.values())
    keep = [k for k, v in wg.items() if v >= LEAF_FLOOR * median]
    if not keep or set(got["grad_norms"]) != set(wg):
        return {"pred_gap": pred_gap, "loss_gap": loss_gap,
                "grad_gap": float("inf"), "grad_median_gap": float("inf"),
                "change_gap": float("inf")}
    grad = _leaf_gaps(got["grad_norms"], wg, keep)
    return {"pred_gap": pred_gap, "loss_gap": loss_gap,
            "grad_gap": max(grad),
            "grad_median_gap": statistics.median(grad),
            "change_gap": max(_leaf_gaps(got["change_norms"],
                                         want["change_norms"], keep))}


def left_out_leaves(want: Dict[str, object]) -> List[str]:
    wg = want["grad_norms"]
    median = _median_moved(wg.values())
    return sorted(k for k, v in wg.items() if v < LEAF_FLOOR * median)


def rel_l2_t(pred: torch.Tensor, ref: torch.Tensor) -> float:
    """:func:`rel_l2` of two tensors on their device, in float64."""
    if pred.shape != ref.shape:
        return float("inf")
    diff = (pred.double() - ref.double()).norm()
    return 0.0 if diff == 0 else float(diff / ref.double().norm()
                                       .clamp_min(1e-30))


def compare_epoch(got: Dict[str, object], config: dict, seed: int,
                  batch: int, device) -> Dict[str, float]:
    """The numbers compared for the window's last epoch (``got``: its
    ``epoch``, the ``pool`` it trained on and its first batch, ``burst``
    and ``frame_gt``): ``pool_gap``, the pool against the reference's
    render of that epoch's round, and ``batch_gap``, the worse of the
    burst's and the ground truth's relative L2 against the reference's
    synthesis of the epoch's first batch."""
    pool, [(burst, gt)] = epoch_inputs(config, seed, batch, 1, device,
                                       epoch=got["epoch"])
    return {"pool_gap": rel_l2_t(got["pool"], pool),
            "batch_gap": max(rel_l2_t(got["burst"], burst),
                             rel_l2_t(got["frame_gt"], gt))}
