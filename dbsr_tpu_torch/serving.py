"""Serving entry: load a checkpoint into a fixed-shape burst-SR predictor
(port of ``dbsr_tpu/serving.py``).

Usage::

    pred = load_predictor("dbsr_tpu/artifacts/campaigns/"
                          "dbsr_campaign_r5_best_params.ckpt", batch_size=8)
    rgb = pred(burst)   # [<=8, 14, 48, 48, 4] in [0, 1] -> [n, 384, 384, 3]

The predictor computes in bfloat16 by default, as the JAX package serves
(``dtype="bfloat16"``: float32 parameters cast where they are used, the
kernels' bf16 instantiations, the flow, the offsets and the prediction in
float32); ``dtype=None`` (or ``"float32"``) serves in float32. It runs on
``device`` ("cuda" by default; "cuda" with no card raises), with the JAX
package's fused s2d decoder by default (``fused_s2d=True``: the stage after
the pixel shuffle on the space-to-depth-2 layout, whose 3x3 convs run on the
card through the fine-patch conv kernel unless ``DBSR_FINE_PATCH_S2D=0``).
Its forward turns
TF32 off for cuDNN convs and matmuls, which PyTorch otherwise lets cuDNN
use, so that what runs in float32 is float32, and restores the caller's
settings afterwards; those flags are the process's, so a predictor runs one
forward at a time. ``Predictor.warm_up()`` runs one forward at the
serving shape (the kernels' builds at first use, cuDNN's choice of
algorithms: the counterpart of the JAX package's ahead-of-time compile)
and records ``compile_seconds`` and ``flops_per_batch``; the serving
daemon and ``run_serving`` call it before the first request.

Several devices (``load_predictor(..., devices=["cuda:0", "cuda:1"])``, the
counterpart of the JAX package's ``mesh=``): one replica of the network per
device, the batch split over them in order (``batch_size`` must divide by
their number) and the outputs gathered in order on the first. The serving
daemon and ``run_serving`` take no device list, as the JAX package's take
no mesh.
"""

from __future__ import annotations

import contextlib
import copy
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from dbsr_tpu_torch import resolve_device
from dbsr_tpu_torch.models.layers import (ConvBlock, PixShuffleUpsampler,
                                          TorchConvTranspose)
from dbsr_tpu_torch.parallel.mesh import shard_batch
from dbsr_tpu_torch.training.checkpoint import load_network
from dbsr_tpu_torch.utils.profiling import annotate

# the banked flagship checkpoint of the JAX package (epoch 60)
FLAGSHIP_CHECKPOINT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "dbsr_tpu",
    "artifacts", "campaigns", "dbsr_campaign_r5_best_params.ckpt")


@contextlib.contextmanager
def float32_math():
    """Full float32 convs and matmuls: TF32 off, the previous flags restored
    on exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def _conv_macs(module: torch.nn.Module, x: torch.Tensor,
               y: torch.Tensor) -> int:
    """Multiply-adds of one call of a conv module: ``ConvBlock`` (fine or
    s2d: the fine conv's, whatever route computes it), the
    ``PixShuffleUpsampler``'s 1x1 conv and its depthwise blur, a
    ``TorchConvTranspose``."""
    if isinstance(module, ConvBlock):
        # y has the fine conv's output elements in both layouts
        w = module.Conv_0.weight
        return y.numel() * w.shape[1] * w.shape[2] * w.shape[3]
    if isinstance(module, PixShuffleUpsampler):
        macs = x[..., :1].numel() * module.Conv_0.weight.shape[0] * \
            module.Conv_0.weight.shape[1]
        if module.blur is not None:
            macs += y.numel() * module.blur[0, 0].numel()
        return macs
    w = module.weight  # TorchConvTranspose: [in, out, k, k]
    return x.numel() * w.shape[1] * w.shape[2] * w.shape[3]


class Predictor:
    """Fixed-shape burst-SR predictor: partial batches are padded to
    ``batch_size``, so every forward runs at one shape. One forward runs at
    a time (a lock), whatever thread calls. With ``devices``, one replica of
    ``net`` per device, each running its slice of the batch in order."""

    def __init__(self, net: torch.nn.Module, batch_size: int, burst_size: int,
                 burst_hw, device: torch.device, devices=None):
        devices = [resolve_device(d) for d in (devices or [device])]
        if batch_size % len(devices):
            raise ValueError(
                f"batch_size {batch_size} not divisible by the mesh 'data' "
                f"axis ({len(devices)} devices)")
        self.nets = [net.to(devices[0])] + [copy.deepcopy(net).to(d)
                                            for d in devices[1:]]
        self.net = self.nets[0]
        self.devices = devices
        self.batch_size = batch_size
        self.in_shape = (batch_size, burst_size) + tuple(burst_hw) + (4,)
        self.device = devices[0]
        # set by warm_up: the wall seconds of one forward at in_shape (the
        # first, with the kernels' builds and cuDNN's set-up), and
        # 2 x the multiply-adds of one batch's convs and transposed convs
        # (the correlation, warp, merge and elementwise work not counted;
        # the JAX package's figure is XLA's cost analysis of the whole
        # program, another count)
        self.compile_seconds: Optional[float] = None
        self.flops_per_batch: Optional[float] = None
        self._lock = threading.Lock()

    @torch.inference_mode()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The network's prediction for a burst tensor already on the
        predictor's (first) device, float32 (its float32 math with TF32
        off), not clipped; with several devices, each replica's slice of
        the batch on its device, gathered in order."""
        with self._lock, float32_math():
            if len(self.nets) == 1:
                return self.net(x)[0]
            outs = [net(part)[0] for net, part in
                    zip(self.nets, shard_batch(self.devices, x))]
            return torch.cat([o.to(self.device) for o in outs])

    def warm_up(self) -> "Predictor":
        """One forward of zeros at ``in_shape``, synchronised: sets
        ``compile_seconds`` to its wall time and ``flops_per_batch`` to the
        convs' count, taken by forward hooks on the conv modules."""
        macs = []
        hooks = [m.register_forward_hook(
            lambda m, args, y: macs.append(_conv_macs(m, args[0], y)))
            for net in self.nets for m in net.modules()
            if isinstance(m, (ConvBlock, PixShuffleUpsampler,
                              TorchConvTranspose))]
        x = torch.zeros(self.in_shape, device=self.device)
        try:
            t0 = time.perf_counter()
            self.forward(x)
            for d in self.devices:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
            self.compile_seconds = time.perf_counter() - t0
        finally:
            for h in hooks:
                h.remove()
        self.flops_per_batch = 2.0 * sum(macs)
        return self

    @torch.inference_mode()
    def __call__(self, burst) -> np.ndarray:
        """``[n <= batch_size, N, h, w, 4]`` (or one ``[N, h, w, 4]``) float
        RAW burst -> ``[n, H, W, 3]`` linear RGB clipped to [0, 1]."""
        with annotate("serve.stage_in"):
            burst = np.asarray(burst, np.float32)
            if burst.ndim == 4:
                burst = burst[None]
            n = burst.shape[0]
            if n > self.batch_size:
                raise ValueError(f"batch {n} > predictor batch "
                                 f"{self.batch_size}")
            if burst.shape[1:] != self.in_shape[1:]:
                raise ValueError(f"expected frame shape {self.in_shape[1:]}, "
                                 f"got {burst.shape[1:]}")
            if n < self.batch_size:
                pad = np.zeros((self.batch_size - n,) + burst.shape[1:],
                               np.float32)
                burst = np.concatenate([burst, pad], axis=0)
            x = torch.from_numpy(burst).to(self.device)
        with annotate("serve.forward"):
            pred = self.forward(x)
        with annotate("serve.stage_out"):
            return pred.clamp(0.0, 1.0)[:n].cpu().numpy()


def load_predictor(checkpoint_path: str, batch_size: int = 8,
                   burst_size: int = 14, burst_hw=(48, 48), device="cuda",
                   dtype="bfloat16", fused_s2d: bool = True,
                   devices=None, **net_overrides) -> Predictor:
    """Rebuild the network from a checkpoint in ``dtype`` (bfloat16, the
    JAX package's serving default; None or ``"float32"`` for float32), with
    the s2d decoder unless ``fused_s2d=False``, and wrap it in a
    :class:`Predictor` on ``device``, or with one replica on each of
    ``devices`` (the JAX package's ``mesh=``)."""
    if devices:
        device = devices[0]
    overrides = {"dtype": dtype, "fused_s2d_decoder": fused_s2d,
                 **net_overrides}
    net, _ = load_network(checkpoint_path, device=device, **overrides)
    return Predictor(net, batch_size, burst_size, burst_hw,
                     next(net.parameters()).device, devices=devices)
