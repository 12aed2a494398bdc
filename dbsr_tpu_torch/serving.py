"""Serving entry: load a checkpoint into a fixed-shape burst-SR predictor
(port of ``dbsr_tpu/serving.py``).

Usage::

    pred = load_predictor("dbsr_tpu/artifacts/campaigns/"
                          "dbsr_campaign_r5_best_params.ckpt", batch_size=8)
    rgb = pred(burst)   # [<=8, 14, 48, 48, 4] in [0, 1] -> [n, 384, 384, 3]

The predictor runs in float32 (bf16 serving is not ported yet) on
``device`` ("cuda" by default; "cuda" with no card raises), with the JAX
package's fused s2d decoder by default (``fused_s2d=True``: the stage after
the pixel shuffle on the space-to-depth-2 layout; ``DBSR_FINE_PATCH_S2D=1``
runs its 3x3 convs through the fine-patch conv kernel). Its forward turns
TF32 off for cuDNN convs and matmuls, which PyTorch otherwise lets cuDNN
use, and restores the caller's settings afterwards.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from dbsr_tpu_torch.training.checkpoint import load_network

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


class Predictor:
    """Fixed-shape burst-SR predictor: partial batches are padded to
    ``batch_size``, so every forward runs at one shape."""

    def __init__(self, net: torch.nn.Module, batch_size: int, burst_size: int,
                 burst_hw, device: torch.device):
        self.net = net
        self.batch_size = batch_size
        self.in_shape = (batch_size, burst_size) + tuple(burst_hw) + (4,)
        self.device = device

    @torch.inference_mode()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The network's prediction for a burst tensor already on the
        predictor's device, in float32 (TF32 off), not clipped."""
        with float32_math():
            return self.net(x)[0]

    @torch.inference_mode()
    def __call__(self, burst) -> np.ndarray:
        """``[n <= batch_size, N, h, w, 4]`` (or one ``[N, h, w, 4]``) float
        RAW burst -> ``[n, H, W, 3]`` linear RGB clipped to [0, 1]."""
        burst = np.asarray(burst, np.float32)
        if burst.ndim == 4:
            burst = burst[None]
        n = burst.shape[0]
        if n > self.batch_size:
            raise ValueError(f"batch {n} > predictor batch {self.batch_size}")
        if burst.shape[1:] != self.in_shape[1:]:
            raise ValueError(f"expected frame shape {self.in_shape[1:]}, got "
                             f"{burst.shape[1:]}")
        if n < self.batch_size:
            pad = np.zeros((self.batch_size - n,) + burst.shape[1:], np.float32)
            burst = np.concatenate([burst, pad], axis=0)
        pred = self.forward(torch.from_numpy(burst).to(self.device))
        return pred.clamp(0.0, 1.0)[:n].cpu().numpy()


def load_predictor(checkpoint_path: str, batch_size: int = 8,
                   burst_size: int = 14, burst_hw=(48, 48), device="cuda",
                   fused_s2d: bool = True, **net_overrides) -> Predictor:
    """Rebuild the network from a checkpoint at float32, with the s2d
    decoder unless ``fused_s2d=False``, and wrap it in a :class:`Predictor`
    on ``device``."""
    overrides = {"dtype": None, "fused_s2d_decoder": fused_s2d,
                 **net_overrides}
    net, _ = load_network(checkpoint_path, device=device, **overrides)
    return Predictor(net, batch_size, burst_size, burst_hw,
                     next(net.parameters()).device)
