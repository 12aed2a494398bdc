"""Building blocks (port of ``dbsr_tpu/models/layers.py``).

Modules take and return channels-last ``[B, H, W, C]`` tensors, as the JAX
package does; each conv runs on the NCHW view of its input (a
``channels_last`` tensor for PyTorch) and returns to NHWC. Submodules carry
the JAX package's parameter names (``ConvBlock_0``, ``Conv_0``, ...), so a
flax parameter path maps to a ``state_dict`` key by joining with dots (see
``utils/convert.py``).

A fresh network gets the JAX package's initial distributions from an
explicit generator (:func:`init_params`): every conv weight and bias
U[-1/sqrt(fan_in), 1/sqrt(fan_in)] (torch's ``nn.Conv2d`` default, which the
JAX package copies), and ICNR for the pre-shuffle conv.

Padding follows the JAX code: ``SAME`` for stride 1 (a dilated 3x3 pads by
its dilation) and an explicit ``(1, 1)`` for the stride-2 convs, which is
``dilation * (k // 2)`` on each side in every case here.

The s2d decoder form of the JAX package is a TPU re-layout of the same
convs with the same parameters; the port runs the decoder at fine
resolution.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from dbsr_tpu_torch.ops.filtering import gauss_2d


def get_activation(name: str) -> Optional[Callable]:
    if name == "relu":
        return F.relu
    if name == "lrelu":
        return lambda x: F.leaky_relu(x, 0.1)
    if name == "none":
        return None
    raise ValueError(f"unknown activation {name!r}")


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply ``conv`` to a channels-last ``[B, H, W, C]`` tensor."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ConvBlock(nn.Module):
    """conv (+ activation)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, use_bias: bool = True,
                 activation: str = "relu"):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_features, features, kernel_size,
                                stride=stride,
                                padding=dilation * (kernel_size // 2),
                                dilation=dilation, bias=use_bias)
        self.act = get_activation(activation)

    def forward(self, x):
        x = conv_nhwc(self.Conv_0, x)
        return self.act(x) if self.act is not None else x


class ResBlock(nn.Module):
    """Post-activation residual block: ``act(conv-act-conv(x) + x)``."""

    def __init__(self, features: int, activation: str = "relu"):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(features, features, 3,
                                     activation=activation)
        self.ConvBlock_1 = ConvBlock(features, features, 3, activation="none")
        self.act = get_activation(activation)

    def forward(self, x):
        return self.act(self.ConvBlock_1(self.ConvBlock_0(x)) + x)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """Channels-last pixel shuffle with torch's channel convention
    (equal to ``F.pixel_shuffle`` on the NCHW view):
    ``out[..., h*r+i, w*r+j, c] = in[..., h, w, c*r*r + i*r + j]``."""
    B, H, W, C = x.shape
    if C % (r * r):
        raise ValueError(f"pixel_shuffle: C={C} not divisible by {r * r}")
    c = C // (r * r)
    x = x.reshape(B, H, W, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, H * r, W * r, c)


class PixShuffleUpsampler(nn.Module):
    """1x1 conv to ``features * r^2`` -> activation -> pixel shuffle x r ->
    optional depthwise Gaussian blur (zero padding)."""

    def __init__(self, in_features: int, features: int,
                 upsample_factor: int = 2, activation: str = "relu",
                 icnrinit: bool = False, gauss_blur_sd: Optional[float] = None,
                 gauss_ksz: int = 3):
        super().__init__()
        r = upsample_factor
        self.r = r
        self.icnrinit = icnrinit
        self.Conv_0 = nn.Conv2d(in_features, features * r * r, 1,
                                bias=not icnrinit)
        self.act = get_activation(activation)
        if gauss_blur_sd is not None:
            k = gauss_2d(gauss_ksz, gauss_blur_sd, (0.0, 0.0), density=True)[0]
            self.register_buffer("blur", (k / k.sum())[None, None],
                                 persistent=False)
        else:
            self.blur = None

    def forward(self, x):
        x = conv_nhwc(self.Conv_0, x)
        if self.act is not None:
            x = self.act(x)
        x = pixel_shuffle(x, self.r)
        if self.blur is not None:
            C = x.shape[-1]
            k = self.blur.to(x.dtype).expand(C, 1, -1, -1)
            x = F.conv2d(x.permute(0, 3, 1, 2), k,
                         padding=self.blur.shape[-1] // 2,
                         groups=C).permute(0, 2, 3, 1)
        return x


def icnr_(weight: torch.Tensor, r: int, generator: torch.Generator) -> None:
    """ICNR init of a pre-shuffle conv weight ``[out, in, kh, kw]``: a
    kaiming-normal sub-kernel with ``out / r^2`` channels (flax's
    ``kaiming_normal``: truncated normal at +-2 std, std
    ``sqrt(2 / fan_in) / .8796``), each channel repeated r^2 times, so that
    output channel ``o`` is sub-channel ``o // r^2``."""
    out_ch, in_ch, kh, kw = weight.shape
    if out_ch % (r * r):
        raise ValueError(f"ICNR: {out_ch} channels not divisible by {r * r}")
    std = math.sqrt(2.0 / (in_ch * kh * kw)) / .87962566103423978
    sub = torch.empty((out_ch // (r * r), in_ch, kh, kw), device=weight.device)
    torch.nn.init.trunc_normal_(sub, std=std, a=-2.0 * std, b=2.0 * std,
                                generator=generator)
    with torch.no_grad():
        weight.copy_(sub.repeat_interleave(r * r, dim=0))


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``module`` afresh from ``generator`` (on the
    parameters' device), with the JAX package's initialisers."""
    icnr = {id(m.Conv_0): m.r for m in module.modules()
            if isinstance(m, PixShuffleUpsampler) and m.icnrinit}
    for m in module.modules():
        if not isinstance(m, nn.Conv2d):
            continue
        fan_in = m.in_channels // m.groups * m.kernel_size[0] \
            * m.kernel_size[1]
        bound = 1.0 / math.sqrt(fan_in)
        if id(m) in icnr:
            icnr_(m.weight, icnr[id(m)], generator)
        else:
            nn.init.uniform_(m.weight, -bound, bound, generator=generator)
        if m.bias is not None:
            nn.init.uniform_(m.bias, -bound, bound, generator=generator)
    return module
