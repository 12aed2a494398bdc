"""Building blocks of the plain reference (a frozen copy of the port's
``models/layers.py`` in float32, without the space-to-depth decoder form:
the same convs with the same parameters at fine resolution).

Modules take and return channels-last ``[B, H, W, C]`` tensors; submodules
carry the JAX package's parameter names (``ConvBlock_0``, ``Conv_0``, ...),
so a checkpoint's flax tree loads by joining its path with dots.
:func:`init_params` draws a fresh network from a generator with the JAX
package's initialisers, in module order.

:func:`set_quant` hands every conv a rounding function, applied to its
input, its weight and its output (and, through autograd, their gradients):
the lower-precision control of the correctness check. Without one every
conv runs in float32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.filtering import gauss_2d


def get_activation(name: str) -> Optional[Callable]:
    if name == "relu":
        return F.relu
    if name == "lrelu":
        return lambda x: F.leaky_relu(x, 0.1)
    if name == "none":
        return None
    raise ValueError(f"unknown activation {name!r}")


def _q(quant, x):
    return x if quant is None else quant(x)


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor, quant=None) -> torch.Tensor:
    """``conv`` on a channels-last tensor, float32 (through ``quant``)."""
    bias = None if conv.bias is None else _q(quant, conv.bias)
    y = F.conv2d(_q(quant, x.float()).permute(0, 3, 1, 2),
                 _q(quant, conv.weight), bias, conv.stride, conv.padding,
                 conv.dilation, conv.groups).permute(0, 2, 3, 1)
    return _q(quant, y)


class ConvBlock(nn.Module):
    """conv (+ activation)."""

    quant: Optional[Callable] = None

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
        x = conv_nhwc(self.Conv_0, x, self.quant)
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
    """Channels-last pixel shuffle with torch's channel convention:
    ``out[..., h*r+i, w*r+j, c] = in[..., h, w, c*r*r + i*r + j]``."""
    B, H, W, C = x.shape
    c = C // (r * r)
    x = x.reshape(B, H, W, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, H * r, W * r, c)


class PixShuffleUpsampler(nn.Module):
    """1x1 conv to ``features * r^2`` -> activation -> pixel shuffle x r ->
    optional depthwise Gaussian blur (zero padding)."""

    quant: Optional[Callable] = None

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
        x = conv_nhwc(self.Conv_0, x, self.quant)
        if self.act is not None:
            x = self.act(x)
        x = pixel_shuffle(x, self.r)
        if self.blur is None:
            return x
        C = x.shape[-1]
        k = self.blur.expand(C, 1, -1, -1)
        y = F.conv2d(_q(self.quant, x).permute(0, 3, 1, 2), k,
                     padding=self.blur.shape[-1] // 2, groups=C)
        return _q(self.quant, y.permute(0, 2, 3, 1))


class TorchConvTranspose(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` on a channels-last tensor (PWC-Net's 4x4
    stride-2 up-convs); the weight in torch's ``[in, out, k, k]`` layout."""

    quant: Optional[Callable] = None

    def __init__(self, in_features: int, features: int, kernel_size: int = 4,
                 stride: int = 2, padding: int = 1):
        super().__init__(in_features, features, kernel_size, stride=stride,
                         padding=padding)

    def forward(self, x):
        q = self.quant
        y = F.conv_transpose2d(
            _q(q, x.float()).permute(0, 3, 1, 2), _q(q, self.weight),
            _q(q, self.bias), self.stride, self.padding, self.output_padding,
            self.groups, self.dilation).permute(0, 2, 3, 1)
        return _q(q, y)


def set_quant(module: nn.Module, quant: Optional[Callable]) -> None:
    """Round every conv's input, weight and output of ``module`` with
    ``quant`` (None: float32)."""
    for m in module.modules():
        if isinstance(m, (ConvBlock, PixShuffleUpsampler,
                          TorchConvTranspose)):
            m.quant = quant


def icnr_(weight: torch.Tensor, r: int, generator: torch.Generator) -> None:
    """ICNR init of a pre-shuffle conv weight ``[out, in, kh, kw]``: a
    kaiming-normal sub-kernel with ``out / r^2`` channels (truncated normal
    at +-2 std, std ``sqrt(2 / fan_in) / .8796``), each channel repeated
    r^2 times."""
    out_ch, in_ch, kh, kw = weight.shape
    std = math.sqrt(2.0 / (in_ch * kh * kw)) / .87962566103423978
    sub = torch.empty((out_ch // (r * r), in_ch, kh, kw), device=weight.device)
    torch.nn.init.trunc_normal_(sub, std=std, a=-2.0 * std, b=2.0 * std,
                                generator=generator)
    with torch.no_grad():
        weight.copy_(sub.repeat_interleave(r * r, dim=0))


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``module`` afresh from ``generator``, in
    module order: conv weights and biases U[-1/sqrt(fan_in),
    1/sqrt(fan_in)], ICNR for the pre-shuffle conv, a transposed conv's
    weight and bias U[-1/sqrt(out*k*k), 1/sqrt(out*k*k)]."""
    icnr = {id(m.Conv_0): m.r for m in module.modules()
            if isinstance(m, PixShuffleUpsampler) and m.icnrinit}
    for m in module.modules():
        if isinstance(m, TorchConvTranspose):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            nn.init.uniform_(m.weight, -bound, bound, generator=generator)
            nn.init.uniform_(m.bias, -bound, bound, generator=generator)
            continue
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
