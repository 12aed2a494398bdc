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

``s2d=True`` (``ConvBlock``, ``ResBlock``) and ``s2d_output=True``
(``PixShuffleUpsampler``) run the same convs with the same parameters on the
phase-major space-to-depth-2 layout of the JAX package's fused s2d decoder
(channel ``(qy*2+qx)*C + c`` of a half-resolution tensor holds fine pixel
``(2Y+qy, 2X+qx)``): a 3x3 conv through ``ops/conv_s2d.py:conv3x3_s2d_auto``,
a 1x1 through the block-diagonal ``[4O, 4C, 1, 1]`` conv of
:func:`s2d_conv_kernel`, the bias tiled over the four phases. The parameters
stay in the fine ``nn.Conv2d`` named ``Conv_0``; only the forward differs.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from dbsr_tpu_torch.ops.conv_s2d import conv3x3_s2d_auto
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
    """conv (+ activation); with ``s2d`` the same conv on the s2d layout
    (``[B, H2, W2, 4 * in_features]`` -> ``[B, H2, W2, 4 * features]``)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, use_bias: bool = True,
                 activation: str = "relu", s2d: bool = False):
        super().__init__()
        if s2d and (stride != 1 or dilation != 1 or kernel_size not in (1, 3)):
            raise ValueError("s2d ConvBlock: a 1x1 or 3x3 conv of stride 1 "
                             "and dilation 1 only")
        self.s2d = s2d
        self.Conv_0 = nn.Conv2d(in_features, features, kernel_size,
                                stride=stride,
                                padding=dilation * (kernel_size // 2),
                                dilation=dilation, bias=use_bias)
        self.act = get_activation(activation)

    def forward(self, x):
        if self.s2d:
            w, bias = self.Conv_0.weight, self.Conv_0.bias
            if w.shape[-1] == 3:
                x = conv3x3_s2d_auto(x, w)
            else:
                x = F.conv2d(x.permute(0, 3, 1, 2),
                             s2d_conv_kernel(w)).permute(0, 2, 3, 1)
            if bias is not None:  # phase-major: the bias tiled over phases
                x = x + bias.repeat(4)
        else:
            x = conv_nhwc(self.Conv_0, x)
        return self.act(x) if self.act is not None else x


class ResBlock(nn.Module):
    """Post-activation residual block: ``act(conv-act-conv(x) + x)``."""

    def __init__(self, features: int, activation: str = "relu",
                 s2d: bool = False):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(features, features, 3,
                                     activation=activation, s2d=s2d)
        self.ConvBlock_1 = ConvBlock(features, features, 3, activation="none",
                                     s2d=s2d)
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
    optional depthwise Gaussian blur (zero padding). With ``s2d_output``
    (even ``r``) the output is the phase-major s2d layout of the same
    tensor: the channels permuted by :func:`s2d_shuffle_permutation`, then a
    pixel shuffle by ``r // 2``; the blur, which the JAX package runs as a
    dense block-diagonal conv on that layout, runs depthwise at fine
    resolution in between an unfold and a fold."""

    def __init__(self, in_features: int, features: int,
                 upsample_factor: int = 2, activation: str = "relu",
                 icnrinit: bool = False, gauss_blur_sd: Optional[float] = None,
                 gauss_ksz: int = 3, s2d_output: bool = False):
        super().__init__()
        r = upsample_factor
        if s2d_output and r % 2:
            raise ValueError(f"s2d_output needs an even upsample factor, "
                             f"got {r}")
        self.r = r
        self.icnrinit = icnrinit
        self.s2d_output = s2d_output
        self.Conv_0 = nn.Conv2d(in_features, features * r * r, 1,
                                bias=not icnrinit)
        self.act = get_activation(activation)
        if s2d_output:
            self.register_buffer("s2d_perm",
                                 s2d_shuffle_permutation(features, r),
                                 persistent=False)
        if gauss_blur_sd is not None:
            k = gauss_2d(gauss_ksz, gauss_blur_sd, (0.0, 0.0), density=True)[0]
            self.register_buffer("blur", (k / k.sum())[None, None],
                                 persistent=False)
        else:
            self.blur = None

    def _blur(self, x):
        """Depthwise Gaussian blur of a fine ``[B, H, W, C]`` tensor."""
        C = x.shape[-1]
        k = self.blur.to(x.dtype).expand(C, 1, -1, -1)
        return F.conv2d(x.permute(0, 3, 1, 2), k,
                        padding=self.blur.shape[-1] // 2,
                        groups=C).permute(0, 2, 3, 1)

    def forward(self, x):
        x = conv_nhwc(self.Conv_0, x)
        if self.act is not None:
            x = self.act(x)
        if not self.s2d_output:
            x = pixel_shuffle(x, self.r)
            return self._blur(x) if self.blur is not None else x
        x = pixel_shuffle(x.index_select(-1, self.s2d_perm), self.r // 2)
        if self.blur is not None:
            x = space_to_depth_phase_major(
                self._blur(depth_to_space_phase_major(x)))
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


# ---------------------------------------------------------------------------
# The phase-major space-to-depth-2 layout (``dbsr_tpu/models/layers.py``):
# channel ``(qy*2 + qx)*C + c`` of coarse pixel ``(Y, X)`` holds fine pixel
# ``(2Y+qy, 2X+qx)``, channel ``c``, so each fine phase is a contiguous block
# of channels.


def _phase_taps(k: int, device) -> torch.Tensor:
    """``[2, 2, ksz, k]`` 0/1: for output phase ``p``, input phase ``q`` and
    coarse tap ``d``, 1 at the fine tap ``u = 2(d - span) + q - p + span``
    (``span = k // 2``, ``ksz = 2 * span + 1``)."""
    span = k // 2
    ksz = 2 * span + 1
    p = torch.arange(2, device=device).view(2, 1, 1, 1)
    q = torch.arange(2, device=device).view(1, 2, 1, 1)
    d = torch.arange(ksz, device=device).view(1, 1, ksz, 1)
    u = torch.arange(k, device=device).view(1, 1, 1, k)
    return (u == 2 * (d - span) + q - p + span).float()


def s2d_conv_kernel(weight: torch.Tensor) -> torch.Tensor:
    """The coarse kernel over the s2d layout of a fine ``[O, C, k, k]``
    (OIHW, ``k`` 1 or 3) stride-1 SAME conv: ``[4O, 4C, 3, 3]`` for 3x3,
    the block-diagonal ``[4O, 4C, 1, 1]`` for 1x1; the JAX package's
    ``s2d_conv_kernel`` in OIHW. Built by 0/1 selections times the weight
    and a sum with at most one non-zero term, so every entry is exactly a
    weight or zero; differentiable in ``weight``."""
    O, C, kh, kw = weight.shape
    if kh != kw or kh not in (1, 3):
        raise ValueError(f"s2d_conv_kernel: a 1x1 or 3x3 kernel, got "
                         f"{tuple(weight.shape)}")
    a = _phase_taps(kh, weight.device).to(weight.dtype)
    ksz = a.shape[2]
    # dims [py, px, o, qy, qx, c, dy, dx, u, v]
    sel = (a.view(2, 1, 1, 2, 1, 1, ksz, 1, kh, 1)
           * a.view(1, 2, 1, 1, 2, 1, 1, ksz, 1, kh))
    k = (sel * weight.view(1, 1, O, 1, 1, C, 1, 1, kh, kh)).sum((-2, -1))
    return k.reshape(4 * O, 4 * C, ksz, ksz)


def s2d_shuffle_permutation(c_out: int, r: int) -> torch.Tensor:
    """Channel permutation folding space-to-depth into the pixel shuffle:
    ``pixel_shuffle(x[..., perm], r // 2)`` is the phase-major s2d layout of
    ``pixel_shuffle(x, r)``; position ``((qy*2 + qx)*C + c)*(r/2)^2 +
    di*(r/2) + dj`` takes channel ``c*r^2 + (2di+qy)*r + (2dj+qx)``."""
    rc = r // 2
    perm = [c * r * r + (2 * di + qy) * r + (2 * dj + qx)
            for qy in range(2) for qx in range(2) for c in range(c_out)
            for di in range(rc) for dj in range(rc)]
    return torch.tensor(perm, dtype=torch.long)


def depth_to_space_phase_major(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """``[..., H, W, r*r*C]`` with channel ``(qy*r + qx)*C + c`` ->
    ``[..., H*r, W*r, C]``."""
    *lead, H, W, RC = x.shape
    C = RC // (r * r)
    x = x.reshape(*lead, H, W, r, r, C).movedim(-3, -4)
    return x.reshape(*lead, H * r, W * r, C)


def space_to_depth_phase_major(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """The inverse of :func:`depth_to_space_phase_major`."""
    *lead, H, W, C = x.shape
    x = x.reshape(*lead, H // r, r, W // r, r, C).movedim(-4, -3)
    return x.reshape(*lead, H // r, W // r, r * r * C)
