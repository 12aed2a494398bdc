"""PWC-Net optical flow (a frozen copy of the port's ``models/pwcnet.py``,
float32, its cost volume and warp the plain ones).

A 6-level feature pyramid, coarse-to-fine decoders at levels 6..2 with an
81-channel cost volume each, DenseNet-style aggregation, a dilated-conv
context refiner, and the wrapper that resizes the inputs to the next
multiple of 64 and rescales the (x20) flow back to the input's pixels.
Levels 5..2 upsample the coarser flow and features with 4x4 stride-2
transposed convs and backwarp the second image's features by the
upsampled flow times ``20 / 2^level``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import ConvBlock, TorchConvTranspose
from benchmark.reference.plain import NUM_OFFSETS, cost_volume
from benchmark.reference.interp import backwarp, resize_bilinear

# feature channels of pyramid levels 1..6
PYRAMID_CH = (16, 32, 64, 96, 128, 196)
# the upsampled flow's scale before the backwarp, by decoder level (20/2^L)
BACKWARP_SCALE = {2: 5.0, 3: 2.5, 4: 1.25, 5: 0.625}
# the decoders' dense stages and the refiner's (channels, dilation) stages
DENSE_CH = (128, 128, 96, 64, 32)
REFINER_STAGES = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))
LEVELS = (6, 5, 4, 3, 2)


def decoder_in_channels(level: int) -> int:
    """The input channels of the decoder at ``level``: the cost volume, and
    below level 6 the pyramid features, the up-flow and the up-feature."""
    if level == 6:
        return NUM_OFFSETS
    return NUM_OFFSETS + PYRAMID_CH[level - 1] + 2 + 2


def decoder_feat_channels(level: int) -> int:
    """The channels of the decoder's dense feature (its input and every
    dense stage's output)."""
    return decoder_in_channels(level) + sum(DENSE_CH)


def _leaky(x):
    return F.leaky_relu(x, 0.1)


def _conv(in_features, features, stride=1, dilation=1):
    return ConvBlock(in_features, features, 3, stride=stride,
                     dilation=dilation, activation="none")


class Extractor(nn.Module):
    """6-level strided conv pyramid: per level a stride-2 conv and two
    stride-1 convs, each followed by a leaky ReLU (0.1)."""

    def __init__(self):
        super().__init__()
        cin = 3
        for lvl, ch in enumerate(PYRAMID_CH, start=1):
            self.add_module(f"lvl{lvl}_conv0", _conv(cin, ch, stride=2))
            self.add_module(f"lvl{lvl}_conv1", _conv(ch, ch))
            self.add_module(f"lvl{lvl}_conv2", _conv(ch, ch))
            cin = ch

    def forward(self, x):
        feats = []
        for lvl in range(1, len(PYRAMID_CH) + 1):
            for j in range(3):
                x = _leaky(getattr(self, f"lvl{lvl}_conv{j}")(x))
            feats.append(x)
        return feats


class Decoder(nn.Module):
    """One coarse-to-fine decoder level: the cost volume (level 6 against
    the unwarped second features; below it against the second features
    backwarped by the up-convolved coarser flow), five dense stages each
    concatenating its output before its input, and a 2-channel flow head.
    Returns ``{"flow", "feat"}``."""

    def __init__(self, level: int):
        super().__init__()
        self.level = level
        if level < 6:
            self.upflow = TorchConvTranspose(2, 2)
            self.upfeat = TorchConvTranspose(decoder_feat_channels(level + 1),
                                             2)
        cin = decoder_in_channels(level)
        for i, ch in enumerate(DENSE_CH):
            self.add_module(f"dense{i}", _conv(cin, ch))
            cin += ch
        self.flow_head = _conv(cin, 2)

    def forward(self, feat_first, feat_second, prev):
        if prev is None:
            feat = _leaky(cost_volume(feat_first, feat_second))
        else:
            flow_up = self.upflow(prev["flow"])
            feat_up = self.upfeat(prev["feat"])
            warped = backwarp(feat_second,
                              flow_up * BACKWARP_SCALE[self.level])
            volume = _leaky(cost_volume(feat_first, warped))
            feat = torch.cat([volume, feat_first, flow_up, feat_up], dim=-1)
        for i in range(len(DENSE_CH)):
            out = _leaky(getattr(self, f"dense{i}")(feat))
            feat = torch.cat([out, feat], dim=-1)
        return {"flow": self.flow_head(feat), "feat": feat}


class Refiner(nn.Module):
    """Dilated-conv context network on level 2's dense feature."""

    def __init__(self):
        super().__init__()
        cin = decoder_feat_channels(2)
        for i, (ch, dil) in enumerate(REFINER_STAGES):
            self.add_module(f"ctx{i}", _conv(cin, ch, dilation=dil))
            cin = ch
        self.ctx_flow = _conv(cin, 2)

    def forward(self, x):
        for i in range(len(REFINER_STAGES)):
            x = _leaky(getattr(self, f"ctx{i}")(x))
        return self.ctx_flow(x)


class PWCFlowNet(nn.Module):
    """The core network: ``(im_first, im_second) -> raw level-2 flow``
    (1/4 resolution, in units of 1/20 input pixel) for ``[B, H, W, 3]``
    images with H, W multiples of 64.

    ``first_repeat > 1``: every ``first_repeat`` consecutive ``im_second``
    entries share one ``im_first``, whose pyramid is extracted once and
    repeated. With ``return_pyramid`` also ``{level: raw flow}``, level 2
    the refined flow."""

    def __init__(self):
        super().__init__()
        self.extractor = Extractor()
        for lvl in LEVELS:
            self.add_module(f"dec{lvl}", Decoder(lvl))
        self.refiner = Refiner()

    def forward(self, im_first, im_second, return_pyramid: bool = False,
                first_repeat: int = 1):
        f1 = self.extractor(im_first)
        f2 = self.extractor(im_second)
        if first_repeat > 1:
            f1 = [f.repeat_interleave(first_repeat, dim=0) for f in f1]
        pyramid = {}
        est = None
        for lvl in LEVELS:
            est = getattr(self, f"dec{lvl}")(f1[lvl - 1], f2[lvl - 1], est)
            pyramid[lvl] = est["flow"]
        flow = est["flow"] + self.refiner(est["feat"])
        if return_pyramid:
            pyramid[2] = flow  # the refined level-2 flow is supervised
            return flow, pyramid
        return flow


class PWCNet(nn.Module):
    """``(source, target) -> flow [..., H, W, 2]`` in input pixels, with
    ``target(p) ~= source(p + flow(p))``: the inputs resized to the next
    multiple of 64, ``net(target, source)``, the level-2 flow x20, resized
    to (H, W) and scaled per axis by W/Wp and H/Hp.

    ``target_repeat > 1``: every ``target_repeat`` consecutive sources share
    one target (its leading size is then ``sources / target_repeat``). With
    ``return_pyramid`` it returns ``(flow, {"pyramid": {level: raw flow},
    "preprocessed_hw": (Hp, Wp)})``: every raw flow is in 1/20 of a
    preprocessed-grid pixel."""

    def __init__(self):
        super().__init__()
        self.net = PWCFlowNet()

    def forward(self, source_img, target_img, return_pyramid: bool = False,
                target_repeat: int = 1):
        if source_img.shape[-3:] != target_img.shape[-3:]:
            raise ValueError(f"source {tuple(source_img.shape)} and target "
                             f"{tuple(target_img.shape)} frame shapes differ")
        lead = source_img.shape[:-3]
        H, W = source_img.shape[-3], source_img.shape[-2]
        src = source_img.reshape((-1, H, W, 3))
        tgt = target_img.reshape((-1, H, W, 3))
        if tgt.shape[0] * target_repeat != src.shape[0]:
            raise ValueError(f"{src.shape[0]} sources vs {tgt.shape[0]} "
                             f"targets x target_repeat {target_repeat}")
        Hp = int(math.ceil(H / 64.0) * 64)
        Wp = int(math.ceil(W / 64.0) * 64)
        if (Hp, Wp) != (H, W):
            src = resize_bilinear(src, (Hp, Wp))
            tgt = resize_bilinear(tgt, (Hp, Wp))
        out = self.net(tgt, src, return_pyramid=return_pyramid,
                       first_repeat=target_repeat)
        raw, pyramid = out if return_pyramid else (out, None)
        flow = 20.0 * resize_bilinear(raw, (H, W))
        scale = torch.tensor([W / Wp, H / Hp], dtype=flow.dtype,
                             device=flow.device)
        flow = (flow * scale).reshape(lead + (H, W, 2))
        if return_pyramid:
            pyramid = {lvl: f.reshape(lead + f.shape[-3:])
                       for lvl, f in pyramid.items()}
            return flow, {"pyramid": pyramid, "preprocessed_hw": (Hp, Wp)}
        return flow
