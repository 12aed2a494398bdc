"""AlignLite, the 3-level siamese correlation aligner (a frozen copy of the
port's ``models/align_lite.py``, float32, its cost volume and warp the
plain ones).

``AlignLiteNet(source, target) -> flow [..., H, W, 2]`` in input pixels,
with ``target(p) ~= source(p + flow(p))``. Each level correlates with the
81-channel cost volume; the finer levels backwarp the source features by
the upsampled coarser flow first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import ConvBlock
from benchmark.reference.plain import NUM_OFFSETS, cost_volume
from benchmark.reference.interp import backwarp, resize_bilinear

# feature channels at pyramid levels 0 (full res), 1 (1/2), 2 (1/4)
FEAT_CH = (24, 48, 96)
# decoder conv widths per level
DEC_CH = {2: (96, 64), 1: (64, 48), 0: (48, 32)}


def _leaky(x):
    return F.leaky_relu(x, 0.1)


def _conv(in_features, features, stride=1, dilation=1):
    return ConvBlock(in_features, features, 3, stride=stride,
                     dilation=dilation, activation="none")


class LiteExtractor(nn.Module):
    """Shared (siamese) 3-level feature pyramid."""

    def __init__(self):
        super().__init__()
        cin = 3
        for lvl, ch in enumerate(FEAT_CH):
            self.add_module(f"lvl{lvl}_conv0",
                            _conv(cin, ch, stride=1 if lvl == 0 else 2))
            self.add_module(f"lvl{lvl}_conv1", _conv(ch, ch))
            cin = ch

    def forward(self, x):
        feats = []
        for lvl in range(len(FEAT_CH)):
            x = _leaky(getattr(self, f"lvl{lvl}_conv0")(x))
            x = _leaky(getattr(self, f"lvl{lvl}_conv1")(x))
            feats.append(x)
        return feats


class LiteDecoder(nn.Module):
    """One refinement level: correlate, predict flow (level 2) or a flow
    delta (levels 1, 0) in this level's pixels."""

    def __init__(self, level: int):
        super().__init__()
        self.level = level
        cin = NUM_OFFSETS + FEAT_CH[level] + (0 if level == 2 else 2)
        for i, ch in enumerate(DEC_CH[level]):
            self.add_module(f"dec{i}", _conv(cin, ch))
            cin = ch
        self.flow_head = _conv(cin, 2)

    def forward(self, feat_tgt, feat_src, flow_up):
        if flow_up is None:
            volume = _leaky(cost_volume(feat_tgt, feat_src))
            x = torch.cat([volume, feat_tgt], dim=-1)
        else:
            warped = backwarp(feat_src, flow_up)
            volume = _leaky(cost_volume(feat_tgt, warped))
            x = torch.cat([volume, feat_tgt, flow_up], dim=-1)
        for i in range(len(DEC_CH[self.level])):
            x = _leaky(getattr(self, f"dec{i}")(x))
        delta = self.flow_head(x)
        flow = delta if flow_up is None else flow_up + delta
        return flow, x


class LiteRefiner(nn.Module):
    """Dilated-conv context refinement at full resolution."""

    def __init__(self, in_features: int):
        super().__init__()
        self.dils = (1, 2, 4)
        cin = in_features
        for i, dil in enumerate(self.dils):
            self.add_module(f"ctx{i}", _conv(cin, 32, dilation=dil))
            cin = 32
        self.ctx_flow = _conv(cin, 2)

    def forward(self, x):
        for i in range(len(self.dils)):
            x = _leaky(getattr(self, f"ctx{i}")(x))
        return self.ctx_flow(x)


class AlignLiteNet(nn.Module):
    """``(source, target) -> flow [..., H, W, 2]``; H and W multiples of 4.

    ``target_repeat > 1`` declares that every ``target_repeat`` consecutive
    sources share one target (N-1 burst frames against one reference):
    ``target``'s leading size is then ``sources / target_repeat`` and its
    pyramid is extracted once per target and repeated.

    With ``return_pyramid=True`` it returns ``(flow, {"pyramid": {2: ..,
    1: .., 0: ..}})``: each level's flow in its own grid's pixels, level 0
    the refined full-resolution flow, for multi-scale supervision."""

    def __init__(self):
        super().__init__()
        self.extractor = LiteExtractor()
        for lvl in (2, 1, 0):
            self.add_module(f"dec{lvl}", LiteDecoder(lvl))
        self.refiner = LiteRefiner(DEC_CH[0][-1] + 2)

    def forward(self, source_img, target_img, target_repeat: int = 1,
                return_pyramid: bool = False):
        if source_img.shape[-3:] != target_img.shape[-3:]:
            raise ValueError(f"source {tuple(source_img.shape)} and target "
                             f"{tuple(target_img.shape)} frame shapes differ")
        lead = source_img.shape[:-3]
        H, W = source_img.shape[-3], source_img.shape[-2]
        if H % 4 or W % 4:
            raise ValueError(f"AlignLiteNet needs H, W multiples of 4: {H, W}")
        src = source_img.reshape((-1,) + source_img.shape[-3:])
        tgt = target_img.reshape((-1,) + target_img.shape[-3:])
        if tgt.shape[0] * target_repeat != src.shape[0]:
            raise ValueError(f"{src.shape[0]} sources vs {tgt.shape[0]} "
                             f"targets x target_repeat {target_repeat}")

        f_src = self.extractor(src)
        f_tgt = self.extractor(tgt)
        if target_repeat > 1:
            f_tgt = [f.repeat_interleave(target_repeat, dim=0) for f in f_tgt]

        pyramid = {}
        flow = None
        for lvl in (2, 1, 0):
            if flow is not None:
                lh, lw = f_tgt[lvl].shape[-3:-1]
                # x2: coarser-grid px -> this grid's px
                flow = resize_bilinear(flow, (lh, lw)) * 2.0
            flow, feat = getattr(self, f"dec{lvl}")(f_tgt[lvl], f_src[lvl],
                                                    flow)
            pyramid[lvl] = flow
        flow = flow + self.refiner(torch.cat([feat, flow], dim=-1))
        pyramid[0] = flow  # the refined full-resolution flow is supervised

        flow = flow.float().reshape(lead + (H, W, 2))
        if return_pyramid:
            return flow, {"pyramid": {
                lvl: f.float().reshape(lead + f.shape[-3:])
                for lvl, f in pyramid.items()}}
        return flow
