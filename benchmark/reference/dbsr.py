"""DBSR network of the plain reference (a frozen copy of the port's
``models/dbsr.py``, float32, the decoder at fine resolution, the warp and
the merge the plain ones): encoder + alignment, attention fusion,
pixel-shuffle decoder.

``burst`` is ``[B, N, h, w, 4]`` packed RGGB; frames are flattened into the
batch for the per-frame convs. The aligner (``flow_net='lite'``, AlignLite,
or ``'pwc'``, PWC-Net) is frozen unless ``train_alignment``: its flow is
computed without gradient and its parameters do not require one. The
constructor takes a checkpoint's ``net_spec`` kwargs; ``dtype`` and
``fused_s2d_decoder`` name the program's forms of the same function and are
ignored here.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from benchmark.reference.align_lite import AlignLiteNet
from benchmark.reference.camera import demosaic_naive
from benchmark.reference.layers import ConvBlock, PixShuffleUpsampler, ResBlock
from benchmark.reference.plain import fused_softmax_merge, warp_feat
from benchmark.reference.pwcnet import PWCNet


def _flatten_frames(x):
    """[B, N, h, w, c] -> [B*N, h, w, c]"""
    return x.reshape((-1,) + x.shape[-3:])


class ResEncoder(nn.Module):
    """Per-frame embedding: conv -> ``num_res_blocks`` x ResBlock -> conv."""

    def __init__(self, in_dim: int = 4, init_dim: int = 64,
                 num_res_blocks: int = 9, out_dim: int = 512,
                 activation: str = "relu"):
        super().__init__()
        self.num_res_blocks = num_res_blocks
        self.ConvBlock_0 = ConvBlock(in_dim, init_dim, 3, activation=activation)
        for i in range(num_res_blocks):
            self.add_module(f"ResBlock_{i}", ResBlock(init_dim, activation))
        self.ConvBlock_1 = ConvBlock(init_dim, out_dim, 3, activation=activation)

    def forward(self, x):
        x = self.ConvBlock_0(x)
        for i in range(self.num_res_blocks):
            x = getattr(self, f"ResBlock_{i}")(x)
        return self.ConvBlock_1(x)


class AlignedEncoder(nn.Module):
    """Encode the burst frames and warp the non-reference embeddings to the
    reference frame by the aligner's flow. Returns ``ref_feat``,
    ``oth_feat`` (warped) and ``offsets`` (the flow)."""

    def __init__(self, init_dim: int = 64, num_res_blocks: int = 9,
                 out_dim: int = 512, activation: str = "relu",
                 train_alignment: bool = False, flow_net: str = "pwc"):
        super().__init__()
        self.train_alignment = train_alignment
        self.alignment_net = {"pwc": PWCNet, "lite": AlignLiteNet}[flow_net]()
        self.embed = ResEncoder(4, init_dim, num_res_blocks, out_dim,
                                activation)

    def forward(self, burst):
        B, N = burst.shape[0], burst.shape[1]
        rgb = demosaic_naive(burst)
        with torch.set_grad_enabled(self.train_alignment
                                    and torch.is_grad_enabled()):
            flow = self.alignment_net(_flatten_frames(rgb[:, 1:]), rgb[:, 0],
                                      target_repeat=N - 1)
        feat = self.embed(_flatten_frames(burst))
        feat = feat.reshape((B, N) + feat.shape[-3:])
        oth = warp_feat(_flatten_frames(feat[:, 1:]), flow)
        return {"ref_feat": feat[:, :1],
                "oth_feat": oth.reshape((B, N - 1) + oth.shape[-3:]),
                "offsets": flow.reshape((B, N - 1) + flow.shape[-3:])}


class WeightedSumMerge(nn.Module):
    """Attention-weighted burst fusion: project embeddings, take residuals
    against the reference-frame projection, embed the sub-pixel offsets
    (mod ``offset_modulo``; the reference frame's are zeros), predict
    per-pixel per-frame logits over ``input_dim`` channels, softmax over
    the frames and sum."""

    def __init__(self, input_dim: int = 512, project_dim: int = 64,
                 offset_feat_dim: int = 64,
                 num_offset_feat_extractor_res: int = 1,
                 num_weight_predictor_res: int = 3,
                 offset_modulo: Optional[float] = 1.0,
                 activation: str = "relu"):
        super().__init__()
        self.offset_modulo = offset_modulo
        self.num_offset_res = num_offset_feat_extractor_res
        self.num_weight_res = num_weight_predictor_res
        self.feat_project = ConvBlock(input_dim, project_dim, 1,
                                      activation=activation)
        self.offset_conv = ConvBlock(2, offset_feat_dim, 3,
                                     activation=activation)
        for i in range(num_offset_feat_extractor_res):
            self.add_module(f"offset_res{i}",
                            ResBlock(offset_feat_dim, activation))
        self.weight_conv = ConvBlock(2 * project_dim + offset_feat_dim,
                                     2 * project_dim, 3,
                                     activation=activation)
        for i in range(num_weight_predictor_res):
            self.add_module(f"weight_res{i}",
                            ResBlock(2 * project_dim, activation))
        self.weight_out = ConvBlock(2 * project_dim, input_dim, 3,
                                    activation="none")

    def forward(self, enc):
        ref_feat, oth_feat, offsets = (enc["ref_feat"], enc["oth_feat"],
                                       enc["offsets"])
        B = ref_feat.shape[0]
        all_feat = torch.cat([ref_feat, oth_feat], dim=1)
        N = all_feat.shape[1]

        proj = self.feat_project(_flatten_frames(all_feat))
        proj = proj.reshape((B, N) + proj.shape[-3:])
        base = proj[:, :1]
        diff = _flatten_frames(proj - base)
        base_b = _flatten_frames(base.expand((B, N) + base.shape[-3:]))

        offs = torch.cat([torch.zeros_like(offsets[:, :1]), offsets], dim=1)
        offs = _flatten_frames(offs)
        if self.offset_modulo is not None:
            offs = torch.remainder(offs, self.offset_modulo)
        x = self.offset_conv(offs)
        for i in range(self.num_offset_res):
            x = getattr(self, f"offset_res{i}")(x)

        x = self.weight_conv(torch.cat([base_b, diff, x], dim=-1))
        for i in range(self.num_weight_res):
            x = getattr(self, f"weight_res{i}")(x)
        logits = self.weight_out(x)
        logits = logits.reshape((B, N) + logits.shape[-3:])
        return fused_softmax_merge(all_feat, logits)


class PixShuffleDecoder(nn.Module):
    """conv -> pre ResBlocks -> PixShuffle x r -> post ResBlocks -> 1x1 conv
    to linear RGB, ending in ``final_activation``."""

    def __init__(self, in_dim: int = 512, init_conv_dim: int = 64,
                 num_pre_res_blocks: int = 5, post_conv_dim: int = 32,
                 num_post_res_blocks: int = 4, upsample_factor: int = 8,
                 icnrinit: bool = True, gauss_blur_sd: Optional[float] = 1.0,
                 gauss_ksz: int = 3, activation: str = "relu",
                 final_activation: str = "relu"):
        super().__init__()
        self.n_pre = num_pre_res_blocks
        self.n_post = num_post_res_blocks
        self.ConvBlock_0 = ConvBlock(in_dim, init_conv_dim, 3,
                                     activation=activation)
        for i in range(num_pre_res_blocks):
            self.add_module(f"ResBlock_{i}", ResBlock(init_conv_dim, activation))
        self.PixShuffleUpsampler_0 = PixShuffleUpsampler(
            init_conv_dim, post_conv_dim, upsample_factor, activation,
            icnrinit, gauss_blur_sd, gauss_ksz)
        for i in range(num_post_res_blocks):
            self.add_module(f"ResBlock_{num_pre_res_blocks + i}",
                            ResBlock(post_conv_dim, activation))
        self.ConvBlock_1 = ConvBlock(post_conv_dim, 3, 1,
                                     activation=final_activation)

    def forward(self, fused):
        x = self.ConvBlock_0(fused)
        for i in range(self.n_pre):
            x = getattr(self, f"ResBlock_{i}")(x)
        x = self.PixShuffleUpsampler_0(x)
        for i in range(self.n_pre, self.n_pre + self.n_post):
            x = getattr(self, f"ResBlock_{i}")(x)
        return self.ConvBlock_1(x)


class DBSRNet(nn.Module):
    """``forward(burst [B, N, h, w, 4]) -> pred [B, r*h, r*w, 3]`` in
    float32. Fields as the checkpoints' ``net_spec`` records them; the
    variants these configurations do not use raise."""

    def __init__(self, enc_init_dim: int = 64, enc_num_res_blocks: int = 9,
                 enc_out_dim: int = 512, dec_init_conv_dim: int = 64,
                 dec_num_pre_res_blocks: int = 5, dec_post_conv_dim: int = 32,
                 dec_num_post_res_blocks: int = 4, upsample_factor: int = 8,
                 offset_feat_dim: int = 64, weight_pred_proj_dim: int = 64,
                 num_offset_feat_extractor_res: int = 1,
                 num_weight_predictor_res: int = 3,
                 offset_modulo: Optional[float] = 1.0, use_offset: bool = True,
                 softmax: bool = True, use_base_frame: bool = True,
                 ref_offset_noise: float = 0.0, final_activation: str = "relu",
                 icnrinit: bool = True, gauss_blur_sd: Optional[float] = 1.0,
                 gauss_ksz: int = 3, activation: str = "relu",
                 train_alignment: bool = False, dtype=None,
                 fused_s2d_decoder: bool = False, flow_net: str = "pwc"):
        super().__init__()
        if not (use_offset and softmax and use_base_frame) \
                or ref_offset_noise:
            raise NotImplementedError("the reference runs the configured "
                                      "DBSRNet: offsets, softmax, base frame")
        self.encoder = AlignedEncoder(enc_init_dim, enc_num_res_blocks,
                                      enc_out_dim, activation,
                                      train_alignment, flow_net)
        self.merging = WeightedSumMerge(
            enc_out_dim, weight_pred_proj_dim, offset_feat_dim,
            num_offset_feat_extractor_res, num_weight_predictor_res,
            offset_modulo, activation)
        self.decoder = PixShuffleDecoder(
            enc_out_dim, dec_init_conv_dim, dec_num_pre_res_blocks,
            dec_post_conv_dim, dec_num_post_res_blocks, upsample_factor,
            icnrinit, gauss_blur_sd, gauss_ksz, activation, final_activation)
        if not train_alignment:
            self.encoder.alignment_net.requires_grad_(False)

    def forward(self, burst):
        return self.decoder(self.merging(self.encoder(burst))).float()
