"""DBSR network: encoder + alignment, attention fusion, pixel-shuffle
decoder (port of ``dbsr_tpu/models/dbsr.py``, the ``flow_net='lite'``
serving forward).

``burst`` is ``[B, N, h, w, 4]`` packed RGGB; frames are flattened into the
batch for the per-frame convs. Three CUDA kernels run on the forward for
CUDA tensors: the 512-channel feature warp (``ops/warp.py``), AlignLite's
cost volumes (``ops/correlation.py``) and the frame-softmax merge
(``ops/merge.py``); in training, the warp's d_feat and the merge's backward
kernels run on the backward. By default the aligner is frozen: its flow is
computed without gradient and its parameters do not require one. With
``train_alignment=True`` the flow carries a gradient, and the backward also
launches the warp's d_flow and, inside the aligner, the cost volume's
d_first and d_second kernels. With ``fused_s2d_decoder=True`` the decoder's
stage after the pixel shuffle runs on the phase-major space-to-depth-2
layout; with ``DBSR_FINE_PATCH_S2D=1`` its 3x3 convs launch the fine-patch
conv kernel (``ops/conv_s2d.py``) in the forward and again as d_input in the
backward.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dbsr_tpu_torch.models.align_lite import AlignLiteNet
from dbsr_tpu_torch.models.layers import (ConvBlock, PixShuffleUpsampler,
                                          ResBlock, depth_to_space_phase_major)
from dbsr_tpu_torch.ops.camera import demosaic_naive, uniform
from dbsr_tpu_torch.ops.merge import fused_softmax_merge
from dbsr_tpu_torch.ops.warp import warp_feat


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
    reference frame by AlignLite's flow, computed without gradient unless
    ``train_alignment``. Returns ``ref_feat`` ``[B, 1, h, w, C]``,
    ``oth_feat`` ``[B, N-1, h, w, C]`` (warped) and ``offsets``
    ``[B, N-1, h, w, 2]``."""

    def __init__(self, init_dim: int = 64, num_res_blocks: int = 9,
                 out_dim: int = 512, activation: str = "relu",
                 train_alignment: bool = False):
        super().__init__()
        self.train_alignment = train_alignment
        self.alignment_net = AlignLiteNet()
        self.embed = ResEncoder(4, init_dim, num_res_blocks, out_dim,
                                activation)

    def forward(self, burst):
        if burst.ndim != 5 or burst.shape[-1] != 4:
            raise ValueError(f"expected [B, N, h, w, 4] packed burst, got "
                             f"{tuple(burst.shape)}")
        B, N = burst.shape[0], burst.shape[1]
        rgb = demosaic_naive(burst)
        with torch.set_grad_enabled(self.train_alignment
                                    and torch.is_grad_enabled()):
            flow = self.alignment_net(_flatten_frames(rgb[:, 1:]), rgb[:, 0],
                                      target_repeat=N - 1)
        feat = self.embed(_flatten_frames(burst))
        feat = feat.reshape((B, N) + feat.shape[-3:])
        oth = warp_feat(_flatten_frames(feat[:, 1:]).contiguous(),
                        flow.contiguous())
        return {"ref_feat": feat[:, :1],
                "oth_feat": oth.reshape((B, N - 1) + oth.shape[-3:]),
                "offsets": flow.reshape((B, N - 1) + flow.shape[-3:])}


class WeightedSumMerge(nn.Module):
    """Attention-weighted burst fusion: project embeddings, take residuals
    against the base (reference-frame projection, or the frame mean),
    embed the sub-pixel offsets (mod ``offset_modulo``), predict per-pixel
    per-frame logits over ``input_dim`` channels, softmax over the frames
    and sum (``ops/merge.py``).

    The reference frame's offsets are zeros, or ``ref_offsets``
    ``[B, 1, h, w, 2]`` when the caller passes a draw of
    :func:`draw_ref_offset_noise` (so that the net cannot find the
    reference frame by "offset exactly 0")."""

    def __init__(self, input_dim: int = 512, project_dim: int = 64,
                 offset_feat_dim: int = 64,
                 num_offset_feat_extractor_res: int = 1,
                 num_weight_predictor_res: int = 3, use_offset: bool = True,
                 offset_modulo: Optional[float] = 1.0,
                 use_base_frame: bool = True, activation: str = "relu"):
        super().__init__()
        self.use_offset = use_offset
        self.offset_modulo = offset_modulo
        self.use_base_frame = use_base_frame
        self.num_offset_res = num_offset_feat_extractor_res
        self.num_weight_res = num_weight_predictor_res
        self.feat_project = ConvBlock(input_dim, project_dim, 1,
                                      activation=activation)
        pred_in = 2 * project_dim
        if use_offset:
            self.offset_conv = ConvBlock(2, offset_feat_dim, 3,
                                         activation=activation)
            for i in range(num_offset_feat_extractor_res):
                self.add_module(f"offset_res{i}",
                                ResBlock(offset_feat_dim, activation))
            pred_in += offset_feat_dim
        self.weight_conv = ConvBlock(pred_in, 2 * project_dim, 3,
                                     activation=activation)
        for i in range(num_weight_predictor_res):
            self.add_module(f"weight_res{i}",
                            ResBlock(2 * project_dim, activation))
        self.weight_out = ConvBlock(2 * project_dim, input_dim, 3,
                                    activation="none")

    def forward(self, enc, return_fusion_weights: bool = False,
                ref_offsets: Optional[torch.Tensor] = None):
        ref_feat, oth_feat, offsets = (enc["ref_feat"], enc["oth_feat"],
                                       enc["offsets"])
        B = ref_feat.shape[0]
        all_feat = torch.cat([ref_feat, oth_feat], dim=1)
        N = all_feat.shape[1]

        proj = self.feat_project(_flatten_frames(all_feat))
        proj = proj.reshape((B, N) + proj.shape[-3:])
        base = (proj[:, :1] if self.use_base_frame
                else proj.mean(dim=1, keepdim=True))
        diff = _flatten_frames(proj - base)
        base_b = _flatten_frames(base.expand((B, N) + base.shape[-3:]))

        pred_in = [base_b, diff]
        if self.use_offset:
            if ref_offsets is None:
                ref_offsets = torch.zeros_like(offsets[:, :1])
            elif ref_offsets.shape != offsets[:, :1].shape:
                raise ValueError(f"ref_offsets {tuple(ref_offsets.shape)} vs "
                                 f"{tuple(offsets[:, :1].shape)}")
            offs = torch.cat([ref_offsets.to(offsets.dtype), offsets], dim=1)
            offs = _flatten_frames(offs)
            if self.offset_modulo is not None:
                # floor-mod, as jnp's %, never torch.fmod
                offs = torch.remainder(offs, self.offset_modulo)
            x = self.offset_conv(offs)
            for i in range(self.num_offset_res):
                x = getattr(self, f"offset_res{i}")(x)
            pred_in.append(x)

        x = self.weight_conv(torch.cat(pred_in, dim=-1))
        for i in range(self.num_weight_res):
            x = getattr(self, f"weight_res{i}")(x)
        logits = self.weight_out(x)
        logits = logits.reshape((B, N) + logits.shape[-3:])

        out = {"fused_enc": fused_softmax_merge(all_feat.contiguous(),
                                                logits.contiguous())}
        if return_fusion_weights:
            out["fusion_weights"] = torch.softmax(logits.float(), dim=1)
        return out


class PixShuffleDecoder(nn.Module):
    """conv -> pre ResBlocks -> PixShuffle x r -> post ResBlocks -> 1x1 conv
    to linear RGB, ending in a ReLU (the reference's final conv block has
    the default activation). With ``fused_s2d`` and an even ``r`` the stage
    after the shuffle runs on the phase-major s2d layout and ends in
    ``depth_to_space_phase_major``: the same function and parameters."""

    def __init__(self, in_dim: int = 512, init_conv_dim: int = 64,
                 num_pre_res_blocks: int = 5, post_conv_dim: int = 32,
                 num_post_res_blocks: int = 4, upsample_factor: int = 8,
                 icnrinit: bool = True, gauss_blur_sd: Optional[float] = 1.0,
                 gauss_ksz: int = 3, activation: str = "relu",
                 final_activation: str = "relu", fused_s2d: bool = False):
        super().__init__()
        self.n_pre = num_pre_res_blocks
        self.n_post = num_post_res_blocks
        self.s2d = s2d = fused_s2d and upsample_factor % 2 == 0
        self.ConvBlock_0 = ConvBlock(in_dim, init_conv_dim, 3,
                                     activation=activation)
        for i in range(num_pre_res_blocks):
            self.add_module(f"ResBlock_{i}", ResBlock(init_conv_dim, activation))
        self.PixShuffleUpsampler_0 = PixShuffleUpsampler(
            init_conv_dim, post_conv_dim, upsample_factor, activation,
            icnrinit, gauss_blur_sd, gauss_ksz, s2d_output=s2d)
        for i in range(num_post_res_blocks):
            self.add_module(f"ResBlock_{num_pre_res_blocks + i}",
                            ResBlock(post_conv_dim, activation, s2d=s2d))
        self.ConvBlock_1 = ConvBlock(post_conv_dim, 3, 1,
                                     activation=final_activation, s2d=s2d)

    def forward(self, fused):
        x = self.ConvBlock_0(fused)
        for i in range(self.n_pre):
            x = getattr(self, f"ResBlock_{i}")(x)
        x = self.PixShuffleUpsampler_0(x)
        for i in range(self.n_pre, self.n_pre + self.n_post):
            x = getattr(self, f"ResBlock_{i}")(x)
        x = self.ConvBlock_1(x)
        return depth_to_space_phase_major(x) if self.s2d else x


def draw_ref_offset_noise(generator: torch.Generator, shape,
                          amplitude: float) -> torch.Tensor:
    """The reference frame's offset noise: U[-amplitude, amplitude) of
    ``shape`` ``[B, 1, h, w, 2]`` on the generator's device."""
    return uniform(generator, tuple(shape), -amplitude, amplitude)


class DBSRNet(nn.Module):
    """Full burst SR network: ``forward(burst [B, N, h, w, 4]) ->
    (pred [B, r*h, r*w, 3], aux)`` with ``aux['offsets']`` and, when asked,
    ``aux['fusion_weights']``.

    The constructor takes the JAX package's ``DBSRNet`` fields, so a
    checkpoint's ``net_spec`` rebuilds it. ``train_alignment=True`` trains
    the aligner with the rest; ``ref_offset_noise > 0`` perturbs the
    reference frame's zero offsets, only when ``forward`` is handed a
    ``noise_generator`` (a training caller's choice; none passes zeros).
    ``fused_s2d_decoder=True`` runs the decoder's post-shuffle stage on the
    s2d layout (:class:`PixShuffleDecoder`), as the JAX package does.
    What this port does not run yet raises: another aligner than
    ``'lite'``, non-softmax fusion, and a compute dtype other than float32.
    """

    # the JAX package's module of the same parameters (a checkpoint's
    # ``net_spec``)
    jax_spec = ("dbsr_tpu.models.dbsr", "DBSRNet")

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
        # the constructor's arguments in the JAX module's field order: the
        # checkpoint header's net_spec (training/checkpoint.py)
        spec_kwargs = dict(locals())
        super().__init__()
        self.spec_kwargs = {k: v for k, v in spec_kwargs.items()
                            if k not in ("self", "__class__")}
        unsupported = {  # name: (value, unsupported?)
            "flow_net": (flow_net, flow_net != "lite"),
            "softmax": (softmax, not softmax),
            "dtype": (dtype, dtype not in (None, "float32", torch.float32)),
        }
        bad = [f"{k}={v!r}" for k, (v, no) in unsupported.items() if no]
        if bad:
            raise NotImplementedError(
                "DBSRNet port: not supported yet: " + ", ".join(bad))
        self.ref_offset_noise = float(ref_offset_noise)
        self.encoder = AlignedEncoder(enc_init_dim, enc_num_res_blocks,
                                      enc_out_dim, activation,
                                      train_alignment)
        self.merging = WeightedSumMerge(
            enc_out_dim, weight_pred_proj_dim, offset_feat_dim,
            num_offset_feat_extractor_res, num_weight_predictor_res,
            use_offset, offset_modulo, use_base_frame, activation)
        self.decoder = PixShuffleDecoder(
            enc_out_dim, dec_init_conv_dim, dec_num_pre_res_blocks,
            dec_post_conv_dim, dec_num_post_res_blocks, upsample_factor,
            icnrinit, gauss_blur_sd, gauss_ksz, activation, final_activation,
            fused_s2d_decoder)
        if not train_alignment:  # frozen: no gradient, no optimizer state
            self.encoder.alignment_net.requires_grad_(False)

    def forward(self, burst, return_fusion_weights: bool = False,
                noise_generator: Optional[torch.Generator] = None):
        enc = self.encoder(burst)
        ref_offsets = None
        if self.ref_offset_noise > 0.0 and noise_generator is not None:
            ref_offsets = draw_ref_offset_noise(
                noise_generator, enc["offsets"][:, :1].shape,
                self.ref_offset_noise)
        merged = self.merging(enc, return_fusion_weights, ref_offsets)
        pred = self.decoder(merged["fused_enc"])
        aux = {"offsets": enc["offsets"]}
        if return_fusion_weights:
            aux["fusion_weights"] = merged["fusion_weights"]
        return pred.float(), aux


def dbsrnet_cvpr2021(**overrides) -> DBSRNet:
    """The flagship configuration with the AlignLite aligner (the JAX
    package's defaults; its serving checkpoints set ``flow_net='lite'``)."""
    return DBSRNet(**{"flow_net": "lite", **overrides})


def dbsrnet_tiny(**overrides) -> DBSRNet:
    """Small configuration for tests (the JAX package's ``dbsrnet_tiny``)."""
    cfg = dict(enc_init_dim=8, enc_num_res_blocks=1, enc_out_dim=16,
               dec_init_conv_dim=8, dec_num_pre_res_blocks=1,
               dec_post_conv_dim=8, dec_num_post_res_blocks=1,
               upsample_factor=8, offset_feat_dim=4, weight_pred_proj_dim=4,
               num_weight_predictor_res=1, flow_net="lite")
    cfg.update(overrides)
    return DBSRNet(**cfg)
