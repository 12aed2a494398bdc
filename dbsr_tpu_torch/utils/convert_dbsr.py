"""A reference (torch) DBSRNet ``state_dict()`` -> the port's
``DBSRNet(flow_net='pwc')`` (port of ``dbsr_tpu/utils/convert_dbsr.py``).

For the published CVPR2021 checkpoints, when they are staged. The
reference's conv weights are OIHW like the port's, and the port's s2d
decoder keeps the fine conv's weight (it rearranges it at use), so
converting is renaming (reference -> port, ``.weight`` and ``.bias``):

    encoder.init_layer.0                -> encoder.embed.ConvBlock_0.Conv_0
    encoder.res_layers.{i}.conv{1,2}.0  -> encoder.embed.ResBlock_{i}.ConvBlock_{0,1}.Conv_0
    encoder.out_layer.0                 -> encoder.embed.ConvBlock_1.Conv_0
    encoder.alignment_net.*             -> encoder.alignment_net.net.* (utils/convert_pwcnet.py)
    merging.feat_project_layer.0        -> merging.feat_project.Conv_0
    merging.offset_feat_extractor.0.0   -> merging.offset_conv.Conv_0
    merging.offset_feat_extractor.{1+i} -> merging.offset_res{i}
    merging.weight_predictor.0.0        -> merging.weight_conv.Conv_0
    merging.weight_predictor.{1+i}      -> merging.weight_res{i}
    merging.weight_predictor.{last}.0   -> merging.weight_out.Conv_0
    decoder.init_layer.0                -> decoder.ConvBlock_0.Conv_0
    decoder.pre_res_layers.{i}          -> decoder.ResBlock_{i}
    decoder.upsample_layer.conv_layer.0 -> decoder.PixShuffleUpsampler_0.Conv_0
    decoder.post_res_layers.{i}         -> decoder.ResBlock_{n_pre + i}
    decoder.predictor.0                 -> decoder.ConvBlock_1.Conv_0

(a residual block's ``conv1.0`` / ``conv2.0`` are its ``ConvBlock_0`` /
``ConvBlock_1``). Block counts come from the keys, so any reference
configuration converts. A conv without a bias in the reference (the
ICNR-initialised upsampler's) has none in the port.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Iterator, Mapping, Tuple

import torch

from dbsr_tpu_torch.utils import convert_pwcnet
from dbsr_tpu_torch.utils.convert_pwcnet import convert_pwcnet_state_dict


def _count(sd: Mapping, pattern: str) -> int:
    """The number of blocks whose keys match (indices are contiguous, and
    start at 1 inside a Sequential that begins with a conv block)."""
    rx = re.compile(pattern)
    return len({int(m.group(1)) for k in sd if (m := rx.match(k))})


def _res(src: str, dst: str) -> Iterator[Tuple[str, str]]:
    yield f"{src}.conv1.0", f"{dst}.ConvBlock_0.Conv_0"
    yield f"{src}.conv2.0", f"{dst}.ConvBlock_1.Conv_0"


def _renames(sd: Mapping) -> Iterator[Tuple[str, str]]:
    """``(reference conv, port conv)`` pairs, the PWC-Net aligner apart."""
    yield "encoder.init_layer.0", "encoder.embed.ConvBlock_0.Conv_0"
    for i in range(_count(sd, r"encoder\.res_layers\.(\d+)\.conv1\.0\.weight")):
        yield from _res(f"encoder.res_layers.{i}", f"encoder.embed.ResBlock_{i}")
    yield "encoder.out_layer.0", "encoder.embed.ConvBlock_1.Conv_0"

    yield "merging.feat_project_layer.0", "merging.feat_project.Conv_0"
    if "merging.offset_feat_extractor.0.0.weight" in sd:
        yield "merging.offset_feat_extractor.0.0", "merging.offset_conv.Conv_0"
        for i in range(_count(sd, r"merging\.offset_feat_extractor\.(\d+)"
                                  r"\.conv1\.0\.weight")):
            yield from _res(f"merging.offset_feat_extractor.{i + 1}",
                            f"merging.offset_res{i}")
    yield "merging.weight_predictor.0.0", "merging.weight_conv.Conv_0"
    n_w = _count(sd, r"merging\.weight_predictor\.(\d+)\.conv1\.0\.weight")
    for i in range(n_w):
        yield from _res(f"merging.weight_predictor.{i + 1}",
                        f"merging.weight_res{i}")
    yield f"merging.weight_predictor.{n_w + 1}.0", "merging.weight_out.Conv_0"

    yield "decoder.init_layer.0", "decoder.ConvBlock_0.Conv_0"
    n_pre = _count(sd, r"decoder\.pre_res_layers\.(\d+)\.conv1\.0\.weight")
    for i in range(n_pre):
        yield from _res(f"decoder.pre_res_layers.{i}", f"decoder.ResBlock_{i}")
    yield ("decoder.upsample_layer.conv_layer.0",
           "decoder.PixShuffleUpsampler_0.Conv_0")
    for i in range(_count(sd, r"decoder\.post_res_layers\.(\d+)\.conv1\.0"
                              r"\.weight")):
        yield from _res(f"decoder.post_res_layers.{i}",
                        f"decoder.ResBlock_{n_pre + i}")
    yield "decoder.predictor.0", "decoder.ConvBlock_1.Conv_0"


def _tensor(v) -> torch.Tensor:
    return torch.as_tensor(v).detach().to("cpu", torch.float32).clone()


def convert_dbsr_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A reference DBSRNet ``state_dict()`` (tensors or arrays) -> a
    ``state_dict`` of the port's ``DBSRNet(flow_net='pwc')``, float32. A
    missing weight raises ``KeyError``."""
    out: Dict[str, torch.Tensor] = OrderedDict()
    for src, dst in _renames(sd):
        if f"{src}.weight" not in sd:
            raise KeyError(f"reference DBSRNet state dict lacks {src}.weight")
        out[f"{dst}.weight"] = _tensor(sd[f"{src}.weight"])
        if f"{src}.bias" in sd:
            out[f"{dst}.bias"] = _tensor(sd[f"{src}.bias"])
    prefix = "encoder.alignment_net."
    pwc = convert_pwcnet_state_dict({k[len(prefix):]: v for k, v in sd.items()
                                     if k.startswith(prefix)})
    for k, v in pwc.items():
        out[f"{prefix}net.{k}"] = v
    return out


def reference_state_dict(net) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`convert_dbsr_state_dict`: a port
    ``DBSRNet(flow_net='pwc')``'s parameters under the reference's names
    (the upstream PWC-Net's for the aligner), float32 copies on the CPU.

    It exists only to make synthetic reference state dicts of any block
    counts, for the tests and ``chip_smoke.py``, as no published
    checkpoint is in the repository. It inverts the same rename table, so
    converting its output is a round trip: only the tests against the JAX
    package's converter check the names themselves."""
    sd = net.state_dict()
    enc, mrg, dec = net.encoder.embed, net.merging, net.decoder
    # the reference keys that set the block counts
    skeleton = {f"encoder.res_layers.{i}.conv1.0.weight"
                for i in range(enc.num_res_blocks)}
    skeleton |= {f"merging.weight_predictor.{i + 1}.conv1.0.weight"
                 for i in range(mrg.num_weight_res)}
    if mrg.use_offset:
        skeleton |= {"merging.offset_feat_extractor.0.0.weight"} | {
            f"merging.offset_feat_extractor.{i + 1}.conv1.0.weight"
            for i in range(mrg.num_offset_res)}
    skeleton |= {f"decoder.pre_res_layers.{i}.conv1.0.weight"
                 for i in range(dec.n_pre)}
    skeleton |= {f"decoder.post_res_layers.{i}.conv1.0.weight"
                 for i in range(dec.n_post)}
    pairs = list(_renames(skeleton)) + [
        (f"encoder.alignment_net.{src}", f"encoder.alignment_net.net.{dst}")
        for src, dst in convert_pwcnet._renames()]
    out: Dict[str, torch.Tensor] = OrderedDict()
    for src, dst in pairs:
        for leaf in ("weight", "bias"):
            if f"{dst}.{leaf}" in sd:
                out[f"{src}.{leaf}"] = _tensor(sd[f"{dst}.{leaf}"])
    if len(out) != len(sd):
        raise ValueError(f"{len(sd) - len(out)} parameters have no reference "
                         "name (not a DBSRNet with flow_net='pwc')")
    return out


def load_dbsr_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference ``.pth.tar`` training checkpoint (its ``net``
    entry; a bare state dict as it is) and convert it. The file is
    unpickled in full (it holds the reference's settings objects): load
    only a trusted one."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["net"] if isinstance(ckpt, dict) and "net" in ckpt else ckpt
    return convert_dbsr_state_dict(sd)
