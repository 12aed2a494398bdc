"""Upstream PWC-Net weights -> the port's ``PWCFlowNet`` (port of
``dbsr_tpu/utils/convert_pwcnet.py``).

The reference loads the sniklaus pytorch-pwc checkpoint
(``pwcnet-network-default.pth``). Its tensors already have the layouts of
the port's modules (conv weights ``[out, in, kh, kw]``, transposed-conv
weights ``[in, out, kh, kw]``), so converting is renaming:

    net.netExtractor.netOne.{0,2,4}   -> extractor.lvl1_conv{0,1,2}.Conv_0
    net.netSix.netOne.0 .. netFiv.0   -> dec6.dense0 .. dense4 .Conv_0
    net.netSix.netSix.0               -> dec6.flow_head.Conv_0
    net.netFiv.netUpflow / netUpfeat  -> dec5.upflow / upfeat
    net.netRefiner.netMain.{0..10}    -> refiner.ctx0 .. ctx5 .Conv_0
    net.netRefiner.netMain.12         -> refiner.ctx_flow.Conv_0

(``module`` in a key reads as ``net``.) Load the result into
``PWCNet().net`` (or ``BurstFlowNet().alignment_net.net``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

import torch

_LEVEL_NAMES = ("netOne", "netTwo", "netThr", "netFou", "netFiv", "netSix")


def _renames():
    """``(upstream module, port module)`` pairs."""
    for lvl, name in enumerate(_LEVEL_NAMES, start=1):
        for j, idx in enumerate((0, 2, 4)):
            yield (f"net.netExtractor.{name}.{idx}",
                   f"extractor.lvl{lvl}_conv{j}.Conv_0")
    for lvl, name in enumerate(_LEVEL_NAMES[1:], start=2):
        for i, dense in enumerate(_LEVEL_NAMES[:5]):
            yield f"net.{name}.{dense}.0", f"dec{lvl}.dense{i}.Conv_0"
        yield f"net.{name}.netSix.0", f"dec{lvl}.flow_head.Conv_0"
        if lvl < 6:
            yield f"net.{name}.netUpflow", f"dec{lvl}.upflow"
            yield f"net.{name}.netUpfeat", f"dec{lvl}.upfeat"
    for i, idx in enumerate((0, 2, 4, 6, 8, 10)):
        yield f"net.netRefiner.netMain.{idx}", f"refiner.ctx{i}.Conv_0"
    yield "net.netRefiner.netMain.12", "refiner.ctx_flow.Conv_0"


def convert_pwcnet_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """An upstream state dict (tensors or arrays) -> a ``state_dict`` of the
    port's ``PWCFlowNet``, float32. A missing upstream tensor raises."""
    sd = {k.replace("module", "net"): v for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = OrderedDict()
    for src, dst in _renames():
        for leaf in ("weight", "bias"):
            key = f"{src}.{leaf}"
            if key not in sd:
                raise KeyError(f"upstream PWC-Net state dict lacks {key}")
            out[f"{dst}.{leaf}"] = torch.as_tensor(sd[key]).detach().to(
                "cpu", torch.float32).clone()
    return out


def load_pwcnet_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read an upstream ``.pth`` checkpoint and convert it."""
    return convert_pwcnet_state_dict(
        torch.load(path, map_location="cpu", weights_only=True))
