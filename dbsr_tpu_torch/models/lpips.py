"""LPIPS perceptual metric with the AlexNet backbone (port of
``dbsr_tpu/models/lpips.py``).

AlexNet conv features at five stages, unit-normalized along the channels,
squared differences weighted by the learned non-negative 1x1 ``lin``
convs, averaged over space, summed over the stages and averaged over the
batch. The convs are ``F.conv2d`` in float32 with TF32 off
(``serving.float32_math``), cuDNN's on the card: the JAX package runs them
with ``lax.conv`` at ``HIGHEST``, outside any Pallas kernel.

The weights come from the ``.npz`` the JAX package reads (see
:func:`convert_from_torch`): ``conv{i}_w`` HWIO, ``conv{i}_b``,
``lin{i}_w`` ``[1, 1, C, 1]``; they are transposed once to OIHW when
loaded. Its path is ``DBSR_TPU_LPIPS_WEIGHTS``, else
``<pretrained_nets_dir>/lpips_alex.npz``; without one :func:`load_lpips`
raises ``FileNotFoundError``, and scoring goes on without the column.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dbsr_tpu_torch.serving import float32_math

# AlexNet's feature convs: (out channels, kernel, stride, padding), each
# followed by a ReLU (a feature tap), with max-pool(3, 2) after convs 0, 1
_ALEX_CONVS = (
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def torch_weights(weights: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """The ``.npz`` layout (arrays or tensors) -> float32 OIHW tensors on
    ``device``: conv kernels HWIO -> OIHW, ``lin`` ``[1, 1, C, 1]`` ->
    ``[1, C, 1, 1]``."""
    out = {}
    for k, v in weights.items():
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                            dtype=torch.float32)
        if t.ndim == 4:
            t = t.permute(3, 2, 0, 1)
        out[k] = t.contiguous().to(device)
    return out


def _alex_features(x: torch.Tensor, w: Dict[str, torch.Tensor]):
    """``x`` ``[B, H, W, 3]`` in [-1, 1] -> the five taps, NCHW."""
    shift = torch.tensor(_SHIFT, dtype=torch.float32, device=x.device)
    scale = torch.tensor(_SCALE, dtype=torch.float32, device=x.device)
    x = ((x - shift) / scale).permute(0, 3, 1, 2)
    taps = []
    for i, (_, _, s, p) in enumerate(_ALEX_CONVS):
        x = torch.relu(F.conv2d(x, w[f"conv{i}_w"], w[f"conv{i}_b"],
                                stride=s, padding=p))
        taps.append(x)
        if i in (0, 1):  # VALID windows, floor mode: JAX's reduce_window
            x = F.max_pool2d(x, 3, 2)
    return taps


def _normalize(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt((feat ** 2).sum(dim=1, keepdim=True))
    return feat / (norm + eps)


def _crop(x: torch.Tensor, b: Optional[int]) -> torch.Tensor:
    return x[..., b:-b, b:-b, :] if b else x


def _per_sample(pred, gt, w, boundary_ignore):
    """LPIPS of each sample of ``[B, H, W, 3]`` images in [0, 1]: ``[B]``."""
    with float32_math():
        pred = _crop(pred.float(), boundary_ignore) * 2.0 - 1.0
        gt = _crop(gt.float(), boundary_ignore) * 2.0 - 1.0
        total = 0.0
        for i, (fp, fg) in enumerate(zip(_alex_features(pred, w),
                                         _alex_features(gt, w))):
            d = (_normalize(fp) - _normalize(fg)) ** 2
            total = total + F.conv2d(d, w[f"lin{i}_w"]).mean(dim=(1, 2, 3))
    return total


def lpips_distance(pred, gt, weights, boundary_ignore: Optional[int] = None):
    """LPIPS(pred, gt) for ``[B, H, W, 3]`` images in [0, 1], averaged over
    the batch; ``weights`` in the ``.npz`` layout. The boundary crop comes
    before the features."""
    w = torch_weights(weights, pred.device)
    return _per_sample(pred, gt, w, boundary_ignore).mean()


def lpips_from_weights(weights) -> Callable:
    """``fn(pred, gt, boundary_ignore=None, reduce=True)`` over
    ``[B, H, W, 3]`` or one ``[H, W, 3]`` image: the batch's mean, or with
    ``reduce=False`` each sample's ``[B]``. The weights are transposed
    once (and copied once to each device they are used on)."""
    base = torch_weights(weights)
    cache = {}

    @torch.inference_mode()
    def fn(pred, gt, boundary_ignore=None, reduce=True):
        if pred.ndim == 3:
            pred, gt = pred[None], gt[None]
        if pred.device not in cache:
            cache[pred.device] = {k: v.to(pred.device)
                                  for k, v in base.items()}
        d = _per_sample(pred, gt, cache[pred.device], boundary_ignore)
        return d.mean() if reduce else d

    return fn


def default_weights_path() -> Optional[str]:
    """``DBSR_TPU_LPIPS_WEIGHTS``, else ``<pretrained_nets_dir>/
    lpips_alex.npz`` where it exists, else None."""
    p = os.environ.get("DBSR_TPU_LPIPS_WEIGHTS")
    if p:
        return p
    from dbsr_tpu_torch.environment import env_settings

    d = env_settings().pretrained_nets_dir
    if d:
        cand = os.path.join(d, "lpips_alex.npz")
        if os.path.exists(cand):
            return cand
    return None


def load_lpips(weights_path: Optional[str] = None) -> Callable:
    """:func:`lpips_from_weights` of the ``.npz`` at ``weights_path`` (else
    :func:`default_weights_path`); no weights raise ``FileNotFoundError``."""
    path = weights_path or default_weights_path()
    if path is None or not os.path.exists(path):
        raise FileNotFoundError(
            "LPIPS weights not found; set DBSR_TPU_LPIPS_WEIGHTS to a "
            "converted lpips_alex.npz (see models/lpips.py:"
            "convert_from_torch)")
    with np.load(path) as raw:
        weights = {k: raw[k] for k in raw.files}
    return lpips_from_weights(weights)


def convert_from_torch(out_path: str) -> None:
    """Write torchvision AlexNet's and the ``lpips`` package's ``lin``
    weights to the ``.npz`` layout (needs the ``lpips`` package and its
    bundled weights; run where it is installed and ship the file)."""
    import lpips as lpips_pkg  # type: ignore

    model = lpips_pkg.LPIPS(net="alex")
    out = {}
    convs = [m for s in (model.net.slice1, model.net.slice2,
                         model.net.slice3, model.net.slice4,
                         model.net.slice5) for m in s]
    conv_idx = 0
    for m in convs:
        if isinstance(m, torch.nn.Conv2d):
            out[f"conv{conv_idx}_w"] = (
                m.weight.detach().numpy().transpose(2, 3, 1, 0))
            out[f"conv{conv_idx}_b"] = m.bias.detach().numpy()
            conv_idx += 1
    for i, lin in enumerate(model.lins):
        w = lin.model[-1].weight.detach().numpy()  # [1, C, 1, 1]
        out[f"lin{i}_w"] = w.transpose(2, 3, 1, 0)
    np.savez(out_path, **out)
