"""The four operations that the program runs as CUDA kernels, in plain
float32 PyTorch: the bilinear warp, the 81-offset cost volume, the softmax
merge over the frames and the affine resample of the burst synthesis.
Autograd gives their backward. A frozen copy of the port's plain versions
(``ops/warp.py``, ``ops/correlation.py``, ``ops/merge.py``,
``ops/resample.py``) at float32, with no kernel beside them."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

MAX_DISP = 4
NUM_OFFSETS = (2 * MAX_DISP + 1) ** 2  # 81


def base_grid(h: int, w: int, device=None) -> torch.Tensor:
    """``[h, w, 2]`` pixel coordinates in (x, y) order."""
    ys = torch.arange(h, dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def _taps(coords: torch.Tensor, H: int, W: int):
    """For each corner tap (00, 01, 10, 11): the flat source index (clamped)
    and the bilinear weight, 0 where the tap is out of range."""
    x = coords[..., 0].float()
    y = coords[..., 1].float()
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    out = []
    for dy, dx, w in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                      (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
        yi = y0 + dy
        xi = x0 + dx
        valid = ((yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)).to(w.dtype)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
        out.append((idx, w * valid))
    return out


def sample_bilinear(im: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of ``[B, H, W, C]`` at pixel ``coords``
    ``[B, h, w, 2]`` ((x, y), pixel centres at integers); out-of-range taps
    contribute 0."""
    B, H, W, C = im.shape
    flat = im.reshape(B, H * W, C)
    out = None
    for idx, w in _taps(coords, H, W):
        val = torch.gather(flat, 1, idx.reshape(B, -1, 1).expand(-1, -1, C))
        term = val.reshape(idx.shape + (C,)) * w[..., None]
        out = term if out is None else out + term
    return out


def warp_feat(feat: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Output pixel p samples ``feat`` ``[B, H, W, C]`` at ``p + flow[p]``
    (``flow`` ``[B, H, W, 2]``, (x, y) pixels), zeros padding."""
    H, W = feat.shape[1], feat.shape[2]
    return sample_bilinear(feat, base_grid(H, W, feat.device) + flow.float())


def cost_volume(first: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """Shifted-window cost volume: ``[B, H, W, C] x2 -> [B, H, W, 81]``, the
    channel mean of ``first`` times ``second`` shifted by each offset in
    [-4, 4]^2, zeros outside."""
    B, H, W, C = first.shape
    p = MAX_DISP
    second_p = F.pad(second, (0, 0, p, p, p, p))
    outs = []
    for dy in range(-p, p + 1):
        for dx in range(-p, p + 1):
            shifted = second_p[:, dy + p:dy + p + H, dx + p:dx + p + W, :]
            outs.append((first * shifted).mean(dim=-1))
    return torch.stack(outs, dim=-1)


def fused_softmax_merge(feat: torch.Tensor,
                        logits: torch.Tensor) -> torch.Tensor:
    """Softmax of ``logits`` over the frame axis, weighted sum of ``feat``'s
    frames: ``[B, N, H, W, C] x2 -> [B, H, W, C]``."""
    w = torch.softmax(logits.float(), dim=1)
    return (feat.float() * w).sum(dim=1)


def fine_grid(out_hw: Tuple[int, int], d: int, border: int,
              device=None) -> torch.Tensor:
    """Source-grid positions ``(q + 0.5) d - 0.5 + border`` of the output
    pixels ``q`` ``[OH, OW, 2]`` ((x, y) order)."""
    return (base_grid(*out_hw, device=device) + 0.5) * d - 0.5 + border


def affine_resample(images: torch.Tensor, invs: torch.Tensor,
                    out_hw: Tuple[int, int], d: int,
                    border: int) -> torch.Tensor:
    """``images`` ``[B, H, W, C]``, inverse affines ``invs`` ``[B, N, 2, 3]``
    -> ``[B, N, OH, OW, C]``: each frame sampled bilinearly at the
    composed-affine coordinates of its output grid."""
    from benchmark.reference.interp import apply_affine_to_points

    B, N = invs.shape[:2]
    OH, OW = out_hw
    coords = apply_affine_to_points(
        invs, fine_grid(out_hw, d, border, images.device))
    out = sample_bilinear(images, coords.reshape(B, N * OH, OW, 2))
    return out.reshape(B, N, OH, OW, images.shape[-1])
