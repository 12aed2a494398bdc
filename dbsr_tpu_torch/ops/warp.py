"""Bilinear backward warp of channels-last features (port of
``dbsr_tpu/ops/warp_pallas.py`` and the gather ``warp`` /
``sample_bilinear`` of ``dbsr_tpu/ops/interp.py``).

``warp_feat`` launches the CUDA kernel ``kernels/csrc/warp.cu`` for a CUDA
tensor and runs ``warp_feat_plain``, the plain PyTorch gather, for a CPU
tensor. ``warp_feat.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from dbsr_tpu_torch import kernels


def base_grid(h: int, w: int, device=None) -> torch.Tensor:
    """Integer-pixel identity sampling grid ``[h, w, 2]`` in (x, y) order."""
    ys = torch.arange(h, dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def sample_bilinear(im: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of ``[B, H, W, C]`` at pixel ``coords``
    ``[B, h, w, 2]`` ((x, y), pixel centres at integers); out-of-range
    corner taps contribute 0. The four terms are summed in tap order
    (00, 01, 10, 11), the order the CUDA kernel uses."""
    B, H, W, C = im.shape
    x = coords[..., 0].float()
    y = coords[..., 1].float()
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    flat = im.reshape(B, H * W, C)
    out = None
    for dy, dx, w in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                      (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
        yi = y0 + dy
        xi = x0 + dx
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
        val = torch.gather(flat, 1, idx.reshape(B, -1, 1).expand(-1, -1, C))
        val = val.reshape(idx.shape + (C,))
        term = val * (w * valid.to(w.dtype))[..., None].to(im.dtype)
        out = term if out is None else out + term
    return out


def warp_feat_plain(feat: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: output pixel p samples ``feat``
    ``[B, H, W, C]`` at ``p + flow[p]`` (``flow`` ``[B, H, W, 2]``, (x, y)
    pixels), zeros padding."""
    H, W = feat.shape[1], feat.shape[2]
    coords = base_grid(H, W, feat.device) + flow.float()
    return sample_bilinear(feat, coords)


def warp_feat(feat: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp ``feat`` ``[B, H, W, C]`` by ``flow`` ``[B, H, W, 2]``:
    the CUDA kernel for a CUDA tensor (float32, contiguous, C % 4 == 0),
    :func:`warp_feat_plain` for a CPU tensor."""
    if feat.ndim != 4 or flow.shape != feat.shape[:3] + (2,):
        raise ValueError(f"warp_feat: feat {tuple(feat.shape)} and flow "
                         f"{tuple(flow.shape)} are not [B,H,W,C], [B,H,W,2]")
    if feat.device.type == "cpu" and flow.device.type == "cpu":
        return warp_feat_plain(feat, flow)
    kernels.require_cuda_f32("warp_feat", feat, flow)
    B, H, W, C = feat.shape
    if C % 4:
        raise ValueError(f"warp_feat: kernel takes C % 4 == 0, got C={C}")
    out = torch.empty_like(feat)
    kernels.launch("warp", "dbsr_warp_f32", (feat, flow, out), (B, H, W, C))
    warp_feat.launches += 1
    return out


warp_feat.launches = 0
