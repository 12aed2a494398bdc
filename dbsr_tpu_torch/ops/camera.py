"""Camera-pipeline ops (port of ``dbsr_tpu/ops/camera.py``; the serving
path needs only ``demosaic_naive``)."""

from __future__ import annotations

import torch


def demosaic_naive(packed: torch.Tensor) -> torch.Tensor:
    """Cheap pseudo-RGB from packed RGGB ``[..., 4]``: (R, (G1+G2)/2, B) at
    the packed (half) resolution, as the encoder feeds the flow network."""
    return torch.stack(
        [packed[..., 0], 0.5 * (packed[..., 1] + packed[..., 2]),
         packed[..., 3]], dim=-1)
