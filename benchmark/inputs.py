"""The serving cells' bursts, made from the seed by the benchmark's own code:
procedural dead-leaves sources of 432^2 rendered on the card, then the eval
protocol's synthesis (SyntheticBurstVal's: 14 frames of 48x48 packed RAW
from a 384^2 crop at x4, border 24, translation up to 24 px, rotation up
to 1 degree, the strict two-stage resample), the RAW values rounded to the
2^-14 grid that a uint16 body at 2^14 carries, so that a float32 call and
an HTTP request see the same numbers."""

from __future__ import annotations

import torch

from benchmark.reference.procedural import make_generator, render_pool
from benchmark.reference.synthetic import (BurstConfig,
                                           rgb2rawburst_from_draws,
                                           sample_draws)

RAW_SCALE = 2 ** 14


def eval_burst_config(burst_size: int) -> BurstConfig:
    return BurstConfig(burst_size=burst_size, crop_sz=(384, 384),
                       downsample_factor=4, border_crop=24,
                       max_translation=24.0, max_rotation=1.0,
                       fused_resample=False)


@torch.no_grad()
def serving_bursts(seed: int, n: int, burst_size: int, device,
                   chunk: int = 16) -> torch.Tensor:
    """``n`` distinct bursts ``[n, burst_size, 48, 48, 4]`` float32 on the
    2^-14 grid, on ``device``: image ``i`` of a dead-leaves pool of ``(seed,
    1)``, its synthesis drawn from the stream ``(seed, 2)``."""
    cfg = eval_burst_config(burst_size)
    pool = render_pool(n, cfg.pre_crop_sz, seed, 1, device)
    g = make_generator(device, seed, 2)
    out = []
    for lo in range(0, n, chunk):
        crops = pool[lo:lo + chunk].float() / 255.0
        draws = sample_draws(g, crops.shape[0], cfg)
        burst = rgb2rawburst_from_draws(crops, draws, cfg)["burst"]
        out.append(torch.round(burst * RAW_SCALE) / RAW_SCALE)
    return torch.cat(out)
