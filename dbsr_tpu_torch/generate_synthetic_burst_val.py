"""Generate a SyntheticBurstVal-format validation set on the card (port of
the repository's JAX-side script ``generate_synthetic_burst_val.py``):

    python -m dbsr_tpu_torch.generate_synthetic_burst_val \
        --procedural 150 --num_bursts 300 --seed 20260817 --out_dir <dir>
    python -m dbsr_tpu_torch.generate_synthetic_burst_val \
        --source_dir <folder of RGB images> --num_bursts 300 --out_dir <dir>

Each burst is synthesized with the eval protocol's shapes: 14 frames of
48x48 packed RAW from a 384^2 crop at x4, border 24, translation up to 24
px, rotation up to 1 degree, through the strict two-stage resample (the
full-resolution warp, then the x1/4 resize) unless ``--fused_resample``.
``--procedural N`` draws the source images from N dead-leaves images made
on the card, ``--source_dir`` from a folder of images (``ImageFolder``;
an image smaller than the 432^2 crop is skipped, and its burst with it).
The images and crops come from ``np.random.default_rng(seed)``, the JAX
script's sequence, so a ``--source_dir`` set's crops equal that script's;
each burst's synthesis draws from its own generator of ``(seed, index)``.

The synthesis draws are the port's own random streams, so a set made here
is not bit-identical to the JAX script's with the same seed: it is another
set of the same protocol. ``--device cpu`` runs the plain PyTorch
versions.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from dbsr_tpu_torch.data.synthetic import BurstConfig


def eval_burst_config(burst_size: int = 14,
                      fused_resample: bool = False) -> BurstConfig:
    """The eval protocol's burst configuration."""
    return BurstConfig(burst_size=burst_size, crop_sz=(384, 384),
                       downsample_factor=4, border_crop=24,
                       max_translation=24.0, max_rotation=1.0,
                       fused_resample=fused_resample)


def source_crops(ds, num_bursts: int, cfg: BurstConfig, seed: int = 0):
    """Yield ``(i, crop)`` for bursts ``i < num_bursts``: a random image of
    ``ds`` and a random ``cfg.pre_crop_sz`` crop of it in [0, 1], drawn from
    ``np.random.default_rng(seed)``; an image too small for the crop skips
    burst ``i``."""
    from dbsr_tpu_torch.data.pipeline import random_resized_crop

    rng = np.random.default_rng(seed)
    for i in range(num_bursts):
        idx = int(rng.integers(0, len(ds)))
        frame, _ = ds.get_image(idx)
        frame = frame.astype(np.float32) / 255.0
        if min(frame.shape[:2]) < max(cfg.pre_crop_sz):
            continue
        yield i, random_resized_crop(rng, frame, cfg.pre_crop_sz)


def generate(out_dir: str, num_bursts: int, procedural: Optional[int],
             cfg: BurstConfig, seed: int = 0, device="cuda",
             source_dir: Optional[str] = None) -> None:
    """Write ``num_bursts`` bursts synthesized with ``cfg`` to ``out_dir``,
    from ``procedural`` dead-leaves source images or, with ``source_dir``,
    from the images of that folder."""
    from dbsr_tpu_torch import resolve_device
    from dbsr_tpu_torch.data.datasets import (ImageFolder,
                                              write_synthetic_burst_val)
    from dbsr_tpu_torch.data.procedural import (ProceduralImages,
                                                make_generator)
    from dbsr_tpu_torch.data.synthetic import rgb2rawburst

    dev = resolve_device(device)
    if source_dir is not None:
        ds = ImageFolder(source_dir)
    else:
        ds = ProceduralImages(procedural, hw=(max(cfg.pre_crop_sz),) * 2,
                              seed=seed + 777, device=dev)

    def samples():
        for i, crop in source_crops(ds, num_bursts, cfg, seed):
            with torch.inference_mode():
                out = rgb2rawburst(make_generator(dev, seed, i),
                                   torch.from_numpy(crop).to(dev), cfg)
            yield {"burst": out["burst"], "frame_gt": out["frame_gt"],
                   "meta": out["meta"]}
            if (i + 1) % 10 == 0:
                print(f"{i + 1}/{num_bursts}", flush=True)

    write_synthetic_burst_val(out_dir, samples())
    print(f"wrote {num_bursts} bursts to {out_dir}")


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate a SyntheticBurstVal "
                                            "set (PyTorch/CUDA port).")
    p.add_argument("--source_dir", default=None)
    p.add_argument("--procedural", type=int, default=None, metavar="N",
                   help="use N procedural dead-leaves source images "
                        "instead of --source_dir")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--num_bursts", type=int, default=300)
    p.add_argument("--burst_size", type=int, default=14)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fused_resample", action="store_true",
                   help="synthesize with the fused single-pass resample "
                        "(the training path) instead of the strict "
                        "two-stage one eval sets use")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if (args.source_dir is None) == (args.procedural is None):
        p.error("exactly one of --source_dir / --procedural is required")
    kw = {"source_dir": args.source_dir} if args.source_dir is not None \
        else {}
    generate(args.out_dir, args.num_bursts, args.procedural,
             eval_burst_config(args.burst_size, args.fused_resample),
             seed=args.seed, device=args.device, **kw)


if __name__ == "__main__":
    main()
