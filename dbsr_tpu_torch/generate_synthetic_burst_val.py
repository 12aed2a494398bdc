"""Generate a SyntheticBurstVal-format validation set on the card (port of
the repository's JAX-side script ``generate_synthetic_burst_val.py``):

    python -m dbsr_tpu_torch.generate_synthetic_burst_val \
        --procedural 150 --num_bursts 300 --seed 20260817 --out_dir <dir>

Each burst is synthesized with the eval protocol's shapes: 14 frames of
48x48 packed RAW from a 384^2 crop at x4, border 24, translation up to 24
px, rotation up to 1 degree, through the strict two-stage resample (the
full-resolution warp, then the x1/4 resize) unless ``--fused_resample``.
``--procedural N`` draws the source images from N dead-leaves images made
on the card; the crops come from ``np.random.default_rng(seed)`` and each
burst's synthesis from its own generator of ``(seed, index)``.

The draws are the port's own random streams, so a set made here is not
bit-identical to the JAX script's with the same seed: it is another set of
the same protocol. ``--device cpu`` runs the plain PyTorch versions.
"""

from __future__ import annotations

import argparse

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


def generate(out_dir: str, num_bursts: int, procedural: int,
             cfg: BurstConfig, seed: int = 0, device="cuda") -> None:
    """Write ``num_bursts`` bursts synthesized with ``cfg`` from
    ``procedural`` dead-leaves source images to ``out_dir``."""
    from dbsr_tpu_torch import resolve_device
    from dbsr_tpu_torch.data.datasets import write_synthetic_burst_val
    from dbsr_tpu_torch.data.pipeline import random_resized_crop
    from dbsr_tpu_torch.data.procedural import (ProceduralImages,
                                                make_generator)
    from dbsr_tpu_torch.data.synthetic import rgb2rawburst

    dev = resolve_device(device)
    ds = ProceduralImages(procedural, hw=(max(cfg.pre_crop_sz),) * 2,
                          seed=seed + 777, device=dev)
    rng = np.random.default_rng(seed)

    def samples():
        for i in range(num_bursts):
            idx = int(rng.integers(0, len(ds)))
            frame, _ = ds.get_image(idx)
            frame = frame.astype(np.float32) / 255.0
            crop = random_resized_crop(rng, frame, cfg.pre_crop_sz)
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
    if args.source_dir is not None:
        raise NotImplementedError(
            "--source_dir: the port has no image-folder reader yet "
            "(ROADMAP.md, Queue 1 item 8); use --procedural N")
    generate(args.out_dir, args.num_bursts, args.procedural,
             eval_burst_config(args.burst_size, args.fused_resample),
             seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
