"""Write a BurstSR-format tree with a known misregistration planted in it
(port of the repository's JAX-side script ``make_synthetic_burstsr.py``):

    python -m dbsr_tpu_torch.data.make_synthetic_burstsr --out <dir> \
        [--bursts 2] [--lr 96] [--frames 14] [--split val] [--seed 0] \
        [--device cuda]

BurstSR's own data is not in the repository. Each burst here is:

* the Samsung burst: a procedural dead-leaves scene through the port's
  synthesis (``data/synthetic.py``: affine shifts, x4 downsampling, Bayer
  mosaic, shot and read noise) -> ``frames`` packed-RGGB uint16 frames of
  ``lr`` x ``lr`` with black level, white balance and EXIF in the reader's
  format;
* the Canon ground truth: the same scene at 8x the packed frames, under a
  known translation (``GT_SHIFT``), a known 3x3 colour transform
  (``COLOR_M``) and a known exposure ratio (``exp_scale_factor()``, from
  the EXIF) -- what SCA exists to undo;
* the clean scene, ``scene_linear.npy``, so that a check can hand SCA a
  perfect prediction and measure that it recovers the planted transform.

The layout is ``<out>/<split>/<scene id>_0001/samsung_00.. + canon``, the
PNGs in the dataset's cv2 channel order. The constants are the JAX
generator's; the pixels come from the port's own random streams
(``make_generator(device, seed, burst, part)``), not JAX's.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

SAMSUNG_BLACK = 64
SAMSUNG_MAX = 1023
CANON_BLACK = 512
CANON_MAX = 16383

# the known Canon-vs-Samsung misregistration (what SCA must undo)
GT_SHIFT = (7.3, -5.1)  # (x, y) in ground-truth pixels
COLOR_M = np.array([[0.90, 0.08, 0.02],
                    [0.05, 0.90, 0.05],
                    [0.02, 0.08, 0.90]], np.float32)
# EXIF: the light ratio (exposure x ISO / F^2) Samsung / Canon is the
# exposure scale factor
SAMSUNG_EXIF = {"exposure": 0.01, "f_number": 1.7, "iso": 100.0,
                "noise_profile": [1e-3, 1e-5, 1e-3, 1e-5, 1e-3, 1e-5]}
CANON_EXIF = {"exposure": 0.04, "f_number": 4.0, "iso": 100.0}


def exp_scale_factor() -> float:
    light_s = SAMSUNG_EXIF["exposure"] * SAMSUNG_EXIF["iso"] / (
        SAMSUNG_EXIF["f_number"] ** 2)
    light_c = CANON_EXIF["exposure"] * CANON_EXIF["iso"] / (
        CANON_EXIF["f_number"] ** 2)
    return light_s / light_c


def _write_png16(path: str, arr: np.ndarray) -> None:
    """Write in the dataset's cv2 order: channels 0 and 2 swapped, which
    the reader swaps back."""
    from dbsr_tpu_torch.utils.png16 import write_png

    arr = arr.astype(np.uint16)
    write_png(path, arr[..., [2, 1, 0] + list(range(3, arr.shape[-1]))])


def generate_burst(dev: torch.device, seed: int, index: int, lr: int,
                   n_frames: int = 14):
    """``(burst [N, lr, lr, 4] in [0, 1], scene linear RGB [8 lr, 8 lr,
    3])`` on the host. The ground truth sits at 8x the packed frames (4x
    the flat RAW), the factor DBSR's prediction upsamples by, so that the
    prediction and the ground truth share SCA's resolution."""
    from dbsr_tpu_torch.data.procedural import (dead_leaves_image,
                                                make_generator)
    from dbsr_tpu_torch.data.synthetic import BurstConfig, rgb2rawburst

    cfg = BurstConfig(burst_size=n_frames, crop_sz=(8 * lr, 8 * lr),
                      downsample_factor=4, border_crop=16,
                      max_translation=12.0, max_rotation=0.3,
                      random_ccm=True, random_gains=True, smoothstep=True,
                      gamma=True, add_noise=True, fused_resample=True)
    with torch.inference_mode():
        hr = dead_leaves_image(make_generator(dev, seed, index, 0), 1,
                               cfg.pre_crop_sz)[0]
        out = rgb2rawburst(make_generator(dev, seed, index, 1), hr, cfg)
    return out["burst"].cpu().numpy(), out["frame_gt"].cpu().numpy()


def canon_from_scene(scene: np.ndarray, dev: torch.device) -> np.ndarray:
    """The misregistered Canon content: the linear scene (in [0, 1],
    before exposure) translated by ``GT_SHIFT`` and colour-transformed by
    ``COLOR_M``, clipped to [0, 1]."""
    from dbsr_tpu_torch.ops.warp import warp_feat

    s = torch.from_numpy(np.ascontiguousarray(scene, np.float32)).to(dev)
    flow = torch.tensor(GT_SHIFT, dtype=torch.float32, device=dev).expand(
        s.shape[:2] + (2,)).contiguous()
    with torch.inference_mode():
        shifted = warp_feat(s[None].contiguous(), flow[None])[0].cpu().numpy()
    return np.clip(shifted @ COLOR_M.T, 0.0, 1.0)


def write_burst_dir(burst_dir: str, burst: np.ndarray, scene: np.ndarray,
                    dev: torch.device) -> None:
    canon_content = canon_from_scene(scene, dev)
    es = exp_scale_factor()
    for i in range(burst.shape[0]):
        d = os.path.join(burst_dir, f"samsung_{i:02d}")
        os.makedirs(d, exist_ok=True)
        u16 = np.round(SAMSUNG_BLACK
                       + burst[i] * (SAMSUNG_MAX - SAMSUNG_BLACK))
        _write_png16(os.path.join(d, "im_raw.png"), u16)
        with open(os.path.join(d, "meta_info.pkl"), "wb") as f:
            pickle.dump({
                "black_level": [SAMSUNG_BLACK] * 4,
                "cam_wb": [1024.0, 1024.0, 1024.0, 1024.0],
                "daylight_wb": [1024.0, 1024.0, 1024.0, 1024.0],
                "color_matrix": np.eye(3, dtype=np.float32).ravel().tolist(),
                "exif_data": dict(SAMSUNG_EXIF),
                "im_preview": None,
            }, f)
    d = os.path.join(burst_dir, "canon")
    os.makedirs(d, exist_ok=True)
    # stored so that (stored - black) / 16383 x exp_scale ~= canon_content
    u16 = np.round(CANON_BLACK
                   + canon_content / es * (CANON_MAX - CANON_BLACK))
    _write_png16(os.path.join(d, "im_raw.png"), np.clip(u16, 0, CANON_MAX))
    with open(os.path.join(d, "meta_info.pkl"), "wb") as f:
        pickle.dump({
            "black_level": [CANON_BLACK] * 4,
            "cam_wb": [1024.0, 1024.0, 1024.0, 1024.0],
            "daylight_wb": [1024.0, 1024.0, 1024.0, 1024.0],
            "rgb_xyz_matrix": np.eye(3, dtype=np.float32).ravel().tolist(),
            "exif_data": dict(CANON_EXIF),
        }, f)
    np.save(os.path.join(burst_dir, "scene_linear.npy"), scene)


def generate_dataset(out_root: str, bursts: int = 2, lr: int = 96,
                     n_frames: int = 14, split: str = "val", seed: int = 0,
                     device="cuda") -> list:
    """Write ``bursts`` bursts named ``<scene id>_0001`` after the first
    scene ids of ``split``; returns their names."""
    from dbsr_tpu_torch import resolve_device
    from dbsr_tpu_torch.data.burstsr import load_split_ids

    dev = resolve_device(device)
    ids = load_split_ids(split)
    names = []
    for b in range(bursts):
        name = f"{ids[b]}_0001"
        burst_dir = os.path.join(out_root, split, name)
        burst, scene = generate_burst(dev, seed, b, lr, n_frames)
        write_burst_dir(burst_dir, burst, scene, dev)
        names.append(name)
        print(f"wrote {burst_dir} (burst {burst.shape}, scene "
              f"{scene.shape})", flush=True)
    return names


def main(argv=None):
    ap = argparse.ArgumentParser(description="Write a BurstSR-format tree "
                                             "with a known misregistration.")
    ap.add_argument("--out", required=True)
    ap.add_argument("--bursts", type=int, default=2)
    ap.add_argument("--lr", type=int, default=96,
                    help="packed burst-frame size (the ground truth is 8x)")
    ap.add_argument("--frames", type=int, default=14)
    ap.add_argument("--split", default="val")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    generate_dataset(args.out, args.bursts, args.lr, args.frames,
                     args.split, args.seed, args.device)


if __name__ == "__main__":
    main()
