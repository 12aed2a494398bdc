"""Result visualization: PNG panels and an interactive HTML viewer (port of
``dbsr_tpu/evaluation/visualize.py``).

Per burst, three panes (the base frame upsampled, the prediction, the
ground truth) and one side-by-side panel with the PSNR in its name, then
``index.html`` over the panes (``evaluation/html_viewer.py``). Each
network runs at batch 1 at the dtype its checkpoint records, on the card
unless asked for the CPU; the forward, SCA, the metrics and the display
ISP stay on the device, and only the finished images and the PSNR come
back. PNGs are written by the port's own codec (``utils/png16.py``).

``_postprocess`` renders a synthetic burst's linear images through the
synthesis-time ISP where the burst's meta holds its parameters, and shows
the raw image where it does not. The JAX package falls back to the raw
image on any exception; here only missing ISP keys do, so that a real
error in the ISP raises.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from dbsr_tpu_torch import resolve_device
from dbsr_tpu_torch.data.datasets import SyntheticBurstVal
from dbsr_tpu_torch.evaluation.html_viewer import write_viewer
from dbsr_tpu_torch.evaluation.network_param import NetworkParam
from dbsr_tpu_torch.ops import metrics as M
from dbsr_tpu_torch.ops.camera import demosaic_naive, process_linear_image_rgb
from dbsr_tpu_torch.ops.interp import resize_bilinear
from dbsr_tpu_torch.serving import float32_math
from dbsr_tpu_torch.utils.png16 import write_png

# the meta keys the display ISP needs (process_linear_image_rgb)
_ISP_KEYS = ("cam2rgb", "rgb_gain", "red_gain", "blue_gain")


def _to_u8(im: np.ndarray) -> np.ndarray:
    return (np.clip(im, 0, 1) * 255).astype(np.uint8)


def _postprocess(im: torch.Tensor, meta: dict) -> torch.Tensor:
    """``im`` through the synthesis-time ISP when ``meta`` holds its
    parameters, else ``im`` as it is."""
    if any(k not in meta for k in _ISP_KEYS):
        return im
    return process_linear_image_rgb(im, meta)


def _base_frame(burst: torch.Tensor, hw) -> torch.Tensor:
    """The burst's first frame, demosaiced naively and upsampled to
    ``hw``."""
    return resize_bilinear(demosaic_naive(burst[0]), tuple(hw))


def _write_burst(d: str, name: str, panes: dict, info: str,
                 panel_name: str) -> dict:
    """Write each pane and the side-by-side panel of ``panes`` (label ->
    uint8 image); returns the viewer's entry."""
    entry = {"name": name, "info": info, "panes": {}}
    for label, im in panes.items():
        fn = f"{name}_{label.split()[0]}.png"
        write_png(os.path.join(d, fn), im)
        entry["panes"][label] = fn
    write_png(os.path.join(d, panel_name),
              np.concatenate(list(panes.values()), axis=1))
    return entry


def visualize_synburst(network_params: List[NetworkParam],
                       dataset_root: str, out_dir: str,
                       workspace_dir: str = "", max_bursts: int = 10,
                       boundary_ignore: int = 40, dataset=None,
                       device="cuda") -> None:
    """SyntheticBurstVal panels, ``<out_dir>/<net>/{burst}_{base|prediction|
    ground}.png``, ``{burst}_psnr{psnr:.2f}.png`` and ``index.html``: the
    first ``max_bursts`` bursts, each image through the display ISP."""
    dev = resolve_device(device)
    dataset = dataset if dataset is not None \
        else SyntheticBurstVal(dataset_root)
    os.makedirs(out_dir, exist_ok=True)
    for n in network_params:
        net, _ = n.load_net(workspace_dir, device=dev)
        d = os.path.join(out_dir, n.get_unique_name())
        os.makedirs(d, exist_ok=True)
        entries = []
        for idx in range(min(max_bursts, len(dataset))):
            burst, gt, meta = dataset[idx]
            b = burst[:n.burst_sz] if n.burst_sz else burst
            with torch.inference_mode(), float32_math():
                b = torch.from_numpy(b).to(dev)
                gt_d = torch.from_numpy(gt).to(dev)
                pred = net(b[None])[0][0].clamp(0.0, 1.0)
                psnr = M.psnr(pred[None], gt_d[None],
                              boundary_ignore=boundary_ignore)
                host = [_postprocess(x, meta).cpu().numpy() for x in
                        (_base_frame(b, gt.shape[:2]), pred, gt_d)]
            psnr = float(psnr)
            name = meta["burst_name"]
            entries.append(_write_burst(
                d, name, dict(zip(("base frame", "prediction",
                                   "ground truth"), map(_to_u8, host))),
                f"PSNR {psnr:.2f} dB", f"{name}_psnr{psnr:.2f}.png"))
        write_viewer(d, f"synburst: {n.get_unique_name()}", entries)


def visualize_burstsr(network_params: List[NetworkParam], dataset_root: str,
                      out_dir: str, workspace_dir: str = "",
                      max_bursts: int = 5, sr_factor: int = 4,
                      device="cuda") -> None:
    """BurstSR panels: the base frame upsampled, the SCA-aligned
    prediction and the DSLR ground truth, ``{burst}_apsnr{psnr:.2f}.png``
    with the aligned PSNR (masked, boundary 40), and ``index.html``; the
    val set's first ``max_bursts`` bursts."""
    from dbsr_tpu_torch.data.burstsr import get_burstsr_val_set
    from dbsr_tpu_torch.evaluation.burstsr import _alignment_apply_from
    from dbsr_tpu_torch.models.sca import make_sca

    dev = resolve_device(device)
    dataset = get_burstsr_val_set(dataset_root)
    os.makedirs(out_dir, exist_ok=True)
    for n in network_params:
        net, _ = n.load_net(workspace_dir, device=dev)
        sca = make_sca(_alignment_apply_from(net.encoder.alignment_net),
                       sr_factor=sr_factor)
        d = os.path.join(out_dir, n.get_unique_name())
        os.makedirs(d, exist_ok=True)
        entries = []
        for idx in range(min(max_bursts, len(dataset))):
            sample = dataset[idx]
            b = sample["burst"][:n.burst_sz] if n.burst_sz \
                else sample["burst"]
            with torch.inference_mode(), float32_math():
                burst = torch.from_numpy(b).to(dev)
                gt = torch.from_numpy(sample["frame_gt"]).to(dev)
                pred = net(burst[None])[0].clamp(0.0, 1.0)
                pred_m, valid = sca(pred, gt[None], burst[None])
                psnr = M.psnr(pred_m, gt[None], boundary_ignore=40,
                              valid=valid.to(torch.float32))
                host = [x.cpu().numpy() for x in
                        (_base_frame(burst, gt.shape[:2]), pred_m[0], gt)]
            psnr = float(psnr)
            name = sample["burst_name"]
            entries.append(_write_burst(
                d, name, dict(zip(("base frame", "aligned prediction",
                                   "DSLR ground truth"), map(_to_u8, host))),
                f"aligned PSNR {psnr:.2f} dB", f"{name}_apsnr{psnr:.2f}.png"))
        write_viewer(d, f"burstsr: {n.get_unique_name()}", entries)
