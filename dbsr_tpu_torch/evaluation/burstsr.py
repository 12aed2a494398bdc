"""BurstSR evaluation: aligned PSNR / SSIM on the real-world val set (port
of ``dbsr_tpu/evaluation/burstsr.py``).

Every prediction goes through spatial-and-colour alignment
(``models/sca.py``: a warp to the DSLR ground truth, a least-squares
colour match and a validity mask) before the masked metrics. SCA's flow
comes from the scored network's own aligner (``encoder.alignment_net``),
so no other flow network is needed: AlignLite is applied coarse to fine,
PWC-Net directly, in float32 whatever the network's compute dtype (the
JAX package builds SCA's aligner without one). Bursts are scored one at a
time, the network at the dtype its checkpoint records, everything else
in float32 with TF32 off; the per-burst metrics stay on the device until
one fetch after the loop. With LPIPS weights (as in
``evaluation/synburst.py``) each burst's LPIPS is taken on the SCA-aligned
prediction, on the device, as the JAX package does.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from dbsr_tpu_torch import resolve_device
from dbsr_tpu_torch.data.burstsr import get_burstsr_val_set
from dbsr_tpu_torch.evaluation.display import generate_formatted_report
from dbsr_tpu_torch.evaluation.network_param import NetworkParam
from dbsr_tpu_torch.evaluation.synburst import _mark, load_lpips_or_none
from dbsr_tpu_torch.models.align_lite import AlignLiteNet, coarse_to_fine_flow
from dbsr_tpu_torch.models.layers import compute_dtype_of, set_compute_dtype
from dbsr_tpu_torch.models.pwcnet import PWCNet
from dbsr_tpu_torch.models.sca import make_sca
from dbsr_tpu_torch.ops import metrics as M
from dbsr_tpu_torch.serving import float32_math
from dbsr_tpu_torch.utils.png16 import write_png

_Q = 2 ** 14


def _alignment_apply_from(aligner: torch.nn.Module):
    """SCA's ``(source, target) -> flow`` from a network's aligner
    (``net.encoder.alignment_net``): AlignLite coarse to fine (scales 4 ->
    1: SCA's full-RGB images are 8x the packed pitch it trains at; applied
    directly it recovers ~20% of a 7 px shift), PWC-Net directly; in
    float32 (a float32 copy of an aligner that computes in bf16)."""
    if compute_dtype_of(aligner) is not None:
        aligner = copy.deepcopy(aligner)
        set_compute_dtype(aligner, None)
    if isinstance(aligner, AlignLiteNet):
        return lambda s, t: coarse_to_fine_flow(aligner, s, t)
    if isinstance(aligner, PWCNet):
        return aligner
    raise TypeError(f"SCA: no flow for an aligner of type "
                    f"{type(aligner).__name__}")


def _forward_fn(net):
    """The network's prediction of one burst ``[N, h, w, 4]`` on its
    device, clipped to [0, 1]: ``[H, W, 3]``."""

    @torch.inference_mode()
    def forward(burst):
        with float32_math():
            return net(burst[None])[0][0].clamp(0.0, 1.0)

    return forward


def _burst(sample, burst_sz):
    return sample["burst"][:burst_sz] if burst_sz else sample["burst"]


def save_results(network_params: List[NetworkParam], dataset_root: str,
                 out_dir: str, workspace_dir: str = "", dataset=None,
                 device="cuda") -> None:
    """The raw (unaligned) predictions of each network on the val set as
    uint16 PNGs at 2^14, ``<out_dir>/<name>/<burst name>.png``."""
    dev = resolve_device(device)
    dataset = dataset or get_burstsr_val_set(dataset_root)
    for n in network_params:
        net, _ = n.load_net(workspace_dir, device=dev)
        forward = _forward_fn(net)
        d = os.path.join(out_dir, n.get_unique_name())
        os.makedirs(d, exist_ok=True)
        for idx in range(len(dataset)):
            sample = dataset[idx]
            burst = torch.from_numpy(_burst(sample, n.burst_sz)).to(dev)
            arr = (forward(burst).cpu().numpy() * _Q).astype(np.uint16)
            write_png(os.path.join(d, f"{sample['burst_name']}.png"), arr)


def _scored_fn(net, sca, boundary_ignore: int, lpips_fn=None):
    """``(burst [N, h, w, 4], gt [H, W, 3]) -> {"psnr", "ssim"}`` of the
    SCA-aligned prediction, masked, on the device, and its ``"lpips"``
    (unmasked) with ``lpips_fn``. With ``events`` (a list, on the card) it
    appends a CUDA event before the forward, SCA, the metrics and LPIPS,
    and after."""

    @torch.inference_mode()
    def scored(burst, gt, events=None):
        with float32_math():
            _mark(events)
            pred = net(burst[None])[0].clamp(0.0, 1.0)
            _mark(events)
            pred_m, valid = sca(pred, gt[None], burst[None])
            valid = valid.to(torch.float32)
            _mark(events)
            out = {"psnr": M.psnr(pred_m, gt[None],
                                  boundary_ignore=boundary_ignore,
                                  valid=valid),
                   "ssim": M.ssim_metric(pred_m, gt[None],
                                         boundary_ignore=boundary_ignore,
                                         valid=valid)}
            _mark(events)
            if lpips_fn is not None:
                out["lpips"] = lpips_fn(pred_m[0], gt, boundary_ignore)
                _mark(events)
        return out

    return scored


def compute_score(network_params: List[NetworkParam], dataset_root: str,
                  workspace_dir: str = "", boundary_ignore: int = 40,
                  max_bursts: Optional[int] = None, with_lpips: bool = True,
                  dataset=None, sr_factor: int = 4, device="cuda",
                  timing: Optional[Dict] = None,
                  lpips_weights: Optional[str] = None,
                  per_burst: Optional[Dict] = None) -> Dict:
    """Aligned PSNR / SSIM (/ LPIPS, given its weights) means over the
    BurstSR val set, ``{metric: {display name: mean}}``. Prints one
    ``[timing]`` line per network and the report; with a dict ``timing``,
    each network's numbers also go there under its display name:
    ``bursts``, ``wall_s``, ``forward_ms``, ``sca_ms``, ``metrics_ms`` and,
    with LPIPS, ``lpips_ms`` (summed over the bursts, by CUDA events; None
    off the card), ``reader_s`` (the val set's reads and PNG decodes),
    ``transfer_s`` and ``fetch_s``. With a dict ``per_burst``, each
    network's per-burst values go into it, ``{display name: {metric:
    array}}``."""
    dev = resolve_device(device)
    dataset = dataset or get_burstsr_val_set(dataset_root)
    n_bursts = min(len(dataset), max_bursts or len(dataset))
    lpips_fn = load_lpips_or_none(with_lpips, lpips_weights)

    metric_names = ["psnr", "ssim"] + (["lpips"] if lpips_fn else [])
    parts = ["forward_ms", "sca_ms", "metrics_ms"] + (
        ["lpips_ms"] if lpips_fn else [])
    scores_all: Dict[str, Dict[str, float]] = {m: {} for m in metric_names}
    names = []
    for n in network_params:
        name = n.get_display_name()
        names.append(name)
        net, _ = n.load_net(workspace_dir, device=dev)
        sca = make_sca(_alignment_apply_from(net.encoder.alignment_net),
                       sr_factor=sr_factor)
        scored = _scored_fn(net, sca, boundary_ignore, lpips_fn)
        events = [] if dev.type == "cuda" else None
        pending = []
        reader_s = transfer_s = 0.0
        t_loop = time.perf_counter()
        for idx in range(n_bursts):
            t0 = time.perf_counter()
            sample = dataset[idx]
            t1 = time.perf_counter()
            burst = torch.from_numpy(_burst(sample, n.burst_sz)).to(dev)
            gt = torch.from_numpy(sample["frame_gt"]).to(dev)
            t2 = time.perf_counter()
            reader_s += t1 - t0
            transfer_s += t2 - t1
            pending.append(scored(burst, gt, events))
        t_fetch = time.perf_counter()
        vals = torch.stack([torch.stack([s[m] for s in pending])
                            for m in metric_names]).cpu().numpy()
        t_end = time.perf_counter()
        k = len(parts) + 1  # events per burst
        t = dict(bursts=n_bursts, wall_s=t_end - t_loop,
                 **{p: (sum(events[k * i + j].elapsed_time(
                     events[k * i + j + 1]) for i in range(n_bursts))
                     if events else None) for j, p in enumerate(parts)},
                 reader_s=reader_s, transfer_s=transfer_s,
                 fetch_s=t_end - t_fetch)
        if timing is not None:
            timing[name] = t
        if per_burst is not None:
            per_burst[name] = dict(zip(metric_names, vals))
        device_ms = ("not measured" if not events else ", ".join(
            f"{p[:-3].replace('sca', 'SCA')} {t[p]:.3f} ms" for p in parts))
        print(f"[timing] {name}: {n_bursts} bursts, wall {t['wall_s']:.3f} "
              f"s; on the device {device_ms}; reader {reader_s:.3f} s; "
              f"transfer {transfer_s:.3f} s; fetch {t['fetch_s']:.3f} s",
              flush=True)
        for m, v in zip(metric_names, vals):
            scores_all[m][name] = float(np.mean(v, dtype=np.float64))

    print(generate_formatted_report(names, scores_all))
    return scores_all
