"""SyntheticBurstVal evaluation: save predictions and compute scores (port
of ``dbsr_tpu/evaluation/synburst.py``).

Per network: the forward on each batch of validation bursts (at the
compute dtype its checkpoint records, as the JAX package scores), the
predictions quantized to uint16 at 2^14 (the protocol step that makes the
scores of saved predictions equal the live ones), and PSNR / SSIM /
(optional) MS-SSIM per burst with ``boundary_ignore=40``, averaged over
the set. The forward, the quantization and the metrics run on the device
in one function per batch, under ``torch.inference_mode()`` with TF32 off;
the per-burst results stay on the device until one fetch after the loop.
The val set's reads and PNG decodes run on a background thread. With LPIPS
weights (``lpips_weights``, ``DBSR_TPU_LPIPS_WEIGHTS`` or the pretrained
nets' ``lpips_alex.npz``) each batch's bursts also get their LPIPS, in one
pass over the batch, on the float32 quantized prediction and ground truth,
still on the device.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from dbsr_tpu_torch import resolve_device
from dbsr_tpu_torch.data.datasets import SyntheticBurstVal
from dbsr_tpu_torch.evaluation.display import generate_formatted_report
from dbsr_tpu_torch.evaluation.network_param import NetworkParam
from dbsr_tpu_torch.ops import metrics as M
from dbsr_tpu_torch.serving import float32_math
from dbsr_tpu_torch.utils.png16 import read_png, write_png

_Q = 2 ** 14


def quantize(pred: torch.Tensor) -> torch.Tensor:
    """The uint16 2^14 round trip: clip to [0, 1], scale, truncate."""
    q = pred.clamp(0.0, 1.0) * _Q
    return q.to(torch.int32).to(torch.float32) / _Q


def _host_u16(a: np.ndarray) -> np.ndarray:
    """Host-side uint16 transfer encoding: val-set bursts and GTs come from
    uint16 PNGs at 2^14, so ``rint(a * 2^14)`` recovers the stored integers
    exactly, in half the bytes of float32."""
    return np.rint(a * _Q).astype(np.uint16)


def _dev_f32(a: torch.Tensor) -> torch.Tensor:
    """Undo :func:`_host_u16` on the device (float32 passes through)."""
    if a.dtype == torch.uint16:
        return a.to(torch.float32) / _Q
    return a


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``; to a card through pinned memory, without
    waiting for the work already queued there."""
    t = torch.from_numpy(a)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def _forward_fn(net):
    """The network's clipped prediction of a (uint16 or float32) burst
    batch on the net's device."""

    @torch.inference_mode()
    def forward(bursts):
        with float32_math():
            pred = net(_dev_f32(bursts))[0]
        return pred.clamp(0.0, 1.0)

    return forward


def load_lpips_or_none(with_lpips: bool, lpips_weights: Optional[str]):
    """The LPIPS function when asked for and its weights are found; else
    None, printing why (the JAX package's message). Only missing weights
    are skipped: a weights file that does not load raises."""
    if not with_lpips:
        return None
    from dbsr_tpu_torch.models.lpips import load_lpips

    try:
        return load_lpips(lpips_weights)
    except FileNotFoundError as e:
        print(f"LPIPS unavailable ({e}); skipping")
        return None


def _scored_forward_fn(net, score_fn):
    """Forward, protocol quantization and per-sample metrics of one batch,
    all on the device: ``(bursts, gts) -> {metric: [B]}``."""
    forward = _forward_fn(net)

    def forward_score(bursts, gts):
        return score_fn(quantize(forward(bursts)), gts)

    return forward_score


def _iter_burst_batches(dataset, n_bursts: int, batch_size: int,
                        burst_sz: Optional[int], with_gt: bool = True,
                        u16_transfer: bool = False,
                        read_s: Optional[list] = None):
    """Yield ``(metas, bursts [b <= batch_size, ...], gts | None)`` with the
    dataset reads (disk and PNG decode) on a background thread, ahead of
    the caller. ``u16_transfer`` re-encodes to uint16 on that thread (see
    :func:`_host_u16`). A reader error re-raises in the caller. With a list
    ``read_s``, the thread appends its seconds of work per batch."""
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=2)
    err = []

    def worker():
        try:
            for lo in range(0, n_bursts, batch_size):
                t0 = time.perf_counter()
                idxs = range(lo, min(lo + batch_size, n_bursts))
                items = [dataset[i] for i in idxs]
                bursts = np.stack([
                    it[0][:burst_sz] if burst_sz else it[0] for it in items])
                gts = np.stack([it[1] for it in items]) if with_gt else None
                if u16_transfer:
                    bursts = _host_u16(bursts)
                    gts = _host_u16(gts) if gts is not None else None
                if read_s is not None:
                    read_s.append(time.perf_counter() - t0)
                q.put(([it[2] for it in items], bursts, gts))
            q.put(None)
        except Exception as e:  # handed to the caller, raised there
            err.append(e)
            q.put(None)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is None:
            if err:
                raise err[0]
            return
        yield item


def _pad_to(arr: np.ndarray, batch_size: int) -> np.ndarray:
    """Pad the leading dim to ``batch_size`` by repeating the last row (one
    shape for every forward; padded outputs are discarded)."""
    n = arr.shape[0]
    if n == batch_size:
        return arr
    reps = np.repeat(arr[-1:], batch_size - n, axis=0)
    return np.concatenate([arr, reps], axis=0)


def _mark(marks: Optional[list]) -> None:
    """Record a CUDA event at this point of the stream into ``marks`` (a
    list; None off the card)."""
    if marks is not None:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()


def _fetch(pending, metric_names: List[str]) -> Dict[str, np.ndarray]:
    """The per-burst values of every batch's results, padding dropped, in
    one device-to-host copy."""
    stacked = torch.stack([torch.cat([s[m][:nb] for nb, s in pending])
                           for m in metric_names]).cpu().numpy()
    return dict(zip(metric_names, stacked))


def save_results(network_params: List[NetworkParam], dataset_root: str,
                 out_dir: str, workspace_dir: str = "",
                 dataset=None, batch_size: int = 8, device="cuda") -> None:
    """Run each network on the whole validation set and write its
    predictions as uint16 PNGs at 2^14, ``<out_dir>/<name>/<burst>.png``."""
    dev = resolve_device(device)
    dataset = dataset or SyntheticBurstVal(dataset_root)
    batch_size = min(batch_size, len(dataset))
    for n in network_params:
        net, _ = n.load_net(workspace_dir, device=dev)
        forward = _forward_fn(net)
        d = os.path.join(out_dir, n.get_unique_name())
        os.makedirs(d, exist_ok=True)
        for metas, bursts, _ in _iter_burst_batches(
                dataset, len(dataset), batch_size, n.burst_sz,
                with_gt=False, u16_transfer=True):
            nb = bursts.shape[0]
            preds = forward(_to_device(_pad_to(bursts, batch_size), dev))
            preds = preds[:nb].cpu().numpy()
            for meta, pred in zip(metas, preds):
                arr = (pred * _Q).astype(np.uint16)
                write_png(os.path.join(d, f"{meta['burst_name']}.png"), arr)


def _make_score_batch(boundary_ignore: int, with_msssim: bool):
    """Per-sample protocol metrics of a batch, ``(preds, gts) ->
    {metric: [B]}`` (each burst scored alone, averaged at the end)."""
    b = boundary_ignore

    def one(pred, gt):
        out = {"psnr": M.psnr(pred[None], gt[None], boundary_ignore=b),
               "ssim": M.ssim_metric(pred[None], gt[None],
                                     boundary_ignore=b)}
        if with_msssim:
            out["msssim"] = M.msssim(
                pred[None, b:-b, b:-b] if b else pred[None],
                gt[None, b:-b, b:-b] if b else gt[None])
        return out

    per_sample = torch.func.vmap(one)

    @torch.inference_mode()
    def score_batch(preds, gts):
        return per_sample(_dev_f32(preds), _dev_f32(gts))

    return score_batch


def compute_score(network_params: List[NetworkParam], dataset_root: str,
                  workspace_dir: str = "",
                  saved_results_root: Optional[str] = None,
                  boundary_ignore: int = 40,
                  with_lpips: bool = True,
                  with_msssim: bool = False,
                  max_bursts: Optional[int] = None,
                  dataset=None, batch_size: int = 8, device="cuda",
                  timing: Optional[Dict] = None,
                  lpips_weights: Optional[str] = None,
                  per_burst: Optional[Dict] = None) -> Dict:
    """PSNR / SSIM (/ LPIPS) (/ MS-SSIM) means over the validation set,
    ``{metric: {display name: mean}}``. ``saved_results_root`` scores
    predictions that :func:`save_results` wrote instead of running the
    nets. LPIPS needs its weights (``lpips_weights``, else
    ``models/lpips.default_weights_path``); without them the report has
    no ``lpips`` column. Prints one ``[timing]`` line per network and the
    report; with a dict ``timing``, each network's numbers also go into it
    under its display name: ``bursts``, ``wall_s``, ``device_ms`` (the
    forwards and scoring by CUDA events) and its parts ``forward_ms``,
    ``metrics_ms`` and, with LPIPS, ``lpips_ms`` (each None off the card),
    ``reader_s`` (the reader thread's work), ``waited_s`` (the loop's wait
    for its inputs, saved predictions read included), ``transfer_s`` (host
    to device) and ``fetch_s``. With a dict ``per_burst``, each network's
    per-burst values go into it, ``{display name: {metric: array}}``."""
    dev = resolve_device(device)
    dataset = dataset or SyntheticBurstVal(dataset_root)
    n_bursts = min(len(dataset), max_bursts or len(dataset))
    lpips_fn = load_lpips_or_none(with_lpips, lpips_weights)

    metric_names = ["psnr", "ssim"] + (["lpips"] if lpips_fn else []) + (
        ["msssim"] if with_msssim else [])
    parts = ["forward_ms", "metrics_ms"] + (["lpips_ms"] if lpips_fn else [])
    scores_all: Dict[str, Dict[str, float]] = {m: {} for m in metric_names}

    batch_size = min(batch_size, n_bursts)
    score_batch = _make_score_batch(boundary_ignore, with_msssim)

    names = []
    for n in network_params:
        name = n.get_display_name()
        names.append(name)
        live = n.saved_results_path is None and saved_results_root is None
        if live:
            net, _ = n.load_net(workspace_dir, device=dev)
            forward = _forward_fn(net)

        def load_saved_batch(metas):
            root = n.saved_results_path or os.path.join(
                saved_results_root, n.get_unique_name())
            return np.stack([read_png(os.path.join(
                root, f"{m['burst_name']}.png")) for m in metas])

        pending, events, read_s = [], [], []
        wait_s = transfer_s = 0.0
        t_loop = time.perf_counter()
        batches = _iter_burst_batches(dataset, n_bursts, batch_size,
                                      n.burst_sz, u16_transfer=True,
                                      read_s=read_s)
        while True:
            t0 = time.perf_counter()
            item = next(batches, None)
            if item is not None and not live:
                item = (item[0], load_saved_batch(item[0]), item[2])
            wait_s += time.perf_counter() - t0
            if item is None:
                break
            metas, bursts, gts = item
            nb = len(metas)
            t0 = time.perf_counter()
            inputs = _to_device(_pad_to(bursts, batch_size), dev)
            gts = _to_device(_pad_to(gts, batch_size), dev)
            transfer_s += time.perf_counter() - t0
            marks = [] if dev.type == "cuda" else None
            _mark(marks)
            preds = quantize(forward(inputs)) if live else inputs
            _mark(marks)
            s = score_batch(preds, gts)
            _mark(marks)
            if lpips_fn is not None:
                s["lpips"] = lpips_fn(_dev_f32(preds[:nb]),
                                      _dev_f32(gts[:nb]), boundary_ignore,
                                      reduce=False)
                _mark(marks)
            pending.append((nb, s))
            if marks is not None:
                events.append(marks)
        t_fetch = time.perf_counter()
        vals = _fetch(pending, metric_names)
        t_end = time.perf_counter()
        t = dict(bursts=n_bursts, wall_s=t_end - t_loop,
                 device_ms=(sum(e[0].elapsed_time(e[-1]) for e in events)
                            if events else None),
                 **{p: (sum(e[k].elapsed_time(e[k + 1]) for e in events)
                        if events else None) for k, p in enumerate(parts)},
                 reader_s=sum(read_s), waited_s=wait_s,
                 transfer_s=transfer_s, fetch_s=t_end - t_fetch)
        if timing is not None:
            timing[name] = t
        if per_burst is not None:
            per_burst[name] = vals
        device_ms = ("not measured" if t["device_ms"] is None
                     else f"{t['device_ms']:.3f} ms")
        print(f"[timing] {name}: {n_bursts} bursts, wall {t['wall_s']:.3f} "
              f"s; forward and scoring on the device {device_ms}; reader "
              f"thread {t['reader_s']:.3f} s, waited {wait_s:.3f} s; "
              f"transfer {transfer_s:.3f} s; fetch {t['fetch_s']:.3f} s",
              flush=True)
        for m in metric_names:
            scores_all[m][name] = float(np.mean(vals[m]))

    print(generate_formatted_report(names, scores_all))
    return scores_all


class TrajectoryScorer:
    """The val set staged on the device once, then any number of a run's
    checkpoints scored against it (the engine of
    :func:`compute_score_trajectory`). No LPIPS."""

    def __init__(self, dataset_root: str, boundary_ignore: int = 40,
                 with_msssim: bool = False,
                 max_bursts: Optional[int] = None,
                 burst_sz: Optional[int] = None,
                 dataset=None, batch_size: int = 8, device="cuda"):
        self.device = resolve_device(device)
        dataset = dataset or SyntheticBurstVal(dataset_root)
        n_bursts = min(len(dataset), max_bursts or len(dataset))
        self.batch_size = min(batch_size, n_bursts)
        self.metric_names = ["psnr", "ssim"] + (
            ["msssim"] if with_msssim else [])
        self._score_batch = _make_score_batch(boundary_ignore, with_msssim)
        self.staged = []
        for _, bursts, gts in _iter_burst_batches(
                dataset, n_bursts, self.batch_size, burst_sz,
                u16_transfer=True):
            self.staged.append(
                (bursts.shape[0],
                 _to_device(_pad_to(bursts, self.batch_size), self.device),
                 _to_device(_pad_to(gts, self.batch_size), self.device)))

    def score(self, module: str, parameter: str, workspace_dir: str = "",
              net_name: str = "dbsr_synthetic",
              epochs: Optional[List[int]] = None) -> Dict:
        """Score the run's checkpoints (all, or the given epochs):
        ``{metric: {"<module>_<parameter>_epNNNN": mean}}``, by epoch."""
        from dbsr_tpu_torch.training.checkpoint import (list_checkpoints,
                                                        load_network)

        ckpt_dir = os.path.join(workspace_dir, module, parameter)
        all_ck = list_checkpoints(ckpt_dir, net_name)
        if epochs is not None:
            want = set(epochs)
            all_ck = [(e, p) for e, p in all_ck if e in want]
        if not all_ck:
            raise FileNotFoundError(
                f"no checkpoints for {module}/{parameter} in {ckpt_dir}")

        scores_all: Dict[str, Dict[str, float]] = {
            m: {} for m in self.metric_names}
        names = []
        for e, path in all_ck:
            net, _ = load_network(path, device=self.device)
            scored_forward = _scored_forward_fn(net, self._score_batch)
            vals = _fetch([(nb, scored_forward(b, g))
                           for nb, b, g in self.staged], self.metric_names)
            name = f"{module}_{parameter}_ep{e:04d}"
            names.append(name)
            for m in self.metric_names:
                scores_all[m][name] = float(np.mean(vals[m]))
            print("[trajectory] " + name + ": " + ", ".join(
                f"{m}={scores_all[m][name]:.4f}"
                for m in self.metric_names), flush=True)

        print(generate_formatted_report(names, scores_all))
        return scores_all


def compute_score_trajectory(module: str, parameter: str, dataset_root: str,
                             workspace_dir: str = "",
                             net_name: str = "dbsr_synthetic",
                             epochs: Optional[List[int]] = None,
                             boundary_ignore: int = 40,
                             with_msssim: bool = False,
                             max_bursts: Optional[int] = None,
                             burst_sz: Optional[int] = None,
                             dataset=None, batch_size: int = 8,
                             device="cuda") -> Dict:
    """Score every checkpoint of a training run in one process (one
    :class:`TrajectoryScorer`)."""
    scorer = TrajectoryScorer(dataset_root, boundary_ignore=boundary_ignore,
                              with_msssim=with_msssim,
                              max_bursts=max_bursts, burst_sz=burst_sz,
                              dataset=dataset, batch_size=batch_size,
                              device=device)
    return scorer.score(module, parameter, workspace_dir=workspace_dir,
                        net_name=net_name, epochs=epochs)
