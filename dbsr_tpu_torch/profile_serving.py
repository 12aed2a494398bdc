"""Where the serving forward's device time goes, on one CUDA card.

    python -m dbsr_tpu_torch.profile_serving \
        [--decoder {s2d_dense,s2d_kernel,fine}]

Loads the banked flagship checkpoint at full width into the predictor
(batch 8; float32, TF32 off) with the decoder in the given form
(``s2d_dense``, the default: the s2d layout that ``load_predictor``
defaults to, with ``DBSR_FINE_PATCH_S2D`` unset, so its 3x3 convs run as
the structured-dense conv; ``s2d_kernel``: the same with
``DBSR_FINE_PATCH_S2D=1``, the fine-patch conv kernel; ``fine``:
``fused_s2d=False``), warms up, then traces three forwards with
``torch.profiler``.
Prints the device time by kernel (top 15), grouped into the port's own
kernels, convolutions and the rest, and the device's busy share of the
traced wall time; the last line is the same as one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dbsr_tpu_torch.serving import FLAGSHIP_CHECKPOINT, load_predictor

BATCH, FORWARDS = 8, 3
OWN_KERNELS = ("warp_kernel", "correlation_kernel", "merge_kernel",
               "resample_kernel", "dfeat_kernel", "dflow_kernel",
               "merge_bwd_kernel", "dfirst_kernel", "dsecond_kernel",
               "conv_s2d_kernel")
DECODERS = ("s2d_dense", "s2d_kernel", "fine")


def kernel_group(name: str) -> str:
    """Group of a device kernel by its name: the port's own kernels,
    cuDNN's convolutions and layout transposes, the optimizer, the rest."""
    low = name.lower()
    if any(k in name for k in OWN_KERNELS):
        return "port kernels"
    if "nchwToNhwc" in name or "nhwcToNchw" in name:
        return "layout transposes (cuDNN NCHW <-> NHWC)"
    if any(k in low for k in ("conv", "cudnn", "xmma", "implicit", "gemm",
                              "winograd", "fft", "pointwise_mult_and_sum",
                              "wgrad", "dgrad")):
        return "convolution (cuDNN)"
    if "multi_tensor_apply" in low or "adam" in low:
        return "optimizer (Adam)"
    return "other (elementwise, copies, cat, pad, gather)"


def kernel_us(evt) -> float:
    """Device time of a kernel row of ``key_averages()``; 0 for host rows
    (operators, runtime calls), whose device totals repeat their kernels',
    and for the device-side spans of ``record_function`` labels (torch.optim
    labels every ``step``), which cover kernels counted in their own rows."""
    if evt.device_type != DeviceType.CUDA or getattr(
            evt, "is_user_annotation", False):  # absent in older torch
        return 0.0
    return float(evt.self_device_time_total)


def conv_flops(pred, x: torch.Tensor) -> int:
    """Operations of every ``nn.Conv2d`` in one forward of the predictor
    ``pred`` on ``x`` (2 per multiply-add), counted from the shapes by
    forward hooks: the true work of each conv, whatever form computes it
    (an s2d ``ConvBlock`` uses its ``Conv_0``'s parameters without calling
    it, and its output holds as many values as the fine one)."""
    from dbsr_tpu_torch.models.layers import ConvBlock

    total = 0

    def count(conv, out):
        nonlocal total
        kh, kw = conv.kernel_size
        total += 2 * out.numel() * (conv.in_channels // conv.groups) * kh * kw

    hooks = [m.register_forward_hook(lambda mod, _i, out: count(mod, out))
             for m in pred.net.modules() if isinstance(m, torch.nn.Conv2d)]
    hooks += [m.register_forward_hook(
        lambda mod, _i, out: count(mod.Conv_0, out))
        for m in pred.net.modules() if isinstance(m, ConvBlock) and m.s2d]
    try:
        pred.forward(x)
    finally:
        for h in hooks:
            h.remove()
    return total


def main(argv=None):
    p = argparse.ArgumentParser(description="Device-time breakdown of the "
                                            "serving forward.")
    p.add_argument("--decoder", choices=DECODERS, default=DECODERS[0])
    decoder = p.parse_args(argv).decoder
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()

    if decoder == "s2d_kernel":
        os.environ["DBSR_FINE_PATCH_S2D"] = "1"
    else:
        os.environ.pop("DBSR_FINE_PATCH_S2D", None)
    pred = load_predictor(FLAGSHIP_CHECKPOINT, batch_size=BATCH,
                          device="cuda", fused_s2d=decoder != "fine")
    x = torch.from_numpy(np.random.RandomState(0).rand(
        BATCH, 14, 48, 48, 4).astype(np.float32)).cuda()
    flops = conv_flops(pred, x)
    for _ in range(3):
        pred.forward(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(FORWARDS):
            pred.forward(x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    rows = [(e.key, kernel_us(e), e.count) for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    groups = defaultdict(float)
    for name, us, _ in rows:
        groups[kernel_group(name)] += us
    per_fwd = FORWARDS
    if busy_us == 0:
        raise SystemExit("profile_serving: the trace holds no device time")
    print(card)
    print(f"decoder {decoder}; batch {BATCH}, {per_fwd} forwards traced: wall "
          f"{wall_us / per_fwd / 1e3:.2f} ms/forward, device busy "
          f"{busy_us / per_fwd / 1e3:.2f} ms/forward "
          f"({100 * busy_us / wall_us:.1f}% of wall)")
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {us / per_fwd / 1e3:.3f} ms/forward "
              f"({100 * us / busy_us:.1f}%)")
    conv_ms = max(groups["convolution (cuDNN)"] / per_fwd / 1e3, 1e-9)
    # ^ conv math only: the layout transposes are a group of their own
    print(f"conv operations per forward {flops / 1e9:.1f} GFLOP: "
          f"{flops / conv_ms / 1e9:.2f} TFLOP/s achieved in the conv kernels; "
          f"{flops / 67e12 * 1e3:.2f} ms at the 67 TFLOP/s float32 peak")
    print("top kernels (ms/forward, launches/forward):")
    for name, us, n in rows[:15]:
        print(f"  {us / per_fwd / 1e3:8.3f}  {n / per_fwd:6.1f}  {name[:100]}")
    out = {"card": card, "decoder": decoder, "batch": BATCH,
           "forwards": per_fwd,
           "wall_ms_per_forward": wall_us / per_fwd / 1e3,
           "device_busy_ms_per_forward": busy_us / per_fwd / 1e3,
           "conv_gflop_per_forward": flops / 1e9,
           "groups_ms_per_forward": {g: us / per_fwd / 1e3
                                     for g, us in groups.items()},
           "top": [{"name": n, "ms_per_forward": us / per_fwd / 1e3,
                    "launches_per_forward": c / per_fwd}
                   for n, us, c in rows[:40]]}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
