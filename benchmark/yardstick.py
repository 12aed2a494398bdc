"""The benchmark's own arithmetic: the card's published peaks, each kernel's
bound from the shapes of its call, and the model's operations a step,
counted from the configuration's shapes. Frozen here, so that a change to
the program cannot move the yardstick.

Peaks: NVIDIA H100 SXM, dense: 989 TFLOP/s bf16, 495 TFLOP/s TF32, 67
TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM. A kernel's
bound is the larger of its bytes (each input read once, each output written
once) at the HBM rate and its operations at the rate of the arithmetic it
runs: the tensor cores' for ``conv_s2d`` (bf16 at the bf16 rate, float32 as
three TF32 products a multiply-add), float32's for the rest, which compute
in float32 whatever they load (the arithmetic of ``chip_smoke.py``'s kernel
table).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
FP32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
NUM_OFFSETS = 81

# the port's hand-written kernels, as the profiler names them
OWN_KERNELS = ("warp_kernel", "correlation_kernel", "merge_kernel",
               "resample_kernel", "dfeat_build_kernel", "csr_count_kernel",
               "csr_scan_kernel", "csr_fill_kernel", "csr_sort_kernel",
               "dfeat_gather_kernel", "dfeat_gather_scalar_kernel",
               "dflow_kernel", "merge_bwd_kernel", "merge_bwd_bf16_kernel",
               "correlation_bwd_kernel", "conv_s2d_kernel",
               "merge_bf16_kernel", "conv_s2d_bf16_kernel")


def is_own_kernel(name: str) -> bool:
    return any(k in name for k in OWN_KERNELS)


def bound_s(nbytes: float, flops: float,
            flops_per_s: float = FP32_FLOPS_PER_S) -> float:
    """The least time: bytes at the HBM rate or operations at
    ``flops_per_s``, the larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s)


def _it(t) -> int:
    return t.element_size()


def _warp(feat, flow):
    n = feat.numel()
    return bound_s(2 * n * _it(feat) + flow.numel() * 4, 7 * n)


def _warp_dfeat(flow, g):
    n = g.numel()
    return bound_s(2 * n * _it(g) + flow.numel() * 4, 8 * n)


def _warp_dflow(feat, flow, g):
    n = feat.numel()
    return bound_s(2 * n * _it(feat) + 2 * flow.numel() * 4, 20 * n)


def _correlation(first, second):
    npix = first.numel() // first.shape[-1]
    return bound_s((2 * first.numel() + npix * NUM_OFFSETS) * _it(first),
                   2 * NUM_OFFSETS * first.numel())


def _correlation_bwd(operand, g):
    return bound_s((2 * operand.numel() + g.numel()) * _it(operand),
                   2 * NUM_OFFSETS * operand.numel())


def _merge(feat, logits):
    n = feat.numel()
    return bound_s((2 * n + n // feat.shape[1]) * _it(feat), 6 * n)


def _merge_bwd(feat, logits, g):
    n = feat.numel()
    return bound_s((4 * n + g.numel()) * _it(feat), 16 * n)


def _resample(images, invs, out_hw, d, border):
    C = images.shape[-1]
    out = invs.shape[0] * invs.shape[1] * out_hw[0] * out_hw[1] * C
    return bound_s((images.numel() + invs.numel() + out) * 4,
                   out // C * (20 + 8 * C))


def _conv_s2d(x, weight):
    import torch

    O, C = weight.shape[0], weight.shape[1]
    out = x.numel() // C * O
    flops = 2 * 9 * O * x.numel()
    nbytes = (x.numel() + out) * _it(x)
    if x.dtype == torch.bfloat16:
        return bound_s(nbytes, flops, BF16_FLOPS_PER_S)
    return bound_s(nbytes, 3 * flops, TF32_FLOPS_PER_S)


# the port's kernel entries (module, function) and the bound of one call
# from its arguments
KERNEL_ENTRIES: Dict[Tuple[str, str], Callable] = {
    ("dbsr_tpu_torch.ops.warp", "warp_forward"): _warp,
    ("dbsr_tpu_torch.ops.warp", "warp_dfeat"): _warp_dfeat,
    ("dbsr_tpu_torch.ops.warp", "warp_dflow"): _warp_dflow,
    ("dbsr_tpu_torch.ops.correlation", "correlation_forward"): _correlation,
    ("dbsr_tpu_torch.ops.correlation", "correlation_dfirst"):
        _correlation_bwd,
    ("dbsr_tpu_torch.ops.correlation", "correlation_dsecond"):
        _correlation_bwd,
    ("dbsr_tpu_torch.ops.merge", "merge_forward"): _merge,
    ("dbsr_tpu_torch.ops.merge", "merge_backward"): _merge_bwd,
    ("dbsr_tpu_torch.ops.resample", "affine_resample"): _resample,
    ("dbsr_tpu_torch.ops.conv_s2d", "conv3x3_s2d_forward"): _conv_s2d,
}


@contextlib.contextmanager
def recording_bounds(out: list):
    """Within the block, every call of a kernel entry of
    :data:`KERNEL_ENTRIES` appends ``(entry, bound_s)`` to ``out``. The
    entries are wrapped wherever a loaded module holds them (a module that
    imported the function by name holds it too); an entry the program no
    longer has is skipped. Only CUDA calls count: the CPU runs the plain
    versions."""
    import sys

    patched = []
    for (mod_name, fn_name), bound in KERNEL_ENTRIES.items():
        mod = sys.modules.get(mod_name)
        fn = getattr(mod, fn_name, None) if mod is not None else None
        if fn is None:
            continue

        def wrapped(*args, _fn=fn, _bound=bound, _name=fn_name, **kw):
            if getattr(args[0], "is_cuda", False):
                out.append((_name, _bound(*args, **kw)))
            return _fn(*args, **kw)

        # the entry's own attributes (its ``launches`` counter, which it
        # increments through its module's name) stay one dict
        wrapped.__dict__ = fn.__dict__

        for m in list(sys.modules.values()):
            if m is not None and getattr(m, fn_name, None) is fn \
                    and getattr(m, "__name__", "").startswith(
                        "dbsr_tpu_torch"):
                setattr(m, fn_name, wrapped)
                patched.append((m, fn_name, fn))
    try:
        yield out
    finally:
        for m, name, fn in patched:
            setattr(m, name, fn)


# ---------------------------------------------------------------------------
# the model's operations, from the configuration's shapes

def model_flops(net_kwargs: dict, batch: int, frames: int, hw: Tuple[int, int],
                training: bool) -> float:
    """Operations (2 per multiply-add) of one forward (``training``: one
    forward and backward) of the reference ``DBSRNet`` built from
    ``net_kwargs`` on a ``[batch, frames, h, w, 4]`` burst: the sum of
    :func:`model_macs`' parts, times 2."""
    return 2.0 * sum(model_macs(net_kwargs, batch, frames, hw,
                                training).values())


def model_macs(net_kwargs: dict, batch: int, frames: int, hw: Tuple[int, int],
               training: bool) -> Dict[str, int]:
    """Multiply-adds by part, counted on the meta device from the shapes:
    ``conv`` (every conv of a ``ConvBlock`` and the pixel-shuffle
    upsampler's 1x1 conv: 1x1, dilated and strided ones), ``transposed``
    (PWC-Net's up-convs), ``blur`` (the decoder's depthwise blur),
    ``cost_volume`` (81 x C a pixel) and ``merge`` (the weighted sum, one
    an element of the features). In training a conv whose weight takes a
    gradient adds its d_weight, and one whose input carries a gradient its
    d_input, each as many as the forward; the cost volume and the merge
    add two where their input carries a gradient. The frozen aligner
    counts its forward only. Not counted: recomputation, warps,
    elementwise work."""
    import torch

    from benchmark.reference import align_lite, dbsr, pwcnet
    from benchmark.reference.dbsr import DBSRNet
    from benchmark.reference.layers import (ConvBlock, PixShuffleUpsampler,
                                            TorchConvTranspose)

    macs = {"conv": 0, "transposed": 0, "blur": 0, "cost_volume": 0,
            "merge": 0}

    def grads(t):
        return training and t.requires_grad

    def conv_hook(module, args, y):
        x = args[0]
        if isinstance(module, TorchConvTranspose):
            w = module.weight
            m = x.numel() * w.shape[1] * w.shape[2] * w.shape[3]
            macs["transposed"] += m * (1 + grads(w) + grads(x))
            return
        w = module.Conv_0.weight
        if isinstance(module, ConvBlock):
            m = y.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        else:
            m = x[..., :1].numel() * w.shape[0] * w.shape[1]
            if module.blur is not None:
                macs["blur"] += y.numel() * module.blur[0, 0].numel() \
                    * (1 + grads(x))
        macs["conv"] += m * (1 + grads(w) + grads(x))

    def cost_volume(first, second):
        macs["cost_volume"] += first.numel() * NUM_OFFSETS \
            * (1 + 2 * grads(first))
        return first.new_empty(first.shape[:-1] + (NUM_OFFSETS,))

    def merge(feat, logits):
        macs["merge"] += feat.numel() * (1 + 2 * grads(feat))
        return (feat[:, 0] * 0 + logits[:, 0] * 0).float()

    def warp(feat, flow):
        return feat * 1.0 + flow.sum() * 0

    with torch.device("meta"):
        net = DBSRNet(**net_kwargs)
    hooks = [m.register_forward_hook(conv_hook) for m in net.modules()
             if isinstance(m, (ConvBlock, PixShuffleUpsampler,
                               TorchConvTranspose))]
    saved = [(align_lite, "cost_volume"), (pwcnet, "cost_volume"),
             (dbsr, "fused_softmax_merge"), (dbsr, "warp_feat")]
    originals = [getattr(m, n) for m, n in saved]
    for (m, n), fn in zip(saved, (cost_volume, cost_volume, merge, warp)):
        setattr(m, n, fn)
    try:
        x = torch.empty((batch, frames) + tuple(hw) + (4,), device="meta")
        with torch.set_grad_enabled(training):
            net(x)
    finally:
        for (m, n), fn in zip(saved, originals):
            setattr(m, n, fn)
        for h in hooks:
            h.remove()
    return macs


# ---------------------------------------------------------------------------
# readings of a traced window, shared by the metric readers

def idle_share(trace) -> Optional[float]:
    """The share of the traced window, in %, with nothing on the device."""
    if trace is None or trace.window_s <= 0 or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def kernel_roofline(trace) -> Optional[float]:
    """The port's kernels' bounds summed over the launches the trace saw,
    over their device time summed, in %."""
    if trace is None or not trace.launches:
        return None
    spent = trace.device_s(is_own_kernel)
    if spent <= 0:
        return None
    return 100.0 * sum(b for _, b in trace.launches) / spent


def mfu(flops: float, seconds: float, cards: int) -> Optional[float]:
    """``flops`` done in ``seconds`` over the cards' bf16 peak, in %."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * flops / seconds / (cards * BF16_FLOPS_PER_S)
