"""Time the warp's d_flow kernel built from other ``warp_bwd.cu`` sources
beside the checkout's, on one card, in turns (old, new, new, old; with
several, each once in the order given, the checkout's, then the reverse).

Another source is usually an older commit's, written out with ``git show
<commit>:dbsr_tpu_torch/kernels/csrc/warp_bwd.cu > old.cu``; each is built
with the checkout's ``common.cuh`` and flags into a temporary directory and
its ``dbsr_warp_dflow_{f32,bf16}`` entries are called through ``ctypes``.
The shapes are those ``chip_smoke.py`` times d_flow at: the train step's
three (B=16, N=8: the encoder's warp and AlignLite's two backwarps) and
PWC-Net's four backwarps, in float32 and bf16. First the checkout's kernel
is held against its plain version at every lane width of its dispatch
(``chip_smoke.dflow_lane_rows``), then every kernel at each timed shape;
each time is ``chip_smoke.device_ms``'s median device time of a call.

    python3 ab_dflow.py --old old.cu [--old other.cu ..]
        [--json ab_dflow.json]

Prints one JSON object as its last line: the card, each row's times (two
for each source, by its file's stem, and for ``new``, the checkout's) and
bound, and their means summed over the train step's shapes and over
PWC-Net's.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke as cs
from dbsr_tpu_torch import kernels
from dbsr_tpu_torch.ops.warp import warp_dflow, warp_dflow_plain

TRAIN_SHAPES = ((cs.TRAIN_FRAMES, 48, 48, 512), (cs.TRAIN_FRAMES, 24, 24, 48),
                (cs.TRAIN_FRAMES, 48, 48, 24))


def build_old(src, out_dir):
    """``src`` built as ``kernels.build`` builds a source; its library."""
    lib = Path(out_dir) / f"lib{Path(src).stem}.so"
    proc = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o",
         str(lib), str(src)], capture_output=True, text=True)
    for line in proc.stdout.splitlines() + proc.stderr.splitlines():
        if any(w in line for w in ("dflow", "registers", "spill", "error")):
            cs.log(f"  {Path(src).stem}: {line.strip()}")
    if proc.returncode:
        raise RuntimeError(f"nvcc rc {proc.returncode}: {proc.stderr}")
    return ctypes.CDLL(str(lib))


def old_entry(lib, dtype):
    """The other source's d_flow for ``dtype`` as a function of (feat,
    flow, g), launched as ``ops.warp.warp_dflow`` launches the checkout's."""
    fn = getattr(lib, kernels.entry("warp_dflow", "dbsr_warp_dflow", dtype))
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(feat, flow, g):
        out = torch.empty_like(flow)
        err = fn(feat.data_ptr(), flow.data_ptr(), g.data_ptr(),
                 out.data_ptr(), *feat.shape,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old d_flow: CUDA error {err}")
        return out
    return call


def profiled_ms(fn):
    """``chip_smoke.device_ms`` of ``fn``, taken again once where the
    profiler saw fewer calls than were made."""
    try:
        return cs.device_ms(fn, cs.KERNEL_NAMES["warp_dflow"])[0]
    except AssertionError as e:
        cs.log(f"  profiled again: {str(e)[:120]}")
        return cs.device_ms(fn, cs.KERNEL_NAMES["warp_dflow"])[0]


def check(name, fn, feat, flow, g):
    """``fn`` against the plain version: float32 by ``check_close`` after
    ``check_repeat``, bf16 by ``check_dflow_bf16``."""
    plain = lambda: warp_dflow_plain(feat, flow, g)  # noqa: E731
    if feat.dtype == torch.float32:
        cs.check_close(name, cs.check_repeat(name, lambda: fn(feat, flow, g)),
                       plain())
    else:
        cs.check_dflow_bf16(name, lambda: fn(feat, flow, g), plain,
                            cs.dflow_terms(feat, flow, g))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, action="append",
                    help="another warp_bwd.cu (may be given again)")
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        cs.log("ab_dflow: no CUDA card")
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    cs.log(card)
    cs.log(f"new built in {kernels.build(['warp_bwd']):.1f} s")
    for line in kernels.build_log("warp_bwd").splitlines():
        if "registers" in line or "spill" in line:
            cs.log(f"  new: {line.strip()}")
    g = torch.Generator(device=dev)
    g.manual_seed(16)
    for dtype in (torch.float32, torch.bfloat16):
        cs.dflow_lane_rows(dev, g, dtype)
    labels = [Path(p).stem for p in args.old] + ["new"]
    order = labels + labels[::-1]
    with tempfile.TemporaryDirectory() as tmp:
        libs = [build_old(p, tmp) for p in args.old]
        rows = []
        for dtype in (torch.float32, torch.bfloat16):
            fns = dict(zip(labels, [old_entry(lib, dtype) for lib in libs]
                           + [warp_dflow]))
            shapes = [(s, "train") for s in TRAIN_SHAPES] + [
                ((cs.TRAIN_FRAMES, s, s, c), "pwc")
                for s, c in cs.PWC_LEVELS[1:]]
            for s, path in shapes:
                feat = torch.randn(*s, generator=g, device=dev).to(dtype)
                gout = torch.randn(*s, generator=g, device=dev).to(dtype)
                if path == "train":
                    fl = torch.rand(*s[:3], 2, generator=g, device=dev) \
                        * 10 - 5
                    fl[:, ::5] = torch.round(fl[:, ::5])
                    fl = fl.contiguous()
                else:
                    fl = (cs._pwc_flow(g, dev, s[0], s[1])
                          * (s[1] / (s[1] - 1.0))).contiguous()
                name = f"d_flow {str(dtype)[6:]} {list(s)}"
                for who, fn in fns.items():
                    check(f"{name} {who}", fn, feat, fl, gout)
                turns = {who: [] for who in labels}
                for who in order:
                    turns[who].append(profiled_ms(
                        lambda: fns[who](feat, fl, gout)))
                n, nf = feat.numel(), fl.numel()
                bms, by = cs.bound(n * 2 * feat.element_size() + 2 * nf * 4,
                                   20 * n)
                row = dict(dtype=str(dtype)[6:], shape=list(s), path=path,
                           ms=turns, bound_ms=bms, bound_by=by)
                cs.log(f"  {name}: bound {bms:.4f} ms; " + "; ".join(
                    f"{who} {sum(t) / 2:.4f} ({t[0]:.4f}, {t[1]:.4f})"
                    for who, t in turns.items()))
                rows.append(row)
                del feat, gout, fl
    sums = {}
    for dtype in ("float32", "bfloat16"):
        for path in ("train", "pwc"):
            part = [r for r in rows
                    if r["dtype"] == dtype and r["path"] == path]
            sums[f"{dtype}_{path}"] = dict(
                {who: sum(sum(r["ms"][who]) / 2 for r in part)
                 for who in labels},
                bound_ms=sum(r["bound_ms"] for r in part))
    out = dict(card=card, rows=rows, sums=sums)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    cs.log(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
