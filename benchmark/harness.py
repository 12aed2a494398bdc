"""What every cell shares: the manifest and the files it names, the run's
record, the device it ran on, the check that nothing of JAX was loaded,
the profiler trace reduced to busy time, idle gaps and labelled device
time, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``) and has its limits in
``limits/<cell>.json``; the mix names its load generator (``"load"``:
``loads/<load>.py``), and each per-layer metric is read by
``metrics/<metric>.py``. Nothing here knows a cell by name.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"
# module top-level names that no process of a run may load: JAX and the
# JAX package (whole names: the port's ``dbsr_tpu_torch`` is not one)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "dbsr_tpu")


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _read_json(root: Path, kind: str, name: str) -> dict:
    with open(root / kind / f"{name}.json") as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of the manifest with its files read: ``config`` and
    ``traffic`` are the JSON objects of ``configs/<config>.json`` and
    ``traffic/<traffic>.json``, ``limits`` of ``limits/<cell>.json`` (each
    number that decides ``correct`` with its limit); ``end_to_end`` and
    ``per_layer`` the manifest's metrics that this cell reports."""
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, manifest: Optional[dict] = None,
              root: Path = ROOT) -> Cell:
    """The cell ``name`` of the manifest (``root``'s ``BENCHMARK.json``
    unless given), its files read from under ``root``; KeyError if the
    manifest has no such cell."""
    manifest = manifest or load_manifest(root / "BENCHMARK.json")
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{sorted(work)})")
    w = work[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg_file = root / configs[w["config"]]["file"]
    with open(cfg_file) as f:
        config = json.load(f)
    e2e = [m for m in manifest["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if _reports(m, name) and m["moves"] in e2e_names]
    here = root / "benchmark"
    return Cell(name, int(w["chips"]), w["config"], config, w["traffic"],
                _read_json(here, "traffic", w["traffic"]),
                _read_json(here, "limits", name), e2e, layer)


def load_generator(load: str):
    """The load module ``loads/<load>.py``."""
    return importlib.import_module(f"benchmark.loads.{load}")


def metric_reader(name: str) -> Callable:
    """``read(run)`` of ``metrics/<name>.py`` (a metric's name may hold
    dots, so the file is loaded by its path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded(modules=None) -> List[str]:
    """Loaded modules whose top-level name, compared whole, is one of
    :data:`FORBIDDEN_MODULES`."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})


@dataclass
class Run:
    """What a load hands back: the end-to-end numbers it took by the host's
    clock, the counters its layers gave, the traced window (``--trace 1``),
    the comparisons that decide ``correct`` (name -> (value, limit), the
    value has to be at most the limit) and the device it ran on."""
    metrics: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, Any] = field(default_factory=dict)
    trace: Optional["Trace"] = None
    checks: Dict[str, tuple] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    device: Dict[str, Any] = field(default_factory=dict)
    errors: List[str] = field(default_factory=list)
    cell: Optional[Cell] = None

    def correct(self) -> bool:
        return (not self.errors and bool(self.checks)
                and all(v == v and v <= lim
                        for v, lim in self.checks.values()))


def device_info(count: int, device: str = "cuda") -> Dict[str, Any]:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the cards."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


# ---------------------------------------------------------------------------
# the traced window

_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                 "cudaMemcpyAsync", "cudaMemsetAsync")


class Trace:
    """A profiler window on the card, reduced: the device's operations
    (kernels, copies, fills) of device ``device_index`` as ``(name,
    start_ns, end_ns, thread, launch_ns)`` (the host thread that launched
    each and when, where the trace links it; else None), the host's spans
    (``record_function``) and operators as ``(name, start_ns, end_ns,
    thread)``, the window's length, and the launches that the harness's
    wrappers recorded meanwhile (``launches``: ``(entry, bound_s)``)."""

    def __init__(self, device_index: int = 0):
        self.device_index = device_index
        self.ops: List[tuple] = []
        self.host: List[tuple] = []
        self.window_s = 0.0
        self.launches: List[tuple] = []
        self._prof = None
        self._t0 = 0.0

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._reduce(self._prof.profiler.kineto_results.events())
        self._prof = None
        return False

    def _reduce(self, events) -> None:
        from torch.autograd import DeviceType

        launch = {}
        for e in events:
            if e.device_type() == DeviceType.CPU:
                name = e.name()
                if name in _LAUNCH_CALLS:
                    launch[e.correlation_id()] = (e.start_thread_id(),
                                                  e.start_ns())
                else:
                    self.host.append((name, e.start_ns(), e.end_ns(),
                                      e.start_thread_id()))
        for e in events:
            if e.device_type() != DeviceType.CUDA or e.is_user_annotation() \
                    or e.device_index() != self.device_index:
                continue
            tid, t_launch = launch.get(e.correlation_id(), (None, None))
            self.ops.append((e.name(), e.start_ns(), e.end_ns(), tid,
                             t_launch))
        self.ops.sort(key=lambda o: o[1])
        self.host.sort(key=lambda h: h[1])

    def busy_intervals(self) -> List[tuple]:
        """The union of the device operations' intervals, in order."""
        out: List[list] = []
        for _, s, e, _, _ in self.ops:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(i) for i in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_s(self, match: Callable[[str], bool]) -> float:
        """Seconds of the device operations whose name ``match``es."""
        return sum(e - s for n, s, e, _, _ in self.ops if match(n)) / 1e9

    def labelled_device_s(self, label: str) -> tuple:
        """``(seconds, spans)``: the device time of the operations that a
        host thread launched inside a ``record_function(label)`` span of
        that thread, and the number of such spans."""
        spans = [(s, e, t) for n, s, e, t in self.host if n == label]
        if not spans:
            return 0.0, 0
        by_thread: Dict[int, List[tuple]] = {}
        for s, e, t in spans:
            by_thread.setdefault(t, []).append((s, e))
        total = 0
        for _, s, e, tid, t_launch in self.ops:
            if tid is None:
                continue
            for a, b in by_thread.get(tid, ()):
                if a <= t_launch <= b:
                    total += e - s
                    break
        return total / 1e9, len(spans)

    def top_ops(self, n: int = 10) -> List[list]:
        """The ``n`` device operations that took the most time, by name,
        in seconds."""
        tot: Dict[str, int] = {}
        for name, s, e, _, _ in self.ops:
            tot[name] = tot.get(name, 0) + (e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest stretches with nothing on the device, each
        named by what the host was doing at its middle: the innermost host
        span or operator then open (``host idle`` where none was)."""
        busy = self.busy_intervals()
        gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])]
        gaps = sorted(gaps, reverse=True)[:n]
        out = []
        for length, a, b in gaps:
            mid = (a + b) // 2
            open_ = [(e - s, name) for name, s, e, _ in self.host
                     if s <= mid <= e]
            what = min(open_)[1] if open_ else "host idle"
            out.append([what[:160], length / 1e9])
        return out


def result_line(run: Run, trace_flag: int, metrics: Dict[str, float],
                units: Dict[str, str]) -> dict:
    """The last line of standard output."""
    out = {"correct": run.correct(), "attempted": int(run.attempted),
           "failed": int(run.failed),
           "metrics": {k: {"value": v, "unit": units[k]}
                       for k, v in metrics.items()},
           "device": dict(run.device)}
    if trace_flag and run.trace is not None:
        out["device"]["busy_s"] = run.trace.busy_s
        out["device"]["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return out


def scratch_dir(name: str) -> Path:
    """A directory of this run under ``TMPDIR`` (the run's own)."""
    import tempfile

    return Path(tempfile.mkdtemp(prefix=f"bench-{name}-"))


def env_for_program(tmp: Path) -> None:
    """The environment the program runs in: no trace directory of its own
    (``maybe_trace`` would open a second profiler), no staged Zurich data,
    its workspace and settings file under this run's scratch directory,
    the kernel caches of Triton and PyTorch extensions inside the checkout,
    and no JAX from ``transformers``."""
    for k in ("DBSR_TPU_TRACE_DIR", "DBSR_TPU_ZURICHRAW2RGB_DIR",
              "DBSR_TPU_DIST"):
        os.environ.pop(k, None)
    os.environ["DBSR_TPU_ENV"] = str(tmp / "env.json")
    os.environ["DBSR_TPU_WORKSPACE_DIR"] = str(tmp / "workspace")
    os.environ["DBSR_TPU_TENSORBOARD_DIR"] = str(tmp / "tensorboard")
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".bench_cache" /
                                                   "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / ".bench_cache" / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


@dataclass
class Context:
    """What a load is given: the cell, the run's arguments, the process's
    start on the host's clock (``time.perf_counter`` and ``time.time``)
    and a scratch directory under ``TMPDIR``."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    t_start: float
    wall_start: float
    tmp: Path
    device: str = "cuda"  # "cpu" in the CPU tests, at tiny sizes

    def setup_s(self) -> float:
        return time.perf_counter() - self.t_start


def sync(device: str = "cuda") -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def repo_path(path: str) -> str:
    """A path of the repository (a configuration names the banked
    checkpoints so) as an absolute one."""
    return str(ROOT / path)


def free_device() -> None:
    """Return the program's freed memory to the card before the reference
    runs."""
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
