"""Step timing and tracing (port of ``dbsr_tpu/training/profiling.py``).

``StepTimer`` meters per-step wall time and throughput. ``maybe_trace``
records a ``torch.profiler`` trace of a few training steps, the card's
activity included where there is one, into ``$DBSR_TPU_TRACE_DIR`` as a
Chrome trace (open it in Perfetto or ``chrome://tracing``); with the
variable unset it does nothing, so production runs pay nothing. ``annotate`` names a span of
host code in such a trace.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

# the trace being recorded: the profiler allows one at a time per process
_active = []


@contextlib.contextmanager
def maybe_trace(step: int, start_step: int = 5, num_steps: int = 5):
    """Trace steps [start_step, start_step + num_steps) of a cycle to
    ``$DBSR_TPU_TRACE_DIR`` when it is set, with CUDA activity where a card
    is; the file is ``trace_steps<first>-<last>_pid<pid>_<ms>.json``. A
    trace started and not ended (a cycle shorter than the window) goes on
    into the next cycle's steps until its last step comes."""
    trace_dir = os.environ.get("DBSR_TPU_TRACE_DIR")
    if not trace_dir:
        yield
        return
    if step == start_step and not _active:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        _active.append(prof)
    try:
        yield
    finally:
        last = start_step + num_steps - 1
        if step == last and _active:
            prof = _active.pop()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                trace_dir, f"trace_steps{start_step}-{last}_pid{os.getpid()}"
                f"_{int(time.time() * 1e3)}.json"))


class StepTimer:
    """Per-step wall-time and throughput meter."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.perf_counter()
        self.last = self.t0
        self.samples = 0

    def step(self, n_samples: int):
        now = time.perf_counter()
        dt = now - self.last
        self.last = now
        self.samples += n_samples
        return {
            "step_time_s": dt,
            "fps": n_samples / dt if dt > 0 else 0.0,
            "avg_fps": self.samples / (now - self.t0),
        }


def annotate(name: str):
    """Named span in a trace: ``with annotate("synthesis"): ...``."""
    return torch.profiler.record_function(name)
