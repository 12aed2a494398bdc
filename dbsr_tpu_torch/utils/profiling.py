"""Spans and step tracing (port of ``dbsr_tpu/training/profiling.py``).

``annotate`` names a span of host code: ``with annotate("train.forward"):``.
It is the port's one span helper, used by the trainer, the feed, the
network, the predictor, the serving daemon and the kernel entries in
``ops/``. With no profiler running it returns one shared null context
(well under a microsecond a span); under ``torch.profiler`` it is a
``record_function`` span, on the profiler's clock, so that a trace's
device work and idle gaps can be named by it.

``maybe_trace`` records a ``torch.profiler`` trace of a few training
steps, the card's activity included where there is one, into
``$DBSR_TPU_TRACE_DIR`` as a Chrome trace (open it in Perfetto or
``chrome://tracing``); with the variable unset it does nothing. It records
every thread of the process, so the spans of the prefetch worker and of
the serving daemon's threads show beside the main thread's.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()

# the trace being recorded: the profiler allows one at a time per process
_active = []


def annotate(name: str):
    """A span named ``name`` while a profiler runs (``record_function``);
    otherwise a shared null context that costs nothing to enter."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def maybe_trace(step: int, start_step: int = 5, num_steps: int = 5):
    """Trace steps [start_step, start_step + num_steps) of a cycle to
    ``$DBSR_TPU_TRACE_DIR`` when it is set, with CUDA activity where a card
    is and the host spans of every thread; the file is
    ``trace_steps<first>-<last>_pid<pid>_<ms>.json``. A trace started and
    not ended (a cycle shorter than the window) goes on into the next
    cycle's steps until its last step comes."""
    trace_dir = os.environ.get("DBSR_TPU_TRACE_DIR")
    if not trace_dir:
        yield
        return
    if step == start_step and not _active:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(
            activities=activities,
            experimental_config=torch.profiler._ExperimentalConfig(
                profile_all_threads=True))
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
