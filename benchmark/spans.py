"""Readings of the program's own spans (``utils/profiling.annotate``) in a
traced window (``harness.Trace``): the host time inside spans, and the
device time of the operations launched while a span was open.

A span is recorded on the thread that opened it. A launch is counted
under a span when its thread opened the span and it was launched inside
it (``Trace.labelled_device_s``'s rule), or, with ``autograd=True``, when
it came from autograd's device thread while the span was open on any
thread: the backward's operations launch there, not on the thread that
called ``backward()``. Autograd's thread is told by its host events
(``autograd::engine::evaluate_function: <node>``), so no other thread,
such as the prefetch worker, is counted with it. A reading of spans that
the trace does not hold is None, never 0.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

AUTOGRAD_EVENT = "autograd::engine::evaluate_function"


def _by_thread(trace, match) -> Dict[int, List[Tuple[int, int]]]:
    """The host spans whose name ``match``es, as ``thread -> [(start,
    end)]``."""
    out: Dict[int, List[Tuple[int, int]]] = {}
    for name, s, e, tid in trace.host:
        if match(name):
            out.setdefault(tid, []).append((s, e))
    return out


def _merged(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Spans in order of start, overlapping ones merged."""
    out: List[List[int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class _Cover:
    """Merged spans, asked whether a time falls inside one."""

    def __init__(self, spans: List[Tuple[int, int]]):
        self.spans = _merged(spans)
        self.starts = [s for s, _ in self.spans]

    def __contains__(self, t: int) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.spans[i][1]


def host_s(trace, match) -> Tuple[float, int]:
    """``(seconds, spans)``: the host time inside the spans whose name
    ``match``es, on every thread the trace recorded (overlapping spans of
    one thread counted once), and their number."""
    if trace is None:
        return 0.0, 0
    spans = _by_thread(trace, match)
    ns = sum(e - s for v in spans.values() for s, e in _merged(v))
    return ns / 1e9, sum(len(v) for v in spans.values())


def autograd_threads(trace) -> set:
    """The threads whose host events include autograd's evaluation of a
    backward function (named ``<AUTOGRAD_EVENT>: <node>``)."""
    return {tid for name, _, _, tid in trace.host
            if name.startswith(AUTOGRAD_EVENT)}


def launched_device_s(trace, label: str,
                      autograd: bool = False) -> Tuple[float, int]:
    """``(seconds, spans)``: the device time of the operations launched
    under the spans named ``label`` (the module's rule), and the number of
    such spans."""
    if trace is None:
        return 0.0, 0
    spans = _by_thread(trace, lambda n: n == label)
    if not spans:
        return 0.0, 0
    own = {tid: _Cover(v) for tid, v in spans.items()}
    extra = autograd_threads(trace) if autograd else set()
    anywhere = _Cover([x for v in spans.values() for x in v])
    total = 0
    for _, s, e, tid, t_launch in trace.ops:
        if tid is None:
            continue
        if (tid in own and t_launch in own[tid]) or (
                tid in extra and t_launch in anywhere):
            total += e - s
    return total / 1e9, sum(len(v) for v in spans.values())


def per(seconds: float, spans: int, count) -> Optional[float]:
    """Milliseconds over ``count`` (steps or calls); None where no span was
    found, nothing was measured, or there is nothing to divide by."""
    if not spans or seconds <= 0 or not count:
        return None
    return 1e3 * seconds / count


def is_op_span(name: str) -> bool:
    """A kernel entry's span: ``op.<entry>``."""
    return name.startswith("op.")
