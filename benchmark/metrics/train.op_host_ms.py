"""The host's time inside the port's kernel entries a training step: the
``op.<entry>`` spans on every thread the trace recorded (checks, the
kernel's lookup, its ``ctypes`` launch), over the steps traced."""

from benchmark import spans


def read(run):
    seconds, n = spans.host_s(run.trace, spans.is_op_span)
    return spans.per(seconds, n, run.counters.get("train.traced_steps"))
