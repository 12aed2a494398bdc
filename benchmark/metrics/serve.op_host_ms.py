"""The host's time inside the port's kernel entries a predictor call: the
``op.<entry>`` spans (checks, the kernel's lookup, its ``ctypes``
launch), over the calls traced."""

from benchmark import spans


def read(run):
    seconds, n = spans.host_s(run.trace, spans.is_op_span)
    return spans.per(seconds, n, run.counters.get("serve.traced_calls"))
