"""The host's time launching a predictor call's forward: the wall time
inside the ``serve.forward`` spans, over the calls traced (the forward
returns once its work is queued, so this is the host's side of it)."""

from benchmark import spans


def read(run):
    seconds, n = spans.host_s(run.trace, lambda name: name == "serve.forward")
    return spans.per(seconds, n, run.counters.get("serve.traced_calls"))
