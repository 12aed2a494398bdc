"""What a batch call of the predictor spends off the card: the traced
calls' wall time less the card's busy time, a call."""


def read(run):
    t, n = run.trace, run.counters.get("serve.traced_calls")
    if t is None or not n or not t.ops:
        return None
    return 1e3 * (t.window_s - t.busy_s) / n
