"""The card's time moving a predictor call's bursts in and answers out:
the device time of the operations launched inside the ``serve.stage_in``
(the copy to the card) and ``serve.stage_out`` (the clamp, the copy back)
spans, over the calls traced."""

from benchmark import spans


def read(run):
    s_in, n_in = spans.launched_device_s(run.trace, "serve.stage_in")
    s_out, n_out = spans.launched_device_s(run.trace, "serve.stage_out")
    return spans.per(s_in + s_out, n_in + n_out,
                     run.counters.get("serve.traced_calls"))
