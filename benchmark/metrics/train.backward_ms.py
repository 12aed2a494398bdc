"""The card's time in the backward a step: the device time of the
operations launched while a ``train.backward`` span was open, from its
thread or from autograd's device thread (never from the prefetch worker),
over the steps traced; the all-reduce after ``backward()`` is inside the
span."""

from benchmark import spans


def read(run):
    seconds, n = spans.launched_device_s(run.trace, "train.backward",
                                         autograd=True)
    return spans.per(seconds, n, run.counters.get("train.traced_steps"))
