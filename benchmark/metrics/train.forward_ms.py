"""The card's time in the network's forward and loss a step: the device
time of the operations launched inside the trainer's ``train.forward``
spans, on the thread that opened them, over the steps traced."""

from benchmark import spans


def read(run):
    seconds, n = spans.launched_device_s(run.trace, "train.forward")
    return spans.per(seconds, n, run.counters.get("train.traced_steps"))
