"""The card's time in the optimizer a step: the device time of the
operations launched inside the trainer's ``train.optimizer`` spans
(``zero_grad`` and Adam's update), over the steps traced."""

from benchmark import spans


def read(run):
    seconds, n = spans.launched_device_s(run.trace, "train.optimizer")
    return spans.per(seconds, n, run.counters.get("train.traced_steps"))
