"""The card's time in burst synthesis a step: the device time of what the
trainer's ``prepare_fn`` launched (a ``record_function`` span put around
it from outside in the traced epoch), over the steps traced."""

from benchmark.loads.train import PREPARE_LABEL


def read(run):
    if run.trace is None:
        return None
    seconds, spans = run.trace.labelled_device_s(PREPARE_LABEL)
    if not spans or seconds <= 0:
        return None
    return 1e3 * seconds / spans
