"""The port's kernels in the traced epoch: their bounds, from each launch's
shapes, summed over their device time summed (``yardstick``)."""

from benchmark.yardstick import kernel_roofline


def read(run):
    return kernel_roofline(run.trace)
