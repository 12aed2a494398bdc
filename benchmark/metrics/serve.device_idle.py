"""The share of the traced calls' window with nothing on the card."""

from benchmark.yardstick import idle_share


def read(run):
    return idle_share(run.trace)
