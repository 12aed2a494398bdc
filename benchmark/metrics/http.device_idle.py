"""The share of the traced slice of the window with nothing on the card,
while the daemon serves the open loop."""

from benchmark.yardstick import idle_share


def read(run):
    return idle_share(run.trace)
