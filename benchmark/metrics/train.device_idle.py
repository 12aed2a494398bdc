"""The share of the traced epoch with nothing on the card (rank 0's card
under data parallelism)."""

from benchmark.yardstick import idle_share


def read(run):
    return idle_share(run.trace)
