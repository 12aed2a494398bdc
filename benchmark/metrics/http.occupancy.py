"""Bursts a device call of the serving daemon: the mean of
``MicroBatcher.batch_occupancies`` over the window."""


def read(run):
    return run.counters.get("http.occupancy")
