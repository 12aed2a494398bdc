"""The time a training step waited on the trainer's prefetch queue
(``Trainer.feed[...]["wait_s"]`` summed over the window's epochs), a step;
it holds the pool's render at each epoch's start."""


def read(run):
    steps = run.counters.get("train.steps")
    if not steps:
        return None
    return 1e3 * run.counters["train.feed_wait_s"] / steps
