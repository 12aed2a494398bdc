"""The training step's share of the cards' bf16 peak over the window: the
model's operations a step of the node batch (``yardstick.model_flops``,
forward and backward, from the configuration's shapes) times the steps,
over the window's seconds and the cards used."""

from benchmark.yardstick import mfu, model_flops


def read(run):
    c, cfg = run.counters, run.cell.config
    steps = c.get("train.steps")
    if not steps:
        return None
    b = cfg["train_burst"]
    hw = tuple(s // b["downsample_factor"] // 2 for s in b["crop_sz"])
    flops = model_flops(cfg["net"], c["train.batch"], b["burst_size"], hw,
                        training=True)
    return mfu(flops * steps, c["train.window_s"], run.device["count"])
