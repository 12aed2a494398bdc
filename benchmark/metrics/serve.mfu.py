"""The forward's share of the card's bf16 peak over the window: the model's
operations a batch (``yardstick.model_flops``, from the configuration's
shapes) times the calls, over the window's seconds."""

from benchmark.yardstick import mfu, model_flops


def read(run):
    c, cfg = run.counters, run.cell.config
    calls = c.get("serve.calls")
    if not calls:
        return None
    flops = model_flops(cfg["net"], c["serve.batch"], cfg["serve_burst_size"],
                        tuple(cfg["serve_burst_hw"]), training=False)
    return mfu(flops * calls, c["serve.window_s"], 1)
