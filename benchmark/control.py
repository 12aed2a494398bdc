"""The readings that set a cell's limits, on the card at the cell's own size:
the control (the reference computed in float8 e4m3 in the program's place,
``oracle.fp8_round``) and, for a training cell, the faults that the
comparison has to catch, each against the float32 reference. The
benchmark's own runs do not run this; the program's own readings come from
the cell's runs (``python3 -m benchmark.run``), which print them.

    python3 -m benchmark.control --workload <name> --seeds <n> [<n> ...]

Prints one JSON line a seed. For a training cell: ``control`` (the
reference in float8) and ``half_batch`` (the loss over the first half of
each batch, the mean taken over the rest), each with the numbers of the
first three steps, and ``stale_pool`` (a last epoch, the ``--epoch``-th,
trained on the first epoch's pool and batches: ``pool_gap`` and
``batch_gap``). A state left unchanged reads 1 on ``change_gap`` by
construction and needs no run. For a serving cell: ``control``, the widest
relative L2 distance over the sampled bursts.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import harness, inputs, oracle

CONTROL_BURSTS = 24  # bursts a serving seed compares, the HTTP cell's sample


def training_readings(cell: harness.Cell, seed: int, device,
                      epoch: int) -> dict:
    cfg, tr = cell.config, cell.traffic
    B, steps = tr["batch_size"], tr["check_steps"]
    ref = oracle.train_reference(cfg, seed, B, device, steps=steps)
    out = {"control": oracle.compare_train(oracle.train_reference(
        cfg, seed, B, device, steps=steps, quant=oracle.fp8_round), ref),
        "half_batch": oracle.compare_train(oracle.train_reference(
            cfg, seed, B, device, steps=steps, rows=B // 2), ref)}
    pool, [(burst, gt)] = oracle.epoch_inputs(cfg, seed, B, 1, device)
    out["stale_pool"] = oracle.compare_epoch(
        {"epoch": epoch, "pool": pool, "burst": burst, "frame_gt": gt},
        cfg, seed, B, device)
    return out


def serving_readings(cell: harness.Cell, seed: int, device,
                     bursts: int) -> dict:
    cfg = cell.config
    b = inputs.serving_bursts(seed, bursts, cfg["serve_burst_size"], device)
    ckpt = harness.repo_path(cfg["serve_checkpoint"])
    ref = oracle.serve_reference(ckpt, b, device)
    ctl = oracle.serve_reference(ckpt, b, device, quant=oracle.fp8_round)
    return {"control": {"worst_rel_l2": max(
        oracle.rel_l2(c.numpy(), r.numpy()) for c, r in zip(ctl, ref))}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--epoch", type=int, default=9,
                   help="the last epoch of a training window (default 9)")
    args = p.parse_args(argv)
    cell = harness.find_cell(args.workload)
    dev = torch.device("cuda")
    print(harness.card_line(), file=sys.stderr)
    for seed in args.seeds:
        if cell.traffic["load"] == "train":
            rec = training_readings(cell, seed, dev, args.epoch)
        else:
            rec = serving_readings(cell, seed, dev, CONTROL_BURSTS)
        print(json.dumps({"workload": cell.name, "seed": seed, **rec}),
              flush=True)
        harness.free_device()
    return 0


if __name__ == "__main__":
    sys.exit(main())
