"""Run one cell of ``BENCHMARK.json`` once, on the card(s) of this machine.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's traffic file names its load (``benchmark/loads/<load>.py``),
which sets the program up from the seed, measures for ``--seconds`` and
checks what the timed path produced against the plain reference. With
``--trace 0`` the last line of standard output carries the cell's
end-to-end metrics; with ``--trace 1`` a profiler traces part of the
window and the line carries the per-layer metrics, each read by
``benchmark/metrics/<metric>.py``, and the trace's breakdown. The numbers
compared for ``correct`` are printed with their limits as the last lines
of standard error and under ``checks`` in the result line.

Exits non-zero, printing no result, without the cards the cell asks for,
when the manifest or a file it names is missing, or when a module of JAX
or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()
WALL_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    from benchmark import harness

    try:
        cell = harness.find_cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"benchmark: {type(e).__name__}: {e}", file=sys.stderr)
        return 2

    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"benchmark: cell {cell.name} needs {cell.chips} CUDA "
              f"device(s); this machine has {cards}", file=sys.stderr)
        return 3

    tmp = harness.scratch_dir(cell.name)
    harness.env_for_program(tmp)
    ctx = harness.Context(cell, args.seed, args.seconds, bool(args.trace),
                          T_START, WALL_START, tmp)
    load = harness.load_generator(cell.traffic["load"])
    try:
        run = load.run(ctx)
    except Exception:
        traceback.print_exc()
        print(f"benchmark: cell {cell.name} failed", file=sys.stderr)
        return 1
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)

    found = harness.forbidden_loaded()
    if found:
        print("benchmark: modules of JAX or the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 4

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = harness.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = value
    else:
        metrics = {m["name"]: run.metrics[m["name"]] for m in cell.end_to_end
                   if m["name"] in run.metrics}
    for note in run.errors:
        print(f"benchmark: not correct: {note}", file=sys.stderr)
    for name, (value, limit) in run.checks.items():
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(harness.result_line(run, args.trace, metrics, units)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
