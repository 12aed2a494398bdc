"""Time training entries of another checkout of the port beside this one's,
on one card, in turns (old, new, new, old): AlignLite pretraining (300
steps an epoch, host-bound) and ``default_synthetic`` in bf16 with the
banked AlignLite frozen (60 steps an epoch), pools of 128, two epochs each
in a fresh process, the samples/s of each epoch from the trainer's last
print line and its wall seconds.

The other checkout is a directory holding an older ``dbsr_tpu_torch/``
(``git archive <commit> dbsr_tpu_torch | tar -x -C old``), for example the
commit before the trainer fed its loaders through the ``DevicePrefetcher``.

    python3 ab_prefetch.py --old old [--json ab_prefetch.json]

Prints the card and one JSON object as its last line: for each entry, the
runs in order, each with its tree, samples/s and wall seconds by epoch.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ALIGN_LITE = os.path.join(HERE, "dbsr_tpu/artifacts/align_lite_params.ckpt")
ENTRIES = {
    "align_lite_pretrain": ("align_lite", "pretrain_synthetic",
                            dict(steps_per_epoch=300, pool_size=128,
                                 print_interval=300)),
    "default_synthetic_bf16": ("dbsr", "default_synthetic",
                               dict(steps_per_epoch=60, pool_size=128,
                                    print_interval=60,
                                    pwc_checkpoint=ALIGN_LITE)),
}
RUN = """
import sys, time, torch
from dbsr_tpu_torch.run_training import run_training
kw = eval(sys.argv[3])
for epochs in (1, 2):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_training(sys.argv[1], sys.argv[2], epochs=epochs, **kw)
    torch.cuda.synchronize()
    print(f"EPOCH {epochs} WALL {time.perf_counter() - t0:.4f}", flush=True)
"""


def run(tree, module, config, kwargs):
    with tempfile.TemporaryDirectory() as ws:
        env = dict(os.environ, DBSR_TPU_WORKSPACE_DIR=ws,
                   DBSR_TPU_ENV=os.path.join(ws, "env.json"), PYTHONPATH=tree)
        env.pop("DBSR_TPU_ZURICHRAW2RGB_DIR", None)
        r = subprocess.run([sys.executable, "-c", RUN, module, config,
                            repr(kwargs)], cwd=tree, env=env,
                           capture_output=True, text=True, timeout=600)
    if r.returncode:
        sys.stderr.write(r.stdout[-3000:] + r.stderr[-3000:])
        raise SystemExit(f"{module} {config} failed in {tree}")
    return dict(fps=[float(v) for v in re.findall(r"FPS: ([\d.]+)", r.stdout)],
                wall=[float(v) for v in re.findall(r"WALL ([\d.]+)",
                                                   r.stdout)])


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--old", required=True,
                   help="a directory holding another dbsr_tpu_torch/")
    p.add_argument("--json", default=None)
    args = p.parse_args()
    trees = {"old": os.path.abspath(args.old), "new": HERE}
    out = {}
    for name, (module, config, kwargs) in ENTRIES.items():
        for tree in ("old", "new", "new", "old"):
            res = dict(tree=tree, **run(trees[tree], module, config, kwargs))
            print(f"{name} {tree}: samples/s by epoch {res['fps']}, wall s "
                  f"{res['wall']}", flush=True)
            out.setdefault(name, []).append(res)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
