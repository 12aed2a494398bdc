"""Evaluation entry of the port (counterpart of the top-level
``run_evaluation.py``):

    python -m dbsr_tpu_torch.run_evaluation synburst compute_score <experiment> [opts]
    python -m dbsr_tpu_torch.run_evaluation synburst save_results <experiment> [opts]
    python -m dbsr_tpu_torch.run_evaluation synburst visualize <experiment> [opts]
    python -m dbsr_tpu_torch.run_evaluation burstsr compute_score <experiment> [opts]
    python -m dbsr_tpu_torch.run_evaluation burstsr save_results <experiment> [opts]
    python -m dbsr_tpu_torch.run_evaluation burstsr visualize <experiment> [opts]

``<experiment>`` names a module of ``dbsr_tpu_torch/evaluation/experiments``
whose ``main()`` returns the ``NetworkParam`` list. The val set is
``--dataset_root`` or the environment's ``synburstval_dir``
(``DBSR_TPU_SYNBURSTVAL_DIR``) for ``synburst``, its ``burstsr_dir``
(``DBSR_TPU_BURSTSR_DIR``, a BurstSR-format tree) for ``burstsr``; the
workspace is ``DBSR_TPU_WORKSPACE_DIR``. ``visualize`` writes PNG panels
and ``index.html`` to ``--out_dir`` (default ``<workspace>/synburst_vis``
or ``burstsr_vis``) for the first ``--max_bursts`` bursts (10 and 5 by
default). ``compute_score`` adds LPIPS given its weights
(``--lpips_weights``, else ``DBSR_TPU_LPIPS_WEIGHTS`` or the pretrained
nets' ``lpips_alex.npz``). It runs on the card (``--device cuda``, the
default; no card raises) unless asked for the CPU. Networks run at the
compute dtype their checkpoints record.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import time

_T0 = time.perf_counter()


def _load_experiment(name):
    mod = importlib.import_module(
        f"dbsr_tpu_torch.evaluation.experiments.{name}")
    return mod.main()


def main(argv=None):
    p = argparse.ArgumentParser(description="Evaluate DBSR networks "
                                            "(PyTorch/CUDA port).")
    p.add_argument("benchmark", choices=["synburst", "burstsr"])
    p.add_argument("action",
                   choices=["compute_score", "save_results", "visualize"])
    p.add_argument("experiment", help="experiment module name, "
                                      "e.g. dbsr_default")
    p.add_argument("--dataset_root", default=None)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--load_saved", action="store_true",
                   help="score saved predictions instead of running nets")
    p.add_argument("--max_bursts", type=int, default=None)
    p.add_argument("--no_lpips", action="store_true")
    p.add_argument("--lpips_weights", default=None,
                   help="path to converted lpips_alex.npz (overrides "
                        "DBSR_TPU_LPIPS_WEIGHTS / pretrained-nets dir)")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="also write compute_score results as JSON")
    p.add_argument("--all_epochs", action="store_true",
                   help="score EVERY checkpoint epoch of the experiment's "
                        "first network in one process (val set staged on "
                        "the device once; no LPIPS)")
    p.add_argument("--epochs", default=None, metavar="E1,E2,...",
                   help="with --all_epochs: score only these checkpoint "
                        "epochs (comma-separated)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.load_saved and not args.out_dir:
        p.error("--load_saved requires --out_dir (the directory the "
                "predictions were saved to with save_results)")
    if args.load_saved and args.action != "compute_score":
        p.error("--load_saved only applies to compute_score")
    if args.load_saved and args.benchmark != "synburst":
        p.error("--load_saved is only supported for the synburst benchmark "
                "(burstsr scoring needs the burst inputs for spatial-color "
                "alignment, so it always runs the networks)")
    if args.all_epochs and (args.benchmark != "synburst"
                            or args.action != "compute_score"
                            or args.load_saved):
        p.error("--all_epochs only applies to synburst compute_score on "
                "live networks")
    epochs = None
    if args.epochs is not None:
        if not args.all_epochs:
            p.error("--epochs requires --all_epochs")
        try:
            epochs = sorted({int(e) for e in args.epochs.split(",") if e})
        except ValueError:
            p.error(f"--epochs must be comma-separated integers, "
                    f"got {args.epochs!r}")
        if not epochs:
            p.error("--epochs must name at least one epoch")

    from dbsr_tpu_torch import resolve_device
    from dbsr_tpu_torch.environment import env_settings
    from dbsr_tpu_torch.evaluation import burstsr, synburst, visualize

    dev = resolve_device(args.device)
    env = env_settings()
    network_params = _load_experiment(args.experiment)
    workspace = env.workspace_dir
    print(f"[timing] process init (imports + env) "
          f"{time.perf_counter() - _T0:.1f}s", flush=True)

    scores = None
    if args.benchmark == "burstsr":
        root = args.dataset_root or env.burstsr_dir
        if args.action == "compute_score":
            scores = burstsr.compute_score(
                network_params, root, workspace_dir=workspace,
                with_lpips=not args.no_lpips,
                lpips_weights=args.lpips_weights, max_bursts=args.max_bursts,
                device=dev)
        elif args.action == "save_results":
            out = args.out_dir or os.path.join(workspace, "burstsr_results")
            burstsr.save_results(network_params, root, out,
                                 workspace_dir=workspace, device=dev)
        else:
            out = args.out_dir or os.path.join(workspace, "burstsr_vis")
            visualize.visualize_burstsr(network_params, root, out,
                                        workspace_dir=workspace,
                                        max_bursts=args.max_bursts or 5,
                                        device=dev)
    elif args.action == "compute_score" and args.all_epochs:
        root = args.dataset_root or env.synburstval_dir
        n0 = network_params[0]
        scores = synburst.compute_score_trajectory(
            n0.module, n0.parameter, root, workspace_dir=workspace,
            net_name=n0.net_name, burst_sz=n0.burst_sz,
            epochs=epochs, max_bursts=args.max_bursts, device=dev)
    elif args.action == "compute_score":
        root = args.dataset_root or env.synburstval_dir
        scores = synburst.compute_score(
            network_params, root, workspace_dir=workspace,
            saved_results_root=(args.out_dir if args.load_saved else None),
            with_lpips=not args.no_lpips, lpips_weights=args.lpips_weights,
            max_bursts=args.max_bursts, device=dev)
    elif args.action == "save_results":
        root = args.dataset_root or env.synburstval_dir
        out = args.out_dir or os.path.join(workspace, "synburst_results")
        synburst.save_results(network_params, root, out,
                              workspace_dir=workspace, device=dev)
    else:
        root = args.dataset_root or env.synburstval_dir
        out = args.out_dir or os.path.join(workspace, "synburst_vis")
        visualize.visualize_synburst(network_params, root, out,
                                     workspace_dir=workspace,
                                     max_bursts=args.max_bursts or 10,
                                     device=dev)

    if args.json and scores is not None:
        with open(args.json, "w") as f:
            json.dump(scores, f, indent=2)


if __name__ == "__main__":
    main()
