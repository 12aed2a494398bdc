"""Training entry of the port:

    python -m dbsr_tpu_torch.run_training dbsr default_synthetic \
        --set pwc_checkpoint=dbsr_tpu/artifacts/align_lite_params.ckpt

builds a ``Settings`` object (the environment's paths plus the ``--set``
overrides, values parsed as Python literals where they parse) and calls
``dbsr_tpu_torch.configs.<module>.<config>.run(settings, device)``. It
trains on the card (``--device cuda``, the default; no card raises)
unless asked for the CPU.
"""

from __future__ import annotations

import argparse
import ast
import importlib


def run_training(module: str, config: str, device="cuda", **overrides):
    from dbsr_tpu_torch import resolve_device
    from dbsr_tpu_torch.environment import Settings

    dev = resolve_device(device)
    settings = Settings()
    settings.module = module
    settings.script_name = config
    settings.project_path = f"{module}/{config}"
    for k, v in overrides.items():
        if v is not None:
            setattr(settings, k, v)
    expr = importlib.import_module(f"dbsr_tpu_torch.configs.{module}.{config}")
    return expr.run(settings, device=dev)


def main(argv=None):
    p = argparse.ArgumentParser(description="Train a network (PyTorch/CUDA "
                                            "port).")
    p.add_argument("module", help="config namespace, e.g. dbsr")
    p.add_argument("config", help="config name, e.g. default_synthetic")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   dest="overrides",
                   help="settings override, e.g. --set epochs=10")
    args = p.parse_args(argv)
    extra = {}
    for item in args.overrides:
        k, sep, v = item.partition("=")
        if not sep:
            p.error(f"--set expects K=V, got {item!r}")
        try:
            extra[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            extra[k] = v
    if args.batch_size is not None:
        extra["batch_size"] = args.batch_size
    run_training(args.module, args.config, device=args.device, **extra)


if __name__ == "__main__":
    main()
