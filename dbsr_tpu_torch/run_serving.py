"""Serving CLI of the port: load a checkpoint into the fixed-shape
predictor, warm it up and serve burst-SR predictions over HTTP with
dynamic micro-batching (see ``dbsr_tpu_torch/serving_daemon.py`` for the
API)::

    python -m dbsr_tpu_torch.run_serving --checkpoint \
        dbsr_tpu/artifacts/campaigns/dbsr_campaign_r5_best_params.ckpt \
        [--port 8000] [--batch_size 8] [--burst_size 14] [--linger_ms 5] \
        [--f32] [--device cuda]

It serves in bf16 unless ``--f32``, on the card unless ``--device cpu``
(``cuda`` with no card raises), until interrupted. Client example::

    import io, numpy as np, urllib.request
    buf = io.BytesIO(); np.save(buf, burst)          # [14, 48, 48, 4]
    req = urllib.request.Request("http://127.0.0.1:8000/predict",
                                 data=buf.getvalue(), method="POST")
    rgb = np.load(io.BytesIO(urllib.request.urlopen(req).read()))
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Serve burst SR over HTTP "
                                             "(PyTorch/CUDA port).")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--burst_size", type=int, default=14)
    ap.add_argument("--burst_hw", default="48,48")
    ap.add_argument("--linger_ms", type=float, default=5.0)
    ap.add_argument("--f32", action="store_true",
                    help="float32 compute instead of the bf16 serving "
                         "default")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def predictor_kwargs(args: argparse.Namespace) -> dict:
    """``load_predictor``'s keyword arguments from the parsed flags."""
    return dict(batch_size=args.batch_size, burst_size=args.burst_size,
                burst_hw=tuple(int(x) for x in args.burst_hw.split(",")),
                device=args.device, dtype=None if args.f32 else "bfloat16")


def main(argv=None):
    args = parse_args(argv)

    from dbsr_tpu_torch.serving import load_predictor
    from dbsr_tpu_torch.serving_daemon import make_server

    pred = load_predictor(args.checkpoint, **predictor_kwargs(args))
    server = make_server(pred, host=args.host, port=args.port,
                         linger_ms=args.linger_ms)  # warms the predictor up
    print(f"compiled {pred.in_shape} in {pred.compile_seconds:.1f}s "
          f"({(pred.flops_per_batch or 0) / 1e9:.1f} GFLOP/batch)",
          flush=True)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(POST /predict, GET /healthz, GET /stats)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        server.batcher.close()


if __name__ == "__main__":
    main()
