"""The banked flagship scored in bf16 by the port against the JAX package,
on the CPU, on one JAX-written SyntheticBurstVal set of the zoo's protocol
(``util_scripts/generate_synthetic_burst_val.py --procedural``: 14 frames
of 48x48, 384^2 ground truth, boundary 40, the 2^14 quantization).

* The full-width bf16 forward against JAX's bf16 forward of the same
  bursts: relative L2 within 2e-2 (``util_scripts/tpu_parity_check.py``'s
  bf16 limit).
* PSNR per burst, the port in bf16 against JAX in bf16: within 0.05 dB.

Run as a script, it measures how much of the port's float32 scores' gap to
the JAX package's bf16 ones the dtype explains: the flagship scored by JAX
at float32 and at bf16, and by the port at bf16 and at float32, per burst,
on a set of ``--bursts`` bursts:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_bf16_scores.py \
        --bursts 8

With ``--stages`` it prints :func:`bias_rounding_by_stage`'s numbers
instead (no JAX).
"""

import argparse
import contextlib
import importlib.util
import io
import json
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbsr_tpu.data.datasets import SyntheticBurstVal as JaxSyntheticBurstVal
from dbsr_tpu.evaluation import synburst as jax_synburst
from dbsr_tpu.training.checkpoint import load_network as jax_load_network
from dbsr_tpu_torch.evaluation import synburst
from dbsr_tpu_torch.evaluation.network_param import NetworkParam
from dbsr_tpu_torch.training.checkpoint import load_network

REPO = Path(__file__).resolve().parents[1]
FLAGSHIP = str(REPO / "dbsr_tpu/artifacts/campaigns/"
               "dbsr_campaign_r5_best_params.ckpt")
BOUNDARY = 40
N_BURSTS = 2
SEED = 20260817
REL_L2 = 2e-2       # util_scripts/tpu_parity_check.py:259-270, bf16
PSNR_DB = 0.05      # port bf16 vs JAX bf16, per burst


def write_val_set(root: str, n_bursts: int, seed: int = SEED) -> None:
    """The JAX package's val-set generator (its ``main``) on procedural
    sources."""
    spec = importlib.util.spec_from_file_location(
        "jax_gen_val", REPO / "util_scripts/generate_synthetic_burst_val.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv = sys.argv
    sys.argv = ["generate_synthetic_burst_val.py", "--procedural",
                str(max(2, n_bursts // 2)), "--num_bursts", str(n_bursts),
                "--seed", str(seed), "--out_dir", root]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            mod.main()
    finally:
        sys.argv = argv


def read_val_set(root: str):
    ds = JaxSyntheticBurstVal(root)
    bursts = np.stack([ds[i][0] for i in range(len(ds))]).astype(np.float32)
    gts = np.stack([ds[i][1] for i in range(len(ds))]).astype(np.float32)
    return bursts, gts


def jax_forward(bursts, dtype):
    """JAX's clipped predictions of the flagship at ``dtype`` (None:
    float32), one burst at a time."""
    net, params, _ = jax_load_network(FLAGSHIP, **(
        {} if dtype == "checkpoint" else {"dtype": dtype}))
    fwd = jax.jit(jax_synburst._forward_fn(net))
    return np.stack([np.asarray(fwd(params, jnp.asarray(b[None])))[0]
                     for b in bursts]).astype(np.float32)


def jax_psnr(preds, gts):
    score = jax.jit(jax_synburst._make_score_batch(BOUNDARY, False))
    s = score(jax_synburst.quantize(jnp.asarray(preds)), jnp.asarray(gts))
    return np.asarray(s["psnr"], np.float64)


def port_forward(bursts, dtype="checkpoint"):
    """The port's clipped predictions of the flagship on the CPU at
    ``dtype`` (``"checkpoint"``: the one it records, bf16, as the scoring
    entries load it; None: float32), one burst at a time."""
    if dtype == "checkpoint":
        net, _ = NetworkParam(checkpoint_path=FLAGSHIP).load_net(
            "", device="cpu")
    else:
        net, _ = load_network(FLAGSHIP, device="cpu", dtype=dtype)
    fwd = synburst._forward_fn(net)
    return np.stack([fwd(torch.from_numpy(b[None]))[0].numpy()
                     for b in bursts])


def port_psnr(preds, gts):
    score = synburst._make_score_batch(BOUNDARY, False)
    s = score(synburst.quantize(torch.from_numpy(preds)),
              torch.from_numpy(gts))
    return s["psnr"].double().numpy()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this module runs (the suite runs
    in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """The set, JAX's bf16 predictions and PSNRs, the port's bf16 ones."""
    root = str(tmp_path_factory.mktemp("bf16val"))
    write_val_set(root, N_BURSTS)
    bursts, gts = read_val_set(root)
    want = jax_forward(bursts, "checkpoint")
    got = port_forward(bursts)
    return dict(want=want, got=got, want_psnr=jax_psnr(want, gts),
                got_psnr=port_psnr(got, gts))


def test_flagship_bf16_forward_matches_jax_bf16(scored):
    assert scored["got"].shape == (N_BURSTS, 384, 384, 3)
    assert _rel(scored["got"], scored["want"]) <= REL_L2


def test_port_bf16_psnr_per_burst_within_limit_of_jax_bf16(scored):
    diff = np.abs(scored["got_psnr"] - scored["want_psnr"])
    assert np.isfinite(scored["got_psnr"]).all()
    assert diff.max() <= PSNR_DB, (scored["got_psnr"], scored["want_psnr"])


def bias_rounding_by_stage():
    """The flagship's bf16 forward of one random burst on the CPU, stage
    by stage, each stage from the same inputs: relative L2 of the port's
    output (the bias added to the rounded conv) to the same stage with the
    bias handed to the conv (oneDNN adds it before the rounding) and to
    the stage in float32; and how far a flow changed by ``eps`` px moves
    the float32 prediction."""
    import torch.nn.functional as F

    from dbsr_tpu_torch.models import layers

    def fused(conv, x, dtype=None):
        dt = dtype or torch.promote_types(x.dtype, conv.weight.dtype)
        bias = None if conv.bias is None else conv.bias.to(dt)
        return F.conv2d(x.to(dt).permute(0, 3, 1, 2), conv.weight.to(dt),
                        bias, conv.stride, conv.padding, conv.dilation,
                        conv.groups).permute(0, 2, 3, 1)

    def widen(x):
        if isinstance(x, torch.Tensor):
            return x.float() if x.dtype == torch.bfloat16 else x
        if isinstance(x, dict):
            return {k: widen(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(widen(v) for v in x)
        return x

    def rel(a, b):
        a = a["fused_enc"] if isinstance(a, dict) else a
        b = b["fused_enc"] if isinstance(b, dict) else b
        return _rel(a.float().numpy(), b.float().numpy())

    burst = torch.from_numpy(np.random.RandomState(0).rand(
        1, 14, 48, 48, 4).astype(np.float32))
    bf16, _ = load_network(FLAGSHIP, device="cpu")
    f32, _ = load_network(FLAGSHIP, device="cpu", dtype=None)
    stages = ("encoder.alignment_net", "encoder.embed", "merging", "decoder")
    seen = {}
    hooks = [bf16.get_submodule(s).register_forward_hook(
        lambda m, a, kw, o, s=s: seen.__setitem__(s, (a, kw, o)),
        with_kwargs=True) for s in stages]
    with torch.no_grad():
        bf16(burst)
        want = f32(burst)[0].clamp(0, 1)
    for h in hooks:
        h.remove()
    out = {}
    for s in stages:
        args, kwargs, got = seen[s]
        with torch.no_grad():
            ours = layers.conv_nhwc
            layers.conv_nhwc = fused
            try:
                one_rounding = bf16.get_submodule(s)(*args, **kwargs)
            finally:
                layers.conv_nhwc = ours
            wide = f32.get_submodule(s)(*widen(args), **widen(kwargs))
        out[s] = {"vs_bias_before_rounding": rel(one_rounding, got),
                  "vs_float32": rel(wide, got)}
    for eps in (1e-4, 1e-3, 1e-2):
        gen = torch.Generator().manual_seed(1)
        h = f32.encoder.alignment_net.register_forward_hook(
            lambda m, a, o: o + eps * torch.randn(o.shape, generator=gen))
        with torch.no_grad():
            moved = f32(burst)[0].clamp(0, 1)
        h.remove()
        out[f"flow_plus_{eps}_px"] = rel(moved, want)
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--bursts", type=int, default=8)
    p.add_argument("--json", default=None, help="also write the numbers")
    p.add_argument("--stages", action="store_true",
                   help="only bias_rounding_by_stage's numbers")
    args = p.parse_args()
    torch.set_num_threads(min(8, torch.get_num_threads()))
    if args.stages:
        print(json.dumps(bias_rounding_by_stage(), indent=1))
        return
    with tempfile.TemporaryDirectory() as root:
        write_val_set(root, args.bursts)
        bursts, gts = read_val_set(root)
    preds = {"jax_f32": jax_forward(bursts, None),
             "jax_bf16": jax_forward(bursts, "checkpoint"),
             "port_bf16": port_forward(bursts),
             "port_f32": port_forward(bursts, None)}
    psnr = {k: (jax_psnr if k.startswith("jax") else port_psnr)(v, gts)
            for k, v in preds.items()}
    out = {"bursts": args.bursts, "seed": SEED,
           "psnr_per_burst": {k: v.tolist() for k, v in psnr.items()},
           "psnr_mean": {k: float(v.mean()) for k, v in psnr.items()},
           "rel_l2": {"port_bf16_vs_jax_bf16":
                      _rel(preds["port_bf16"], preds["jax_bf16"]),
                      "jax_bf16_vs_jax_f32":
                      _rel(preds["jax_bf16"], preds["jax_f32"]),
                      "port_bf16_vs_jax_f32":
                      _rel(preds["port_bf16"], preds["jax_f32"]),
                      "port_f32_vs_jax_f32":
                      _rel(preds["port_f32"], preds["jax_f32"])}}
    d = psnr["port_bf16"] - psnr["jax_bf16"]
    out["port_bf16_minus_jax_bf16_db"] = dict(
        mean=float(d.mean()), max_abs=float(np.abs(d).max()))
    out["jax_f32_minus_jax_bf16_db"] = float(
        (psnr["jax_f32"] - psnr["jax_bf16"]).mean())
    out["port_f32_minus_jax_f32_db"] = float(
        (psnr["port_f32"] - psnr["jax_f32"]).mean())
    print(json.dumps(out, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
