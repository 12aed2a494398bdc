"""Model-zoo eval spec: the params-only campaign checkpoints banked under
``dbsr_tpu/artifacts/campaigns/`` (data the port reads; no workspace, no
training):

    python -m dbsr_tpu_torch.run_evaluation synburst compute_score \
        dbsr_zoo --no_lpips

against a val set made by ``python -m
dbsr_tpu_torch.generate_synthetic_burst_val --procedural 150 --num_bursts
300 --seed 20260817``. The port rebuilds each network at the bf16 its
checkpoint records, as the JAX package scores it, ``dbsr_campaign_r3d``
with its PWC-Net aligner and s2d decoder, the two others with AlignLite.
"""

import glob
import os

from dbsr_tpu_torch.evaluation.network_param import NetworkParam

_ART = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                    os.pardir, os.pardir, "dbsr_tpu", "artifacts",
                    "campaigns")


def main():
    nets = []
    for path in sorted(glob.glob(os.path.join(_ART, "*_best_params.ckpt"))):
        label = os.path.basename(path).replace("_best_params.ckpt", "")
        nets.append(NetworkParam(checkpoint_path=os.path.abspath(path),
                                 display_name=label))
    if not nets:
        raise FileNotFoundError(f"no *_best_params.ckpt artifacts in {_ART}")
    return nets
