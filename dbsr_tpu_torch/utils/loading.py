"""Network loading by workspace, project and epoch (port of
``dbsr_tpu/utils/loading.py``)."""

from __future__ import annotations

import os
from typing import Optional, Tuple

from dbsr_tpu_torch.environment import env_settings
from dbsr_tpu_torch.training.checkpoint import load_network, resolve_checkpoint


def load_trained_network(module: str, name: str,
                         net_name: Optional[str] = None,
                         epoch: Optional[int] = None,
                         workspace_dir: Optional[str] = None,
                         device="cuda") -> Tuple:
    """Load e.g. ``load_trained_network('dbsr', 'default_synthetic')``: the
    checkpoint of ``<workspace>/<module>/<name>`` (the latest, or that of
    ``epoch``), its network rebuilt on ``device``. ``net_name`` defaults to
    the first of ``dbsr_synthetic``, ``dbsr_realworld``, ``smoke`` and
    ``dbsr`` with a checkpoint there.

    Returns ``(net, header)``, as the port's ``load_network`` does (the
    JAX package returns ``(net, params, header)``: here the parameters
    are in ``net``)."""
    ws = workspace_dir or env_settings().workspace_dir
    d = os.path.join(ws, module, name)
    if net_name is None:
        for cand in ("dbsr_synthetic", "dbsr_realworld", "smoke", "dbsr"):
            if resolve_checkpoint(d, cand) is not None:
                net_name = cand
                break
        else:
            raise FileNotFoundError(f"no checkpoints under {d}")
    path = resolve_checkpoint(d, net_name, epoch)
    if path is None:
        raise FileNotFoundError(f"no checkpoint for {net_name} under {d}")
    return load_network(path, device=device)
