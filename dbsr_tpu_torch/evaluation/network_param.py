"""Declarative spec of a network under evaluation (port of
``dbsr_tpu/evaluation/network_param.py``): a net named by (module, config,
epoch) within the workspace, by a checkpoint path, or by a directory of
saved predictions, with an optional ``burst_sz`` (fewer frames). A net is
rebuilt at the compute dtype its checkpoint records, as the JAX package
scores (bfloat16 for the banked models).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional


@dataclass
class NetworkParam:
    module: Optional[str] = None
    parameter: Optional[str] = None
    epoch: Optional[int] = None
    checkpoint_path: Optional[str] = None
    saved_results_path: Optional[str] = None
    burst_sz: Optional[int] = None
    display_name: Optional[str] = None
    net_name: str = "dbsr_synthetic"

    def get_display_name(self) -> str:
        if self.display_name:
            return self.display_name
        if self.saved_results_path:
            return os.path.basename(self.saved_results_path.rstrip("/"))
        if self.checkpoint_path:
            base = os.path.basename(self.checkpoint_path)
        else:
            base = f"{self.module}_{self.parameter}"
            if self.epoch is not None:
                base += f"_ep{self.epoch:04d}"
        if self.burst_sz is not None:
            base += f"_bsz{self.burst_sz:02d}"
        return base

    def get_unique_name(self) -> str:
        return self.get_display_name()

    def resolve_checkpoint(self, workspace_dir: str) -> str:
        from dbsr_tpu_torch.training.checkpoint import resolve_checkpoint

        if self.checkpoint_path:
            return self.checkpoint_path
        d = os.path.join(workspace_dir, self.module, self.parameter)
        path = resolve_checkpoint(d, self.net_name, self.epoch)
        if path is None:
            raise FileNotFoundError(
                f"no checkpoint for {self.module}/{self.parameter} in {d}")
        return path

    def load_net(self, workspace_dir: str, device="cuda"):
        """``(net, header)`` rebuilt from the resolved checkpoint on
        ``device``, at the dtype the checkpoint records; a network the
        port cannot build raises."""
        from dbsr_tpu_torch.training.checkpoint import load_network

        return load_network(self.resolve_checkpoint(workspace_dir),
                            device=device)
