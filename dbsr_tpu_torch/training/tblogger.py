"""TensorBoard logging (port of ``dbsr_tpu/training/tblogger.py``).

One ``SummaryWriter`` per loader name under ``directory``: epoch-level
scalars and a one-time run-info text record. Where
``torch.utils.tensorboard`` does not import (no ``tensorboard`` package)
the writer is a no-op: ``available`` is False and nothing is written.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable


class TensorboardWriter:
    def __init__(self, directory: str, loader_names: Iterable[str]):
        self.directory = directory
        self.writers = {}
        try:  # here, not at import: it pulls in TensorFlow where present
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            SummaryWriter = None
        self.available = SummaryWriter is not None
        if self.available:
            for name in loader_names:
                self.writers[name] = SummaryWriter(
                    os.path.join(directory, name))
        self._info_written = False

    def write_info(self, script_name: str, description: str):
        if not self.writers or self._info_written:
            return
        w = next(iter(self.writers.values()))
        w.add_text("script_name", script_name)
        w.add_text("description", description)
        self._info_written = True

    def write_epoch(self, loader_name: str, scalars: Dict[str, float],
                    epoch: int):
        w = self.writers.get(loader_name)
        if w is None:
            return
        for k, v in scalars.items():
            w.add_scalar(k, v, epoch)
        w.flush()

    def close(self):
        for w in self.writers.values():
            w.close()
