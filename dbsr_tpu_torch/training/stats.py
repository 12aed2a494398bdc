"""Running statistics (port of ``dbsr_tpu/training/stats.py``)."""

from __future__ import annotations

from typing import Dict


class AverageMeter:
    """Running average of a scalar stat with per-epoch average history."""

    def __init__(self):
        self.history = []
        self.clear()

    def clear(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    def new_epoch(self):
        """Archive the finished epoch's average and reset the meter."""
        if self.count:
            self.history.append(self.avg)
        self.clear()


class StatsDict(dict):
    """name -> AverageMeter with convenience update from a scalar dict."""

    def update_from(self, scalars: Dict[str, float], n: int = 1):
        for k, v in scalars.items():
            if k not in self:
                self[k] = AverageMeter()
            self[k].update(float(v), n)

    def averages(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.items()}

    def new_epoch(self):
        for m in self.values():
            m.new_epoch()
