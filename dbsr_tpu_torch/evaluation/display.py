"""Fixed-width text report of per-network metric means (port of
``dbsr_tpu/evaluation/display.py``; the same characters)."""

from __future__ import annotations

from typing import Dict, List


def generate_formatted_report(names: List[str],
                              scores: Dict[str, Dict[str, float]],
                              table_name: str = "") -> str:
    """``scores`` maps metric name -> {network display name -> mean}."""
    metrics = list(scores.keys())
    name_w = max([len(n) for n in names] + [len(table_name), 7]) + 2
    col_ws = [max(len(m), 8) + 2 for m in metrics]

    lines = []
    header = f"{table_name:<{name_w}}" + "".join(
        f"{m:<{w}}" for m, w in zip(metrics, col_ws))
    lines.append(header)
    lines.append("-" * len(header))
    for n in names:
        row = f"{n:<{name_w}}"
        for m, w in zip(metrics, col_ws):
            v = scores[m].get(n)
            row += f"{v:<{w}.4f}" if v is not None else " " * w
        lines.append(row)
    return "\n".join(lines)
