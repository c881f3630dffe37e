"""Training curves (counterpart of `rt1_tpu/utils/curves.py`).

The JAX package parses clu's TensorBoard event files and plots a PNG with
matplotlib. The port's trainer writes `<train_dir>/metrics.jsonl` (one JSON
object per log or eval step, `trainer/metrics.py`), which
`read_scalar_curves` parses; the machine with the card has no matplotlib,
so `write_loss_curves` writes the series as JSON instead of a plot.
"""

from __future__ import annotations

import json
import os


def read_scalar_curves(train_dir: str, tags=("loss", "eval_loss")) -> dict:
    """Scalar series from `<train_dir>/metrics.jsonl`:
    {tag: [(step, value), ...] sorted by step}; empty lists without it."""
    curves = {tag: [] for tag in tags}
    path = os.path.join(train_dir, "metrics.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                record = json.loads(line)
                for tag in curves:
                    if tag in record:
                        curves[tag].append((int(record["step"]), float(record[tag])))
    return {k: sorted(v) for k, v in curves.items()}


def write_loss_curves(curves: dict, path: str, title: str = "training loss") -> str:
    """Write `read_scalar_curves`' output as JSON (`{"title", "curves":
    {tag: [[step, value], ...]}}`) to `path` (tmp + rename); returns it."""
    with open(path + ".tmp", "w") as f:
        json.dump({"title": title, "curves": {k: [list(p) for p in v] for k, v in curves.items()}},
                  f, indent=2)
    os.replace(path + ".tmp", path)
    return path
