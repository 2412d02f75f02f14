"""Metric logging: console + JSONL always, TensorBoard when available
(counterpart of street_gaussians_ns_tpu/utils/writer.py, the same
`metrics.jsonl` rows).

The JSONL stream is the machine-readable source of truth; TensorBoard is a
mirror through torch's SummaryWriter where the tensorboard package is
installed.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict


class MetricsWriter:
    def __init__(self, run_dir: Path, use_tensorboard: bool = True):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.run_dir / "metrics.jsonl", "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=str(self.run_dir / "tb"))
            except ImportError:          # no tensorboard package
                self._tb = None
        self._t0 = time.time()

    def write(self, step: int, metrics: Dict[str, float],
              prefix: str = "train"):
        row = {"step": step, "wall_s": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                row[f"{prefix}/{k}"] = float(v)
            except (TypeError, ValueError):
                continue
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in row.items():
                if k not in ("step", "wall_s"):
                    self._tb.add_scalar(k, v, step)

    def log(self, msg: str):
        print(f"[{time.time() - self._t0:8.1f}s] {msg}", flush=True)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
