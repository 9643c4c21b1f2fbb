"""Observability: stdout, the append-only ``training_log.txt`` and a JSONL
metric stream (a copy of ``densereg_tpu/utils/logging.py``; the log lines
keep their format, so tools that read the JAX package's logs read these).
"""

from __future__ import annotations

import json
import os
import time
from datetime import datetime


class TrainLogWriter:
    """Append-only ``training_log.txt`` in the reference's line format
    (the reference trainer, train_single_gpu.py:154-158)."""

    def __init__(self, train_dir: str, filename: str = "training_log.txt"):
        os.makedirs(train_dir, exist_ok=True)
        self.path = os.path.join(train_dir, filename)
        self._f = open(self.path, "a")

    def log_step(self, step: int, max_steps: int, loss: float,
                 sec_per_batch: float, sec_per_sample: float,
                 echo: bool = True) -> None:
        line = ("[densereg_torch/train] %s: step %d/%d, loss = %.3f, "
                "%.3f sec/batch, %.5f sec/sample"
                % (datetime.now(), step, max_steps, loss, sec_per_batch,
                   sec_per_sample))
        self._f.write(line + "\n")
        self._f.flush()
        if echo:
            print(line)

    def write(self, text: str) -> None:
        self._f.write(text + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class MetricLogger:
    """JSONL metric stream (one object per event)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._f = open(path, "a")

    def log(self, step: int, **metrics) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
