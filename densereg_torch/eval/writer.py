"""Prediction and error-curve writers in the reference's text formats (a
copy of ``densereg_tpu/eval/writer.py``, which is numpy-only), so that the
comparison scripts of the field read the port's outputs as they read the
reference's.

Formats:
  * result txt: ``name\\tX.XXXX\\tY.YYYY...`` with ``/`` written as ``\\``
    in names (reference model/test_model.py:70-76);
  * error curve: ``thresh percent`` lines, percent in [0,100]
    (reference data/evaluation.py:101-103).
"""

from __future__ import annotations

import os
from typing import Iterable, Sequence

import numpy as np

from densereg_torch.eval.metrics import threshold_curve


class ResultWriter:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._f = open(path, "w")

    def write(self, name: str, xyz) -> None:
        xyz = np.asarray(xyz).reshape(-1)
        line = "%s\t%s\n" % (name, "\t".join(format(float(p), ".4f")
                                             for p in xyz))
        self._f.write(line.replace("/", "\\"))

    def write_batch(self, names: Iterable[str], xyzs) -> None:
        for name, xyz in zip(names, np.asarray(xyzs)):
            self.write(name, xyz)
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_error_curve(scores: Sequence[float], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    threshs, fracs = threshold_curve(scores)
    with open(path, "w") as f:
        for t, p in zip(threshs, fracs):
            f.write("%f %f\n" % (t, p * 100.0))


def read_result_file(path: str):
    """Parse a reference-format result dump -> (names, (n, 3j) xyz
    array)."""
    names, rows = [], []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            names.append(parts[0])
            rows.append([float(x) for x in parts[1:]])
    return names, np.asarray(rows, np.float32)
