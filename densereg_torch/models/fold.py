"""Inference-time batch-norm folding on a Flax-layout tree of numpy arrays.

Eval-mode batch renorm is an affine map in the frozen moving statistics,

    y = (conv(x) - mean) / sqrt(var + eps) * gamma + beta,

which folds exactly into the convolution: ``kernel' = kernel * s`` and
``bias' = beta - mean * s`` with ``s = gamma / sqrt(var + eps)`` per output
channel (the last axis of an HWIO kernel).
"""

from __future__ import annotations

import numpy as np


def fold_batch_norm(variables, eps: float = 1e-3):
    """``{"params", "batch_stats"}`` of a ``use_bn`` net -> ``{"params"}`` of
    the ``fold_bn`` net with the same module names."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    def fold(pnode, snode):
        out = {}
        for key, val in pnode.items():
            if not isinstance(val, dict):
                out[key] = val
            elif "conv" in val and "bn" in val:
                bn, sbn = val["bn"], snode[key]["bn"]
                var = np.asarray(sbn["var"], np.float32)
                s = np.asarray(bn["gamma"], np.float32) / np.sqrt(
                    var + np.float32(eps))
                kernel = np.asarray(val["conv"]["kernel"], np.float32) * s
                bias = (np.asarray(bn["beta"], np.float32)
                        - np.asarray(sbn["mean"], np.float32) * s)
                out[key] = {"conv": {"kernel": kernel, "bias": bias}}
            else:
                out[key] = fold(val, snode.get(key, {}))
        return out

    return {"params": fold(params, stats)}
