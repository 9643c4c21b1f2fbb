"""Compare two reference-format result dumps (or a dump against ground
truth written in the same format), the counterpart of
``tools/compare_results.py`` over the port's ``eval.{metrics,writer}``.

Computes the per-frame mean and max 3D joint errors and the threshold
curve between the two files, frames matched by name. Numpy only: no card
is needed.

    python -m densereg_torch.tools.compare_results ours.txt theirs.txt \\
        [--curve_out curve.txt] [--max_mean_delta 0.05]

Exits 1 when ``--max_mean_delta`` is given and the mean joint error exceeds
it (the golden-parity gate: 0.05 mm).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from densereg_torch.eval.metrics import summarize_percentages
from densereg_torch.eval.writer import read_result_file, write_error_curve


def compare(path_a: str, path_b: str, strict_names: bool = True) -> dict:
    """``frames``, ``mean_joint_error_mm``, ``max_joint_error_mm`` and
    ``per_frame_max`` (each frame's largest joint error, in ``path_a``'s
    order) between two dumps. With ``strict_names`` ``path_b``'s frames are
    matched to ``path_a``'s by name, and a name of ``path_a`` missing from
    ``path_b`` raises; without it the files are compared line by line."""
    names_a, xyz_a = read_result_file(path_a)
    names_b, xyz_b = read_result_file(path_b)
    if strict_names:
        index_b = {n: i for i, n in enumerate(names_b)}
        missing = [n for n in names_a if n not in index_b]
        if missing:
            raise ValueError(f"{len(missing)} frames of {path_a} absent from "
                             f"{path_b} (first: {missing[0]!r})")
        xyz_b = xyz_b[[index_b[n] for n in names_a]]
    if xyz_a.shape != xyz_b.shape:
        raise ValueError(f"shape mismatch {xyz_a.shape} vs {xyz_b.shape}")

    d = (xyz_a - xyz_b).reshape(len(xyz_a), -1, 3)
    dist = np.linalg.norm(d, axis=-1)
    return {
        "frames": len(xyz_a),
        "mean_joint_error_mm": float(dist.mean()),
        "max_joint_error_mm": float(dist.max()),
        "per_frame_max": dist.max(axis=1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ours")
    ap.add_argument("theirs")
    ap.add_argument("--curve_out", default=None)
    ap.add_argument("--max_mean_delta", type=float, default=None,
                    help="exit nonzero when the mean joint error exceeds "
                         "this many mm (the golden-parity gate: 0.05)")
    args = ap.parse_args(argv)
    rep = compare(args.ours, args.theirs)
    print(f"frames: {rep['frames']}")
    print(f"mean 3D joint error: {rep['mean_joint_error_mm']:.4f} mm")
    print(f"max  3D joint error: {rep['max_joint_error_mm']:.4f} mm")
    print("fraction within tau:", summarize_percentages(rep["per_frame_max"]))
    if args.curve_out:
        write_error_curve(rep["per_frame_max"].tolist(), args.curve_out)
        print(f"curve -> {args.curve_out}")
    if (args.max_mean_delta is not None
            and rep["mean_joint_error_mm"] > args.max_mean_delta):
        print(f"FAIL: {rep['mean_joint_error_mm']:.4f} mm > "
              f"{args.max_mean_delta} mm gate")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
