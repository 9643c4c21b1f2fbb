"""Visual QA: depth-map, heatmap, skeleton and candidate figures.

A copy of ``densereg_tpu/eval/visualization.py`` (numpy, with matplotlib
and cv2 imported inside the functions that draw), so that the port imports
nothing of the JAX package. The reference renders matplotlib figures into
TensorBoard image summaries (its ``data/visualization.py``); here the same
figures are saved as PNGs under the run's ``summary/`` directory, and as
image records of its event file (``utils.tb.EventWriter``).

Skeleton topology is data, not code: per-dataset joint groups (palm +
5 fingers with the reference's per-finger colors c/m/y/g/r) and bone
segments, matching the joint orderings drawn by the reference for
icvl (palm + 5x3 finger chains), nyu (5x2 fingertip pairs + palm 13 +
wrist 11/12 + thumb root 9-10) and msra (palm + 5x4 chains).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

FINGER_COLORS = ["c", "m", "y", "g", "r"]


def _skeleton_icvl():
    joints = {0: ("w", 200)}
    bones = []
    for f in range(5):
        for k in range(3):
            joints[f * 3 + 1 + k] = (FINGER_COLORS[f], 90 - 15 * k)
        bones += [(f * 3 + 1, f * 3 + 2, FINGER_COLORS[f]),
                  (f * 3 + 2, f * 3 + 3, FINGER_COLORS[f])]
    return joints, bones


def _skeleton_msra():
    joints = {0: ("w", 200)}
    bones = []
    for f in range(5):
        for k in range(4):
            joints[f * 4 + 1 + k] = (FINGER_COLORS[f], 90 - 10 * k)
        for k in range(3):
            bones.append((f * 4 + 1 + k, f * 4 + 2 + k, FINGER_COLORS[f]))
    return joints, bones


def _skeleton_nyu():
    joints: Dict[int, Tuple[str, int]] = {13: ("w", 200),
                                          11: ("b", 100), 12: ("b", 100)}
    bones = []
    for f in range(5):
        joints[f * 2] = (FINGER_COLORS[f], 60)
        joints[f * 2 + 1] = (FINGER_COLORS[f], 90)
        bones.append((f * 2, f * 2 + 1, FINGER_COLORS[f]))
        if f < 4:
            bones.append((13, f * 2 + 1, FINGER_COLORS[f]))
    bones += [(9, 10, "r"), (13, 11, "b"), (13, 12, "b"), (13, 10, "r")]
    return joints, bones


def _skeleton_bighand():
    joints = {0: ("w", 200)}
    for i in range(1, 6):
        joints[i] = ("w", 100)
    for f in range(5):
        for k in range(3):
            joints[6 + f * 3 + k] = (FINGER_COLORS[f], 60)
    return joints, []


SKELETONS = {
    "icvl": _skeleton_icvl,
    "msra": _skeleton_msra,
    "nyu": _skeleton_nyu,
    "bighand": _skeleton_bighand,
    "synthetic": _skeleton_icvl,
}


def _dataset_key(name: str) -> str:
    for key in SKELETONS:
        if name.startswith(key):
            return key
    return "icvl"


def _fig_to_array(fig) -> np.ndarray:
    canvas = getattr(fig, "canvas", None)
    if canvas is None or not hasattr(canvas, "buffer_rgba"):
        # figures built directly (matplotlib.figure.Figure) carry only a
        # base canvas; attach a rasterizing one
        from matplotlib.backends.backend_agg import FigureCanvasAgg
        canvas = FigureCanvasAgg(fig)
    canvas.draw()
    buf = np.asarray(canvas.buffer_rgba())
    return buf[..., :3].copy()


def figure_heatmap(hm: np.ndarray):
    """Jet-colored heatmap with colorbar
    (the reference's ``data/visualization.py``)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    from matplotlib.figure import Figure

    fig = Figure()
    ax = fig.add_subplot(1, 1, 1)
    im = ax.imshow(np.asarray(hm), cmap="jet")
    fig.colorbar(im)
    return fig


def figure_joint_skeleton(dm: np.ndarray, uvd: np.ndarray, dataset: str):
    """Depth map + colored joints + bone segments."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    from matplotlib.figure import Figure

    uvd = np.asarray(uvd).reshape(-1, 3)
    joints, bones = SKELETONS[_dataset_key(dataset)]()
    fig = Figure()
    ax = fig.add_subplot(1, 1, 1)
    ax.imshow(np.asarray(dm), cmap="Greys")
    for a, b, color in bones:
        if a < len(uvd) and b < len(uvd):
            ax.plot([uvd[a, 0], uvd[b, 0]], [uvd[a, 1], uvd[b, 1]],
                    color=color, linewidth=3)
    for j, (color, size) in joints.items():
        if j < len(uvd):
            ax.scatter(uvd[j, 0], uvd[j, 1], s=size, c=color)
    return fig


def figure_candidate_pairs(dm: np.ndarray, pts1, pts2):
    """Candidate/vote pair plot (cf. ``figure_smp_pts``,
    the reference's ``data/visualization.py``)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    from matplotlib.figure import Figure

    fig = Figure()
    ax = fig.add_subplot(1, 1, 1)
    ax.imshow(np.asarray(dm), cmap="jet")
    for p1, p2 in zip(np.asarray(pts1), np.asarray(pts2)):
        ax.plot([p1[0], p2[0]], [p1[1], p2[1]])
        ax.scatter(p1[0], p1[1], s=60, c="w")
        ax.scatter(p2[0], p2[1], s=60, c="m")
    return fig


def colorize_depth(dm, thresh: float = 750.0):
    """Depth map -> displayable BGR uint8 (``visDepthMap``,
    the reference's ``data/util.py``)."""
    import cv2

    dm = np.asarray(dm, np.float32).copy()
    dm[dm > thresh] = 0
    dm = dm * (255.0 / thresh)
    return cv2.cvtColor(dm.astype(np.uint8), cv2.COLOR_GRAY2BGR)


def annotate_depth(dm, uvd, thresh: float = 750.0, radius: int = 3):
    """Depth map + joint circles (``visAnnotatedDepthMap_uvd``,
    the reference's ``data/util.py``)."""
    import cv2

    img = colorize_depth(dm, thresh)
    for pt in np.asarray(uvd).reshape(-1, 3):
        cv2.circle(img, (int(pt[0]), int(pt[1])), radius, (0, 0, 255), -1)
    return img


class SummaryImageWriter:
    """Image channel for the reference's debug_level-gated TB image
    summaries (its ``model/hourglass_um_crop_tiny.py``):
    PNG files under ``summary/`` plus, when ``event_writer`` is given, the
    same figures as TensorBoard image summaries
    (:class:`densereg_torch.utils.tb.EventWriter`)."""

    def __init__(self, summary_dir: str, debug_level: int = 1,
                 event_writer=None):
        self.dir = summary_dir
        self.debug_level = debug_level
        self.events = event_writer
        os.makedirs(summary_dir, exist_ok=True)

    def save(self, tag: str, fig, step: int, level: int = 1) -> Optional[str]:
        if self.debug_level < level:
            return None
        path = os.path.join(self.dir, f"{tag.replace('/', '_')}_{step}.png")
        fig.savefig(path)
        if self.events is not None:
            self.events.add_image(tag, _fig_to_array(fig), step)
        return path

    def save_batch_skeletons(self, tag: str, dms, uvds, dataset: str,
                             step: int, level: int = 1, max_n: int = 3):
        paths = []
        for i in range(min(len(dms), max_n)):
            fig = figure_joint_skeleton(np.squeeze(dms[i]), uvds[i], dataset)
            p = self.save(f"{tag}_{i}", fig, step, level)
            if p:
                paths.append(p)
        return paths
