"""The preprocessing constants of the reference (denseReg ``data/preprocess.py``)."""

D_RANGE = 300.0          # depth-normalization window (mm)
POSE_NORM_RATIO = 100.0  # xyz pose normalization divisor (mm -> units)
MAX_DIST_2D = 4.0        # heatmap cone radius (pixels)
MAX_DIST_3D = 0.8        # offset cone radius (normalized units = 80 mm)
