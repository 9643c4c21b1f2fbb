"""The benchmark's plain reference of the stacked-hourglass hand-pose net
(arXiv:1711.08996; melonwan/denseReg ``model/hourglass_um_crop_tiny.py``):
the serving path (crop from boxes, center of mass, depth normalization, the
BN-folded net, the head-grid subsample, the vote decode) and the training
step (crop from the pose, augmentation, targets, the batch-renorm training
forward, the loss, gradient accumulation, the element-wise clip and Adam).

Plain PyTorch and NumPy. It imports nothing of the measured package and
nothing of JAX: the crop, decode, augmentation and target files are frozen
copies of plain code, with their imports pointed here, and the net is a
functional form written over the Flax-layout weight tree.
"""
