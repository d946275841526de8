"""The rotated 3D IoU (``csrc/iou3d.cu``) of the IoU labels. Its work
depends on which box pairs overlap, so it has no bound from shapes; its
time counts among the hand kernels'."""
PATTERN = r"\biou3d_kernel\b"
bound_s = None
