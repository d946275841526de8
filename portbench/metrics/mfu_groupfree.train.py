"""Percent: the model FLOPs of the window's Group-Free-3D pretrain steps (`harness/shapes_groupfree.py::model_flops`) over the window's time outside the profiled section and the float32 peak (67 TFLOP/s)."""
from harness import shapes_groupfree


def read(r):
    return shapes_groupfree.mfu_pct(r, r.config, r.mix)
