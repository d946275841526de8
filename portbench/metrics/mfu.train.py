"""Percent: the model FLOPs of the window's steps (`harness/shapes.py::model_flops`) over the window's time and the peak of the configuration's precision (67 TFLOP/s in float32)."""


def read(r):
    return r.mfu_pct()
