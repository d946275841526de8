"""Percent: the bounds of the `csrc/` kernels whose work follows from shapes over their device time in the traced section (`harness/reading.py::roofline_pct`)."""


def read(r):
    return r.roofline_pct()
