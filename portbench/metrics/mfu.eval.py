"""Percent: the model FLOPs of the window's requests over the window's time and the peak of the configuration's precision."""


def read(r):
    return r.mfu_pct()
