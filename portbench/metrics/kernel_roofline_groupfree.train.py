"""Percent: the bounds of the `csrc/` kernels at the Group-Free-3D step's calls (`harness/shapes_groupfree.py::kernel_calls`, each kernel's bound from `kernels/`) over their device time in the traced section."""
from harness import shapes_groupfree


def read(r):
    return shapes_groupfree.roofline_pct(r, r.config, r.mix)
