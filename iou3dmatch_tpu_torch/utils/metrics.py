"""Axis-aligned box IoU (host NumPy).

The port's copy of ``calc_iou`` from ``iou3dmatch_tpu/utils/metrics.py:10-27``
(reference ``utils/metric_util.py:107-131``), which
``eval/eval_det.py::get_iou`` reads.
"""
import numpy as np


def calc_iou(box_a, box_b):
    """Axis-aligned 3D IoU of two 6-dim boxes [cx, cy, cz, lx, ly, lz]."""
    box_a, box_b = np.asarray(box_a), np.asarray(box_b)
    max_a = box_a[0:3] + box_a[3:6] / 2
    max_b = box_b[0:3] + box_b[3:6] / 2
    min_max = np.array([max_a, max_b]).min(0)
    min_a = box_a[0:3] - box_a[3:6] / 2
    min_b = box_b[0:3] - box_b[3:6] / 2
    max_min = np.array([min_a, min_b]).max(0)
    if not (min_max > max_min).all():
        return 0.0
    intersection = (min_max - max_min).prod()
    vol_a = box_a[3:6].prod()
    vol_b = box_b[3:6].prod()
    union = vol_a + vol_b - intersection
    return 1.0 * intersection / union
