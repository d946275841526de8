"""Point-cloud helpers of the datasets and the host-side eval path (NumPy).

The port's copy of the functions it needs from
``iou3dmatch_tpu/data/pc_util.py`` (reference ``utils/pc_util.py``).
"""
import numpy as np


def random_sampling(pc, num_sample, replace=None, return_choices=False, rng=None):
    """pc: (N, C) -> (num_sample, C), drawn with replacement only when the
    cloud holds fewer than ``num_sample`` points (JAX ``pc_util.py:12-20``,
    utils/pc_util.py:35-43)."""
    if replace is None:
        replace = pc.shape[0] < num_sample
    rng = rng if rng is not None else np.random
    choices = rng.choice(pc.shape[0], num_sample, replace=replace)
    if return_choices:
        return pc[choices], choices
    return pc[choices]


def rotz(t):
    """Rotation about the z-axis (JAX ``pc_util.py:23-25``)."""
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def roty(t):
    """Rotation about the y-axis (JAX ``pc_util.py:28-31``, utils/pc_util.py:287-293)."""
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def bbox_corner_dist_measure(crnr1, crnr2):
    """Corner-distance similarity in [0, 1] of two boxes given as (8, 3)
    camera-frame corners, the least over the 4 cyclic corner alignments
    (JAX ``pc_util.py:183-197``, utils/pc_util.py:323-344 without its
    debug print)."""
    dist = min(
        np.linalg.norm(
            crnr2[[(x + y) % 4 for x in range(4)]
                  + [4 + (x + y) % 4 for x in range(4)], :] - crnr1,
            axis=1,
        ).sum() / 8.0
        for y in range(4)
    )
    u = sum(np.linalg.norm(x[0, :] - x[6, :]) for x in (crnr1, crnr2)) / 2.0
    return max(1.0 - dist / u, 0)
