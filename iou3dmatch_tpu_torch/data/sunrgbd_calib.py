"""Points inside a box, for the host-side eval path (NumPy, scipy).

The port's copy of ``in_hull`` and ``extract_pc_in_box3d`` from
``iou3dmatch_tpu/data/sunrgbd_calib.py:160-172`` (reference
``sunrgbd/sunrgbd_utils.py:215-224``): a point is inside when scipy's
Delaunay triangulation of the box's 8 corners finds a simplex for it.
"""


def in_hull(p, hull):
    """(N, 3) points inside the convex hull of (M, 3) points, or of a given
    ``scipy.spatial.Delaunay``."""
    from scipy.spatial import Delaunay

    if not isinstance(hull, Delaunay):
        hull = Delaunay(hull)
    return hull.find_simplex(p) >= 0


def extract_pc_in_box3d(pc, box3d):
    """pc (N, C), box3d (8, 3) -> (the points inside, their bool mask)."""
    inds = in_hull(pc[:, 0:3], box3d)
    return pc[inds, :], inds
