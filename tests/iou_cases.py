"""Box pairs for the rotated IoU's reject rule (``geometry/iou3d.py::
pairs_apart``), shared by the CPU test against the JAX package and the card
tests. NumPy only, from seeds.

Each gap case puts box B beside box A so that the extents of their corners
are ``gap`` apart along x, along y, or along a diagonal (gap / sqrt(2) on
each), or, in z, B's bottom ``gap`` above A's top. The gaps straddle the
reach of the 1e-2 containment margin: a corner of B within sqrt(2) x 1e-2
of A's corner along the diagonal is a candidate vertex although the edges
do not meet.
"""
import numpy as np

GAPS = (0.0, 5e-3, 1e-2, np.sqrt(2.0) * 1e-2, 1.5e-2, 2e-2)
DIRECTIONS = ("x", "y", "diagonal", "z")


def random_boxes(rng, n: int, rotated: bool, room: float = 3.0) -> np.ndarray:
    """(n, 7) f32 boxes with centers in [-room, room]^3 and sizes in [0.2,
    1.5]; headings uniform when ``rotated``, else 0."""
    b = np.zeros((n, 7), np.float32)
    b[:, 0:3] = rng.uniform(-room, room, (n, 3))
    b[:, 3:6] = rng.uniform(0.2, 1.5, (n, 3))
    if rotated:
        b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def _extent(box: np.ndarray):
    """The x and y extents of a box's corners, in float64."""
    c, s = np.cos(box[6]), np.sin(box[6])
    hx = np.abs(box[3] * 0.5 * c) + np.abs(box[4] * 0.5 * s)
    hy = np.abs(box[3] * 0.5 * s) + np.abs(box[4] * 0.5 * c)
    return box[0] - hx, box[0] + hx, box[1] - hy, box[1] + hy


def gap_pairs(seed: int, rotated: bool, reps: int = 2):
    """(a, b), each (N, 7) f32, and the (gap, direction) of each row: row i
    of b sits beside row i of a, every gap of GAPS along every direction of
    DIRECTIONS, ``reps`` times, with random sizes and (when ``rotated``)
    headings."""
    rng = np.random.RandomState(seed)
    a_rows, b_rows, labels = [], [], []
    for gap in GAPS:
        for d in DIRECTIONS:
            for _ in range(reps):
                a, b = random_boxes(rng, 2, rotated, room=1.0).astype(np.float64)
                b[0:3] = a[0:3]
                if d == "z":
                    b[2] = a[2] + a[5] * 0.5 + gap + b[5] * 0.5
                else:
                    step = gap / np.sqrt(2.0) if d == "diagonal" else gap
                    ax0, ax1, ay0, ay1 = _extent(a)
                    bx0, _, by0, _ = _extent(b)
                    if d in ("x", "diagonal"):
                        b[0] += ax1 + step - bx0
                    if d in ("y", "diagonal"):
                        b[1] += ay1 + step - by0
                a_rows.append(a)
                b_rows.append(b)
                labels.append((gap, d))
    return (np.asarray(a_rows, np.float32), np.asarray(b_rows, np.float32), labels)
