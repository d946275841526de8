"""Inputs for greedy NMS (``nms_boxes``, ``nms_masked``), shared by the CPU
tests against the JAX package and the card tests. NumPy only, from seeds.

Each case is a dict: mins, maxs (B, K, 3) f32 camera-frame bounds, scores
(B, K) f32, cls (B, K) int64, valid (B, K) bool or None, thresh, and boxes
(B, K, 7) f32 [center, size, heading] for the matrix-mode functions
(``nms_rotated``, ``nms_normal``), whose bounds the box modes read as they
are (the heading only turns the rotated IoU's boxes).

- ``clustered``: about half the boxes copied from others, jittered, some
  exact duplicates, a few classes, so that clusters form;
- ``one_class``: every box of one class, in a few tight clusters;
- ``apart``: boxes far from one another: every box is kept;
- ``near_threshold``: pairs of unit cubes whose IoU lies within 1e-6
  (relative shift) of the threshold, either side;
- ``tied``: scores on a quarter grid, so many are equal;
- ``special``: some scores -inf and some NaN;
- ``invalid``: a third of the boxes outside ``valid``, one scene with a
  single valid box and one with none;
- ``exact_threshold``: overlaps exactly at the threshold, and 2^-20 either
  side of it;
- ``negative_thresh``: class-aware boxes at a threshold below 0, where a
  pair of two classes suppresses too (0 > thresh) unless its overlap is
  NaN: the one setting where the kernel computes every pair of that mode;
- K = 1, 128 (serving's proposals), 256, 257 (one box past four 64-bit
  words), 512 and 1,024 (the most the cluster path takes: the bit matrix in
  one block's shared memory), each a ``--num_target``;
- ``LARGE``: K = 1,025 to 4,096, past the cluster path, where the kernel
  keeps the bit matrix in device memory: ``--cluster_sampling vote_fps
  --vote_factor 2`` gives 2,048 votes to sample proposals from, and the
  CPU and the JAX package take any K.
"""
import numpy as np


def _pack(ctr, half, scores, cls, valid=None, thresh=0.25, heading=None):
    b, k = scores.shape
    heading = np.zeros((b, k)) if heading is None else heading
    boxes = np.concatenate([ctr, 2 * half, heading[..., None]], -1).astype(np.float32)
    return {"mins": (ctr - half).astype(np.float32), "maxs": (ctr + half).astype(np.float32),
            "scores": scores.astype(np.float32), "cls": cls.astype(np.int64),
            "valid": valid, "thresh": thresh, "boxes": boxes}


def clustered(seed, b, k, n_cls, ties=False, thresh=0.25):
    rng = np.random.RandomState(seed)
    ctr = rng.uniform(-2.0, 2.0, (b, k, 3))
    src = rng.randint(0, k, (b, k))
    copy = rng.rand(b, k) < 0.5
    exact = rng.rand(b, k) < 0.3
    jitter = np.where(exact[..., None], 0.0, rng.normal(0.0, 0.15, (b, k, 3)))
    ctr = np.where(copy[..., None], np.take_along_axis(ctr, src[..., None], 1) + jitter, ctr)
    half = rng.uniform(0.2, 1.0, (b, k, 3))
    half = np.where((copy & exact)[..., None], np.take_along_axis(half, src[..., None], 1), half)
    scores = rng.rand(b, k)
    if ties:
        scores = np.round(scores * 4) / 4
    cls = rng.randint(0, n_cls, (b, k))
    heading = rng.uniform(-np.pi, np.pi, (b, k))
    return _pack(ctr, half, scores, cls, thresh=thresh, heading=heading)


def one_class(seed, b, k):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-2.0, 2.0, (b, 4, 3))
    ctr = centers[np.arange(b)[:, None], rng.randint(0, 4, (b, k))] + rng.normal(0, 0.1, (b, k, 3))
    half = rng.uniform(0.4, 0.8, (b, 1, 3)) * rng.uniform(0.9, 1.1, (b, k, 3))
    return _pack(ctr, half, rng.rand(b, k), np.zeros((b, k), np.int64),
                 heading=rng.uniform(-0.3, 0.3, (b, k)))


def apart(seed, b, k):
    rng = np.random.RandomState(seed)
    ctr = np.zeros((b, k, 3))
    ctr[..., 0] = np.arange(k) * 5.0
    ctr[..., 1] = rng.uniform(-1, 1, (b, k))
    half = rng.uniform(0.2, 1.0, (b, k, 3))
    return _pack(ctr, half, rng.rand(b, k), rng.randint(0, 3, (b, k)))


def near_threshold(b, k, thresh=0.25):
    """k // 2 pairs of unit cubes a scene, far apart, the second of each
    pair shifted along x by d (1 + e): IoU (1 - d) / (1 + d) with d = (1 -
    t) / (1 + t), e from -1e-6 to 2e-6, so it falls just above or just
    below ``thresh``. One class; scores fall with the index."""
    d = (1.0 - thresh) / (1.0 + thresh)
    rel = np.array([-1e-6, -3e-7, -1e-7, 0.0, 1e-7, 3e-7, 1e-6, 2e-6])
    ctr = np.zeros((b, k, 3))
    for s in range(b):
        for p in range(k // 2):
            base = np.array([10.0 * p, 10.0 * s, 0.0])
            ctr[s, 2 * p] = base
            ctr[s, 2 * p + 1] = base + [d * (1.0 + rel[(p + s) % len(rel)]), 0.0, 0.0]
    scores = np.linspace(1.0, 0.1, k)[None].repeat(b, 0)
    return _pack(ctr + 0.5, np.full((b, k, 3), 0.5), scores, np.zeros((b, k), np.int64),
                 thresh=thresh)


def special(seed, b, k, neg_inf=0.15, nan=0.1):
    """``clustered`` boxes with a share of the scores at -inf and one at
    NaN; the first scene's last box scores -inf, the second's NaN."""
    case = clustered(seed, b, k, 2)
    rng = np.random.RandomState(seed + 1000)
    u = rng.rand(b, k)
    scores = case["scores"].astype(np.float64)
    scores = np.where(u < neg_inf, -np.inf, np.where(u > 1.0 - nan, np.nan, scores))
    scores[0, -1] = -np.inf
    if b > 1:
        scores[1, -1] = np.nan
    case["scores"] = scores.astype(np.float32)
    return case


def exact_threshold(b, thresh=0.25):
    """Pairs of boxes 2.5 x 1 x 1 overlapping by 1 along x, whose IoU 1 / (2.5
    + 2.5 - 1) is exactly 0.25 in float32 and float64, and pairs moved 2^-20
    apart either way: where a class-aware overlap meets the threshold exactly
    and the kernel must divide. One class; scores fall with the index."""
    shifts = [0.0, 2.0 ** -20, -(2.0 ** -20), 0.0]
    ctr, half = [], []
    for s in range(b):
        rows_c, rows_h = [], []
        for p, dx in enumerate(shifts):
            base = np.array([10.0 * p, 10.0 * s, 0.0])
            rows_c += [base + [1.25, 0.5, 0.5], base + [2.75 + dx, 0.5, 0.5]]
            rows_h += [[1.25, 0.5, 0.5]] * 2
        ctr.append(rows_c)
        half.append(rows_h)
    k = 2 * len(shifts)
    scores = np.linspace(1.0, 0.1, k)[None].repeat(b, 0)
    return _pack(np.array(ctr), np.array(half), scores, np.zeros((b, k), np.int64), thresh=thresh)


def invalid(seed, b, k):
    case = clustered(seed, b, k, 3)
    rng = np.random.RandomState(seed + 2000)
    valid = rng.rand(b, k) > 0.33
    valid[1] = False
    valid[1, k // 2] = True  # one valid box
    valid[2] = False  # none
    case["valid"] = valid
    return case


def all_neg_inf(seed, b, k):
    """Every score -inf but a few: the rounds reach an all -inf remainder,
    where ``_nms_jax``'s masked argmax picks the first box."""
    case = clustered(seed, b, k, 2)
    scores = np.full((b, k), -np.inf)
    scores[:, 1:4] = [0.9, 0.5, 0.7]
    case["scores"] = scores.astype(np.float32)
    return case


CASES = {
    "clustered_k128": lambda: clustered(1, 4, 128, 4),
    "clustered_k256": lambda: clustered(2, 2, 256, 6),
    "clustered_k37": lambda: clustered(3, 3, 37, 2),
    "one_class_k128": lambda: one_class(4, 3, 128),
    "apart_k64": lambda: apart(5, 2, 64),
    "near_threshold_k64": lambda: near_threshold(3, 64),
    "near_threshold_0.3_k40": lambda: near_threshold(2, 40, 0.3),
    "tied_k128": lambda: clustered(6, 4, 128, 3, ties=True),
    "tied_k256": lambda: clustered(7, 2, 256, 2, ties=True),
    "special_k128": lambda: special(8, 3, 128),
    "special_k33": lambda: special(9, 2, 33),
    "all_neg_inf_k20": lambda: all_neg_inf(10, 2, 20),
    "invalid_k128": lambda: invalid(11, 4, 128),
    "k1": lambda: clustered(12, 3, 1, 2),
    "clustered_k257": lambda: clustered(13, 2, 257, 18),
    "clustered_k512": lambda: clustered(14, 2, 512, 18),
    "clustered_k1024": lambda: clustered(15, 2, 1024, 18),
    "one_class_k1024": lambda: one_class(16, 1, 1024),
    "tied_k512": lambda: clustered(17, 2, 512, 4, ties=True),
    "special_k1024": lambda: special(18, 2, 1024),
    "all_neg_inf_k257": lambda: all_neg_inf(19, 2, 257),
    "invalid_k512": lambda: invalid(20, 3, 512),
    "exact_threshold_k8": lambda: exact_threshold(2),
    "negative_thresh_k64": lambda: clustered(21, 2, 64, 3, thresh=-0.1),
    "k2_same_box": lambda: _pack(np.zeros((1, 2, 3)), np.full((1, 2, 3), 0.5), np.array([[0.3, 0.7]]),
                                 np.zeros((1, 2), np.int64)),
}


# past the cluster path's 1,024 boxes: a few scenes each, the (K, K) overlaps
# of the plain versions being the largest temporaries
LARGE = {
    "clustered_k1025": lambda: clustered(22, 1, 1025, 18),
    "clustered_k2048": lambda: clustered(23, 2, 2048, 18),
    "special_k2048": lambda: special(24, 2, 2048),
    "invalid_k1500": lambda: invalid(25, 3, 1500),
    "all_neg_inf_k1100": lambda: all_neg_inf(26, 1, 1100),
    "tied_k2048": lambda: clustered(27, 1, 2048, 4, ties=True),
    "negative_thresh_k1100": lambda: clustered(29, 1, 1100, 3, thresh=-0.1),
    "clustered_k4096": lambda: clustered(28, 1, 4096, 18),
}


def has_ties(case) -> bool:
    """Whether two valid boxes of a scene score the same (NaN counts as one
    value): where the JAX package's unstable ``np.argsort`` leaves the pick
    order open."""
    valid = case["valid"]
    for s, row in enumerate(case["scores"]):
        row = row if valid is None else row[valid[s]]
        if len(np.unique(row)) < len(row):
            return True
    return False
