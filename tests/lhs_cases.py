"""Inputs for lower-half suppression (``lhs_3d_samecls``), shared by the CPU
test against the JAX package and the card tests. NumPy only, from seeds.

Each case is (mins (B, K, 3) f32, maxs (B, K, 3) f32, scores (B, K) f32,
classes (B, K) int64, threshold). The clustered cases copy about half of
the boxes from others, jittered, so that clusters form, with some exact
duplicates; tied scores take a quarter grid. The threshold cases set
pairs of unit cubes side by side at shifts that put their IoU a few
rounding steps either side of the threshold. The special-score cases set
some scores to -inf or NaN: once every remaining box scores -inf, the
round's winner is the last box, whether it remains or not (the last
maximum of the masked scores), and a NaN score wins before any number, as
argmax takes it.
"""
import numpy as np


def clustered(seed: int, b: int, k: int, n_cls: int, ties: bool = False, thresh: float = 0.25):
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
    cls = rng.randint(0, n_cls, (b, k)).astype(np.int64)
    return ((ctr - half).astype(np.float32), (ctr + half).astype(np.float32),
            scores.astype(np.float32), cls, thresh)


def near_threshold(b: int, k: int, thresh: float):
    """k // 2 pairs of unit cubes a scene, far apart, the second of each
    pair shifted along x by d (1 + e): IoU (1 - d) / (1 + d) with d = (1 -
    t) / (1 + t), e from -1e-6 to 1e-6, so it falls just above or just
    below ``thresh``. One class; scores fall with the index, with ties
    inside some pairs."""
    d = (1.0 - thresh) / (1.0 + thresh)
    rel = np.array([-1e-6, -3e-7, -1e-7, 0.0, 1e-7, 3e-7, 1e-6, 2e-6])
    mins = np.zeros((b, k, 3))
    for s in range(b):
        for p in range(k // 2):
            base = np.array([10.0 * p, 10.0 * s, 0.0])
            mins[s, 2 * p] = base
            mins[s, 2 * p + 1] = base + [d * (1.0 + rel[(p + s) % len(rel)]), 0.0, 0.0]
    mins = mins.astype(np.float32)
    maxs = (mins + 1.0).astype(np.float32)
    scores = np.linspace(1.0, 0.1, k)[None].repeat(b, 0)
    scores[:, 1::4] = scores[:, 0::4][:, : scores[:, 1::4].shape[1]]  # ties inside pairs
    return mins, maxs, scores.astype(np.float32), np.zeros((b, k), np.int64), thresh


def special_scores(seed: int, b: int, k: int, n_cls: int, neg_inf: float, nan: float):
    """``clustered`` boxes with a share ``neg_inf`` of the scores at -inf
    and a share ``nan`` at NaN; the first scene's last box scores -inf and
    the second's is finite, so that both ways to reach the all -inf rounds
    occur."""
    mins, maxs, scores, cls, thresh = clustered(seed, b, k, n_cls)
    rng = np.random.RandomState(seed + 1000)
    u = rng.rand(b, k)
    scores = np.where(u < neg_inf, -np.inf, np.where(u > 1.0 - nan, np.nan, scores))
    scores[0, -1] = -np.inf
    scores[1, -1] = 0.5
    return mins, maxs, scores.astype(np.float32), cls, thresh


def one_cluster(seed: int, b: int, k: int):
    """k boxes of one class a scene, all within 0.05 of one center with
    sizes within 10 % of one another, so each scene is one cluster."""
    rng = np.random.RandomState(seed)
    ctr = rng.uniform(-2.0, 2.0, (b, 1, 3)) + rng.normal(0.0, 0.05, (b, k, 3))
    half = rng.uniform(0.4, 1.0, (b, 1, 3)) * rng.uniform(0.9, 1.1, (b, k, 3))
    return ((ctr - half).astype(np.float32), (ctr + half).astype(np.float32),
            rng.rand(b, k).astype(np.float32), np.zeros((b, k), np.int64), 0.25)


CASES = {
    "one_class_k16": lambda: clustered(0, 3, 16, 1),
    "many_classes_k16": lambda: clustered(1, 3, 16, 18),
    "ties_k16": lambda: clustered(2, 3, 16, 2, ties=True),
    "one_class_k64": lambda: clustered(3, 8, 64, 1),
    "few_classes_k64": lambda: clustered(4, 8, 64, 3),
    "many_classes_k64": lambda: clustered(5, 8, 64, 18),
    "ties_k64": lambda: clustered(6, 8, 64, 3, ties=True),
    "threshold_0.3_k64": lambda: clustered(7, 8, 64, 2, thresh=0.3),
    "near_threshold_0.25_k16": lambda: near_threshold(3, 16, 0.25),
    "near_threshold_0.3_k64": lambda: near_threshold(8, 64, 0.3),
    # either side of the kernel's switch from a warp a scene (K <= 64) to
    # a block a scene
    "few_classes_k32": lambda: clustered(8, 4, 32, 3),
    "few_classes_k63": lambda: clustered(9, 4, 63, 3),
    "few_classes_k65": lambda: clustered(10, 4, 65, 3),
    "one_cluster_k64": lambda: one_cluster(11, 4, 64),
    "neg_inf_scores_k64": lambda: special_scores(12, 4, 64, 2, 0.3, 0.0),
    "nan_scores_k64": lambda: special_scores(13, 4, 64, 2, 0.0, 0.2),
    "nan_and_neg_inf_scores_k64": lambda: special_scores(14, 4, 64, 2, 0.2, 0.2),
    "neg_inf_scores_k100": lambda: special_scores(15, 3, 100, 2, 0.3, 0.0),
    "nan_scores_k100": lambda: special_scores(16, 3, 100, 2, 0.0, 0.2),
}
