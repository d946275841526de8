"""Inputs for the three-nearest-neighbour search (``three_nn``), shared by the
CPU test against the JAX package and the card tests. NumPy only, from seeds.

Each case is (unknown (B, n, 3) f32, known (B, m, 3) f32). The grid cases
place 4 x 4 x 4 grids inside rotated boxes around the seeds, as GridConv
makes its queries; the tie cases hold exact duplicate seeds and seeds at
exactly equal distances from a query; the small cases have fewer than 3
seeds, or seeds so far away that every d2 overflows to +inf, where the
plain version's passes pick index 0; the ragged cases have n that is not a
multiple of the kernel's 256 queries a block; and the NaN case has queries
with a NaN coordinate, whose d2 are all NaN (argmin takes NaN as the least
value, the first one first). The lane cases put what decides an answer in
the parts of the seeds that different lanes of a query scan (the kernel
splits them by 4-seed groups over S lanes): copies of a seed 1 to 256
indices after it, NaN queries at FP1's shape (512 x 256), and NaN seeds
spread over the groups.
"""
import numpy as np

GRID = np.stack(np.meshgrid(*[np.linspace(-1.0, 1.0, 4)] * 3, indexing="ij"), -1).reshape(64, 3)


def room_seeds(rng, b: int, m: int) -> np.ndarray:
    return np.stack([rng.uniform(-3, 3, (b, m)), rng.uniform(-3, 3, (b, m)),
                     rng.uniform(0, 2.5, (b, m))], -1)


def grids(seed: int, b: int, boxes: int, m: int, duplicates: bool = False):
    """``boxes`` boxes a scene centred near seeds, half extents 0.1-1 m,
    headings uniform; their grid points (b, boxes * 64, 3) as queries.
    ``duplicates`` copies a quarter of the seeds onto others."""
    rng = np.random.RandomState(seed)
    known = room_seeds(rng, b, m)
    if duplicates:
        src = rng.randint(0, m, (b, m // 4))
        known[:, rng.choice(m, m // 4, replace=False)] = np.take_along_axis(known, src[..., None], 1)
    center = known[:, :boxes] + rng.normal(0, 0.2, (b, boxes, 3))
    half = rng.uniform(0.1, 1.0, (b, boxes, 3))
    angle = rng.uniform(-np.pi, np.pi, (b, boxes))
    c, s = np.cos(angle), np.sin(angle)
    rot = np.zeros((b, boxes, 3, 3))
    rot[..., 0, 0], rot[..., 0, 1], rot[..., 1, 0], rot[..., 1, 1] = c, -s, s, c
    rot[..., 2, 2] = 1.0
    rel = GRID[None, None] * half[:, :, None]
    pts = np.einsum("bkgc,bkdc->bkgd", rel, rot) + center[:, :, None]
    return pts.reshape(b, boxes * 64, 3).astype(np.float32), known.astype(np.float32)


def lattice_ties(b: int):
    """Seeds on the integer lattice 0..3 (64 a scene, then shuffled) and
    queries at cell centres, edge midpoints and lattice points, in halves:
    many seeds at exactly equal d2 from a query."""
    rng = np.random.RandomState(40)
    lat = np.stack(np.meshgrid(*[np.arange(4.0)] * 3, indexing="ij"), -1).reshape(64, 3)
    known = np.stack([lat[rng.permutation(64)] for _ in range(b)])
    unknown = rng.randint(0, 7, (b, 300, 3)) * 0.5
    return unknown.astype(np.float32), known.astype(np.float32)


def small(seed: int, b: int, n: int, m: int):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-2, 2, (b, n, 3)).astype(np.float32),
            rng.uniform(-2, 2, (b, m, 3)).astype(np.float32))


def overflow(b: int):
    """Seeds near +1e20 and queries near -1e20: every d2 overflows to
    +inf, except that the second scene's queries all sit on its seed 5,
    moved to -1e20 (d2 0)."""
    rng = np.random.RandomState(41)
    known = 1e20 + rng.uniform(0, 1e19, (b, 8, 3))
    unknown = -1e20 + rng.uniform(0, 1e19, (b, 20, 3))
    known[1, 5] = unknown[1] = -1e20
    return unknown.astype(np.float32), known.astype(np.float32)


def nan_queries(b: int):
    unknown, known = small(42, b, 100, 50)
    unknown[:, ::7, 1] = np.nan
    return unknown, known


def lane_ties(b: int):
    """301 seeds (a tail after the last whole 4-seed group), each of five
    seeds copied onto the seeds 1, 2, 4, ... 256 indices after it; queries
    on and around the copied seeds, so their nearest three are copies whose
    d2 tie, scanned by different lanes for most S."""
    rng = np.random.RandomState(43)
    m = 301
    known = room_seeds(rng, b, m)
    bases = [0, 5, 30, 50, 70]
    for j in bases:
        for d in (1, 2, 4, 8, 16, 32, 64, 128, 256):
            if j + d < m:
                known[:, j + d] = known[:, j]
    near = np.repeat(known[:, bases], 24, axis=1) + rng.normal(0, 0.05, (b, 24 * len(bases), 3))
    near[:, ::6] = np.repeat(known[:, bases], 4, axis=1)  # exactly on a copy: d2 0
    return near.astype(np.float32), known.astype(np.float32)


def nan_queries_fp1(b: int):
    """FP1's shape, 512 queries among 256 seeds, every fifth query NaN."""
    unknown, known = small(44, b, 512, 256)
    unknown[:, ::5, 0] = np.nan
    return unknown, known


def nan_seeds(b: int):
    """NaN seeds in groups far apart: every query's d2 to them is NaN, so
    its first three are the first three NaN seeds."""
    unknown, known = small(45, b, 200, 130)
    known[:, [3, 7, 21, 64, 100, 129], 2] = np.nan
    return unknown, known


CASES = {
    "grid_rotated_boxes_m1024": lambda: grids(0, 2, 16, 1024),
    "grid_duplicate_seeds_m1024": lambda: grids(1, 2, 16, 1024, duplicates=True),
    "grid_queries_above_a_tile_m5000": lambda: grids(2, 2, 5, 5000),
    "lattice_ties": lambda: lattice_ties(2),
    "m1": lambda: small(3, 2, 40, 1),
    "m2": lambda: small(4, 2, 40, 2),
    "m3": lambda: small(5, 2, 40, 3),
    "ragged_n257": lambda: small(6, 3, 257, 100),
    "ragged_n300_m513": lambda: small(7, 2, 300, 513),
    "n1": lambda: small(8, 4, 1, 64),
    "overflow_to_inf": lambda: overflow(2),
    "nan_queries": lambda: nan_queries(2),
    "lane_ties_m301": lambda: lane_ties(2),
    "nan_queries_fp1": lambda: nan_queries_fp1(2),
    "nan_seeds": lambda: nan_seeds(2),
}
