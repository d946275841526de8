"""The port's three-nearest-neighbour search against the JAX package.

``three_nn_plain`` (the plain PyTorch version that ``csrc/three_nn.cu`` is
held to on the card) against JAX's ``three_nn(exact=True)`` on every case of
``tests/three_nn_cases.py``: indices equal, distances within atol 1e-6,
rtol 0 (the two sum d2 in their own orders; NaN and inf where the other
has them). Then a NumPy model of the kernel's split scan (``split_three_nn``:
each of S lanes inserts its 4-seed groups in index order on keys
fmaxf(d2, -1), the lists merge by xor distances 1, 2, ... S / 2 on the key
and the index) against the plain version, bit for bit, on every case and S. Then the wrapper's CPU route, and GridConv and an FP module on
inputs with ties against their flax counterparts, with the weights carried
across by ``train/torch_import.py`` (``tests/test_torch_models.py``'s tiny
model, atol 1e-4 as there).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from iou3dmatch_tpu_torch.ops import _build  # noqa: E402
from iou3dmatch_tpu_torch.ops.interpolate import three_nn, three_nn_plain  # noqa: E402
from tests.test_torch_models import pair  # noqa: E402,F401  (the tiny model pair fixture)
from tests.three_nn_cases import CASES, grids  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_nn_plain_matches_jax(case):
    from iou3dmatch_tpu.ops.interpolate import three_nn as jax_three_nn

    unknown, known = CASES[case]()
    jd, ji = jax_three_nn(jnp.asarray(unknown), jnp.asarray(known), True)
    d, i = three_nn_plain(torch.from_numpy(unknown), torch.from_numpy(known))
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    assert d.shape == i.shape == unknown.shape
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    assert int(i.min()) >= 0 and int(i.max()) < known.shape[1]


TILE = 1024  # seeds csrc/three_nn.cu stages at a time: kTile


def lane_orders(m: int, lanes: int) -> list:
    """The seed indices each of a query's lanes scans, in its order: in
    each tile of TILE seeds, the 4-seed groups g with g % lanes == lane,
    then, in lane 0, the 0-3 seeds after the tile's last whole group."""
    orders = [[] for _ in range(lanes)]
    for t0 in range(0, m, TILE):
        cnt = min(TILE, m - t0)
        groups = cnt // 4
        for g in range(groups):
            orders[g % lanes].extend(range(t0 + 4 * g, t0 + 4 * g + 4))
        orders[0].extend(range(t0 + 4 * groups, t0 + cnt))
    return orders


def _sq_dist(u, k):
    dx, dy, dz = (u[..., c] - k[..., c] for c in range(3))
    return dx * dx + dy * dy + dz * dz


def _key_before(d, i, e, j):
    """The merge's order: the key, then the lower index."""
    return (d < e) | ((d == e) & (i < j))


def _lane_insert(kk, ii, d, j, valid):
    """csrc/three_nn.cu insert() on every lane, scene and query at once: the
    key fmaxf(d2, -1) (a NaN d2 is -1, before every number) enters strictly
    before a held key."""
    k = np.where(valid, np.fmax(d, np.float32(-1)), np.float32(np.inf))
    c0, c1, c2 = (k < kk[..., s] for s in range(3))
    i0, i1, i2 = ii[..., 0].copy(), ii[..., 1].copy(), ii[..., 2].copy()
    ii[..., 2] = np.where(c1, i1, np.where(c2, j, i2))
    ii[..., 1] = np.where(c0, i0, np.where(c1, j, i1))
    ii[..., 0] = np.where(c0, j, i0)
    k0, k1, k2 = kk[..., 0].copy(), kk[..., 1].copy(), kk[..., 2].copy()
    kk[..., 2] = np.minimum(k2, np.maximum(k1, k))
    kk[..., 1] = np.minimum(k1, np.maximum(k0, k))
    kk[..., 0] = np.minimum(k0, k)


def _merge(dd, ii, ee, jj):
    """csrc/three_nn.cu merge(): the half-cleaner against the partner's
    list reversed, then 3 compare-exchanges."""
    d = [None] * 3
    i = [None] * 3
    for s in range(3):
        take = _key_before(ee[..., 2 - s], jj[..., 2 - s], dd[..., s], ii[..., s])
        d[s] = np.where(take, ee[..., 2 - s], dd[..., s])
        i[s] = np.where(take, jj[..., 2 - s], ii[..., s])
    for a, b in ((0, 1), (1, 2), (0, 1)):
        swap = _key_before(d[b], i[b], d[a], i[a])
        d[a], d[b] = np.where(swap, d[b], d[a]), np.where(swap, d[a], d[b])
        i[a], i[b] = np.where(swap, i[b], i[a]), np.where(swap, i[a], i[b])
    return np.stack(d, -1), np.stack(i, -1)


def split_three_nn(unknown: np.ndarray, known: np.ndarray, lanes: int):
    """The kernel's answer with ``lanes`` lanes a query, in float32: every
    lane scans its seeds (``lane_orders``) with its own top 3 keys, slots
    from (+inf, 0), then the lists merge by xor distances 1, 2, ... lanes /
    2, as __shfl_xor_sync pairs them; every lane must end with the same
    list. Returns (dist, idx) as the kernel writes them."""
    b, n, _ = unknown.shape
    orders = lane_orders(known.shape[1], lanes)
    steps = max(len(o) for o in orders)
    seq = np.full((lanes, steps), -1)
    for lane, o in enumerate(orders):
        seq[lane, :len(o)] = o
    kk = np.full((lanes, b, n, 3), np.inf, np.float32)
    ii = np.zeros((lanes, b, n, 3), np.int64)
    with np.errstate(all="ignore"):
        for t in range(steps):
            j = seq[:, t]
            seeds = known[:, np.maximum(j, 0)].transpose(1, 0, 2)[:, :, None, :]  # (lanes, b, 1, 3)
            d = _sq_dist(unknown[None], seeds)
            _lane_insert(kk, ii, d, j[:, None, None], (j >= 0)[:, None, None])
        off = 1
        while off < lanes:
            partner = np.arange(lanes) ^ off
            kk, ii = _merge(kk, ii, kk[partner], ii[partner])
            off *= 2
        assert (ii == ii[:1]).all() and (kk == kk[:1]).all()
        rows = np.arange(b)[:, None, None]
        d2 = _sq_dist(unknown[:, :, None, :], known[rows, ii[0]])
    # the root as the plain version takes it, PyTorch's: on the CPU it is not
    # always the correctly rounded one that __fsqrt_rn and NumPy give
    dist = torch.sqrt(torch.from_numpy(d2)).numpy()
    return dist, ii[0].astype(np.int32)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_scan_and_merge_match_plain(case, lanes):
    """However the seeds split over a query's lanes, the merged top 3 is
    the plain version's, bit for bit: ties across lanes to the lower
    index, NaN first, (+inf, 0) slots surviving merges where fewer than 3
    seeds have a finite d2, and seeds past one tile."""
    unknown, known = CASES[case]()
    d, i = split_three_nn(unknown, known, lanes)
    want_d, want_i = three_nn_plain(torch.from_numpy(unknown), torch.from_numpy(known))
    np.testing.assert_array_equal(i, want_i.numpy())
    np.testing.assert_array_equal(d, want_d.numpy())


def test_lane_orders_cover_every_seed_once_in_index_order():
    for m in (1, 3, 4, 7, 256, 301, 1024, 1027, 5000):
        for lanes in (1, 2, 4, 8, 16, 32):
            orders = lane_orders(m, lanes)
            assert sorted(sum(orders, [])) == list(range(m))
            assert all(o == sorted(o) for o in orders)  # a later seed of a lane has a higher index


def test_three_nn_takes_the_plain_version_on_the_cpu_without_counting():
    unknown, known = (torch.from_numpy(x) for x in CASES["grid_duplicate_seeds_m1024"]())
    before = three_nn.launches
    d, i = three_nn(unknown, known)
    assert three_nn.launches == before
    want_d, want_i = three_nn_plain(unknown, known)
    assert torch.equal(i, want_i)
    assert torch.equal(d, want_d)


def test_three_nn_outputs_carry_no_gradient():
    unknown, known = (torch.from_numpy(x).requires_grad_() for x in CASES["m3"]())
    d, i = three_nn(unknown, known)
    assert not d.requires_grad and not i.requires_grad


def test_three_nn_refuses_misshapen_input():
    unknown, known = (torch.from_numpy(x) for x in CASES["m3"]())
    for u, k in ((unknown[..., :2], known), (unknown, known[..., :2]), (unknown[0], known[0]),
                 (unknown, known[:1]), (unknown, known[:, :0])):
        with pytest.raises(ValueError):
            three_nn(u, k)


def test_three_nn_builds_without_multiply_add_contraction():
    """csrc/three_nn.cu rounds each difference, product and sum on its own,
    as its plain version does."""
    assert "three_nn" in _build.SOURCES
    assert "-fmad=false" in _build._flags("three_nn")
    assert "--use_fast_math" not in _build._flags("three_nn")


def test_grid_conv_on_duplicate_seeds_matches_flax(pair):  # noqa: F811
    """Boxes centred near seeds, a quarter of which are exact copies of
    others: the grid's neighbours tie, and the lower index must win on
    both sides for the IoU logits to agree."""
    bound, pm, *_ = pair
    _, known = grids(9, 2, 16, 64, duplicates=True)
    rng = np.random.RandomState(10)
    center = (known[:, :16] + rng.normal(0, 0.1, (2, 16, 3))).astype(np.float32)
    size = rng.uniform(0.1, 1.0, (2, 16, 3)).astype(np.float32)
    heading = rng.uniform(-np.pi, np.pi, (2, 16)).astype(np.float32)
    feats = rng.randn(2, 64, 256).astype(np.float32)
    want = bound.grid_conv(jnp.asarray(center), jnp.asarray(size), jnp.asarray(heading),
                           {"seed_xyz": jnp.asarray(known), "seed_features": jnp.asarray(feats)},
                           train=False)
    with torch.inference_mode():
        got = pm.grid_conv(*(torch.from_numpy(x) for x in (center, size, heading)),
                           {"seed_xyz": torch.from_numpy(known),
                            "seed_features": torch.from_numpy(feats)})
    np.testing.assert_allclose(got["iou_scores"].numpy(), np.asarray(want["iou_scores"]),
                               rtol=0, atol=1e-4)


def test_fp_module_on_ties_and_a_ragged_count_matches_flax(pair):  # noqa: F811
    """FP2 with 37 queries (not a multiple of a block) against 16 known
    points on a lattice, some queries at equal distance from several."""
    bound, pm, *_ = pair
    rng = np.random.RandomState(11)
    known = np.stack(np.meshgrid([0.0, 1.0], [0.0, 1.0], [0.0, 1.0, 2.0, 3.0], indexing="ij"),
                     -1).reshape(1, 16, 3).repeat(2, 0)
    unknown = rng.randint(0, 7, (2, 37, 3)) * 0.5
    args = [a.astype(np.float32) for a in (unknown, known, rng.randn(2, 37, 256),
                                            rng.randn(2, 16, 256))]
    want = bound.backbone_net.fp2(*map(jnp.asarray, args), train=False)
    with torch.inference_mode():
        got = pm.backbone_net.fp2(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
