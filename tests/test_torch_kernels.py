"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Edge cases the full-width run in ``chip_smoke.py`` does not reach: ragged
sizes, zeroed points and ties, centers without hits, out-of-range indices,
every gather width, every ball-query instantiation, unaligned scenes,
ballots that cross nsample; the gather's backward against an f64 sum with
repeated and out-of-range indices and more than 65,535 blocks, and the
gather's gradient through autograd, runs planned and forced, empty rows
and runs, list blocks of thousands of rows, ten channel groups, and first
hits on low rows; the rotated IoU on axis-aligned ties, degenerate and
zero-size boxes and placeholder boxes, all pairs of more boxes than one
tile, and pairs across the reach of the containment margin; lower-half
suppression on clustered boxes, duplicates, ties, IoUs at the threshold,
-inf and NaN scores, K either side of the switch from a warp a scene to a
block a scene, ragged and largest K, and the wrapper's refusals;
FPS over FPS-ordered clouds at the shapes of ``fps_prefix=False``, which
must give back their prefixes under every launch the plan weighs; the ball
query and the gather's backward at nsample 128 over 2,048 centres;
the bitcast-packed bf16 gather bit for bit and its backward within one
bf16 ulp at SA3's and SA4's shapes; three_nn bit for bit on ties, fewer
than 3 seeds, overflow, NaN queries and seeds, ties across the lanes that split a query's seeds, seeds beyond
one shared-memory tile, under every (S, Q) the source instantiates, at
GridConv's and FP's shapes, and the wrapper's refusals; greedy NMS
exactly on every case of tests/nms_cases.py in its three box modes, both
old_types and matrix mode, at the planned cluster size and at every size
nms_plan can pick, K from 1 to 1,024 across the bit rows' words and the
blocks' shares, 300 scenes, the plan's residency, past 1,024 on the
global-matrix path (nms_cases.LARGE, K to 4,096, and K either side of the
switch), the wrapper's refusals, and parse_predictions on the card
against the NumPy parse; three_interpolate bit for bit at FP1's and FP2's
shapes and on repeated, out-of-range and clamped indices, zero weights,
one known row, ragged channels and a table off 16-byte alignment, with
FP's skip features written after the interpolation and without; its
backward bit for bit the plain version on the CPU and the same over two
runs, on contiguous and strided cotangents, under every launch the
kernel takes, over several windows of slots and more rows than a block
holds; its gradient through autograd into the features and the skip, and
the wrapper's refusals of other dtypes and devices; and
``stage_batch`` staging batches back to back bit for bit. The file
imports no JAX, so it runs on a machine with a card and without JAX; this
repository's conftest imports JAX, so run it there as ``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``.
Without a card every test skips.
"""
import numpy as np
import pytest
import torch
from iou_cases import gap_pairs, random_boxes
from lhs_cases import CASES as LHS_CASES
from lhs_cases import clustered
from nms_cases import CASES as NMS_CASES
from nms_cases import LARGE as NMS_LARGE
from nms_cases import clustered as nms_clustered
from three_nn_cases import CASES as NN_CASES
from three_nn_cases import grids, room_seeds

from iou3dmatch_tpu_torch.geometry.iou3d import (MODES, box_pairs, box_pairs_plain, boxes_iou3d,
                                                 pairs_apart)
from iou3dmatch_tpu_torch.geometry.nms import box_overlaps as nms_box_overlaps
from iou3dmatch_tpu_torch.geometry.nms import (lhs_3d_samecls_plain, nms_boxes_plain,
                                               nms_masked_plain, nms_rotated)
from iou3dmatch_tpu_torch.ops.ball_query import (BQ_CENTERS, BallQueryLaunch, GatherBwdLaunch,
                                                 ball_query, ball_query_plain, group_points,
                                                 group_points_backward, group_points_bitcast,
                                                 group_points_plain)
from iou3dmatch_tpu_torch.ops.interpolate import (NN_LAUNCHES, InterpBwdLaunch, NnLaunch,
                                                  three_interpolate,
                                                  three_interpolate_backward,
                                                  three_interpolate_backward_plain,
                                                  three_interpolate_plain, three_nn, three_nn_plain)
from iou3dmatch_tpu_torch.ops.lhs import MAX_BOXES, SMALL_BOXES, lhs_3d_samecls
from iou3dmatch_tpu_torch.ops.nms import GLOBAL_MAX_BOXES as NMS_GLOBAL_MAX_BOXES
from iou3dmatch_tpu_torch.ops.nms import MAX_BOXES as NMS_MAX_BOXES
from iou3dmatch_tpu_torch.ops.nms import NMS_CLUSTERS, nms_boxes, nms_masked
from iou3dmatch_tpu_torch.ops.nms import max_active_clusters as nms_max_active_clusters
from iou3dmatch_tpu_torch.ops.nms import planned_cluster as nms_planned_cluster
from iou3dmatch_tpu_torch.ops.fps import (GLOBAL, REG_PPTS, SHARED, STREAM_THREADS, FpsLaunch,
                                          fps_candidates, fps_plan, fps_variant,
                                          furthest_point_sample, furthest_point_sample_plain,
                                          max_active_clusters)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (b, n, npoint, forced (cluster, threads) or None for the planned launch)
FPS_CASES = [
    (3, 1000, 96, None), (1, 33, 33, None), (2, 5000, 1, None), (1, 70000, 64, None),
    (24, 40000, 16, None),  # the SSL step's shared SA1 FPS over 12 + 12 clouds
    (1, 300000, 24, None),  # too large for shared memory: the streaming variant
    (2, 200000, 24, None),  # the shared-memory variant
    (2, 1001, 200, (16, 256)),  # N < S * threads, N % S != 0
    (2, 20, 20, (16, 128)),  # empty shares past N
    (3, 40000, 48, (8, 128)), (3, 40000, 48, (16, 512)), (3, 40000, 48, (16, 1024)),
    (3, 40000, 48, (8, 1024)),  # the sweep's register variants
]


def _fps_launch(n, forced):
    return None if forced is None else fps_variant(n, *forced)


@pytest.mark.parametrize("b,n,npoint,forced", FPS_CASES)
def test_fps_kernel_matches_plain(cuda, b, n, npoint, forced):
    rng = np.random.RandomState(n)
    xyz = rng.randn(b, n, 3).astype(np.float32)
    xyz[:, rng.choice(n, n // 10, replace=False)] = 0.0  # never chosen
    xyz[:, 1:n // 4] = xyz[:, n // 4:2 * (n // 4) - 1]  # duplicates: distance ties
    t = torch.from_numpy(xyz).to(cuda)
    launch = _fps_launch(n, forced)
    if n in (300000, 200000):
        assert fps_plan(t.device, b, n)[0].variant == ("global" if n == 300000 else "shared")
    before = furthest_point_sample.launches
    got = furthest_point_sample(t, npoint, launch)
    assert furthest_point_sample.launches == before + 1
    torch.testing.assert_close(got, furthest_point_sample_plain(t, npoint), rtol=0, atol=0)


@pytest.mark.parametrize("forced", [(4, 256), (16, 128), None])
def test_fps_kernel_ties_across_blocks(cuda, forced):
    """Equal far points in different blocks' shares: the lower global index
    must win across the cluster, then its twin (distance 0) drops out."""
    n = 4000
    rng = np.random.RandomState(7)
    xyz = rng.uniform(-1, 1, (2, n, 3)).astype(np.float32)
    for i, (a, b) in enumerate([(3100, 700), (2600, 1900), (3999, 1000)]):
        xyz[:, a] = xyz[:, b] = (20.0 + 5 * i, -20.0, 3.0 * i)  # later share first, lower index wins
    t = torch.from_numpy(xyz).to(cuda)
    got = furthest_point_sample(t, 16, _fps_launch(n, forced))
    want = furthest_point_sample_plain(t, 16)
    assert torch.equal(got, want)
    assert set(want[0, 1:4].tolist()) == {700, 1900, 1000}


@pytest.mark.parametrize("forced", [(4, 256), (16, 256)])
def test_fps_kernel_share_of_invalid_points(cuda, forced):
    n = 4000
    xyz = np.random.RandomState(8).uniform(-1, 1, (2, n, 3)).astype(np.float32)
    launch = fps_variant(n, *forced)
    xyz[:, launch.share:2 * launch.share] = 0.0  # block 1 holds only invalid points
    t = torch.from_numpy(xyz).to(cuda)
    got = furthest_point_sample(t, 64, launch)
    assert torch.equal(got, furthest_point_sample_plain(t, 64))
    assert not ((got[:, 1:] >= launch.share) & (got[:, 1:] < 2 * launch.share)).any()


def test_fps_kernel_instantiates_every_variant_the_rule_can_plan(cuda):
    """ops/fps.py's table of (threads, points a thread), the rule's and the
    sweep's, and csrc/fps.cu's instantiations agree: the card answers for
    each, at S = 1 and 16."""
    planned = [(t, p) for t, ppts in REG_PPTS.items() for p in ppts]
    planned += [(STREAM_THREADS, SHARED), (STREAM_THREADS, GLOBAL)]
    for t, p in planned:
        for s in (1, 16):
            assert max_active_clusters(FpsLaunch(s, t, p, max(p, 1) * t // 2 + 1), cuda) >= 1, (t, p, s)


# fps_prefix=False: (points, npoint) of SA2, SA3, SA4 and seed_fps, each over
# the FPS-ordered prefix SA1 gives them
FPS_PREFIX_SHAPES = [(2048, 1024), (1024, 512), (512, 256), (1024, 128)]


@pytest.fixture(scope="module")
def fps_ordered():
    """SA1's 2,048 FPS picks of 8 rooms of 40,000 points, in pick order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(40)
    pts = np.concatenate([rng.uniform(-3, 3, (8, 40000, 2)), rng.uniform(0, 2.5, (8, 40000, 1))],
                         -1).astype(np.float32)
    t = torch.from_numpy(pts).cuda()
    inds = furthest_point_sample_plain(t, 2048).long()
    return t[torch.arange(8, device=t.device)[:, None], inds].contiguous()


@pytest.mark.parametrize("n,npoint", FPS_PREFIX_SHAPES)
def test_fps_over_an_fps_ordered_cloud_gives_back_its_prefix(cuda, fps_ordered, n, npoint):
    """FPS re-run on an FPS-ordered set picks its first npoint points in
    order (the JAX package's prefix theorem), under the planned launch and
    every candidate the rule weighs at that N, each equal to the plain
    version."""
    t = fps_ordered[:, :n].contiguous()
    want = furthest_point_sample_plain(t, npoint)
    prefix = torch.arange(npoint, dtype=torch.int32, device=cuda).expand(8, -1)
    assert torch.equal(want, prefix)
    for launch in (None,) + fps_candidates(n):
        assert torch.equal(furthest_point_sample(t, npoint, launch), prefix), launch


def test_fps_kernel_all_points_invalid(cuda):
    t = torch.zeros(2, 100, 3, device=cuda)
    assert torch.equal(furthest_point_sample(t, 8), furthest_point_sample_plain(t, 8))


def _bq_check(cuda, radius, nsample, xyz, ctr, launch=None):
    """The kernel (planned or forced launch) against the plain version."""
    p, c = (torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (xyz, ctr))
    before = ball_query.launches
    got = ball_query(radius, nsample, p, c, launch)
    assert ball_query.launches == before + 1
    want = ball_query_plain(radius, nsample, p, c)
    assert torch.equal(got, want)
    return want


@pytest.mark.parametrize("radius,nsample,n,m", [(0.3, 16, 777, 50), (0.2, 64, 4000, 300),
                                                (1.0, 1, 31, 5), (5.0, 40, 33, 7)])
def test_ball_query_kernel_matches_plain(cuda, radius, nsample, n, m):
    rng = np.random.RandomState(m)
    xyz = rng.uniform(-1, 1, (2, n, 3)).astype(np.float32)
    ctr = np.concatenate([xyz[:, :m - 1], np.full((2, 1, 3), 50.0, np.float32)], axis=1)
    want = _bq_check(cuda, radius, nsample, xyz, ctr)
    assert torch.equal(want[:, -1], torch.zeros_like(want[:, -1]))  # no hit -> index 0


@pytest.mark.parametrize("b,n,m,radius,nsample", [
    (2, 2500, 300, 0.3, 16),  # N a multiple of neither T nor 32; B*m not a multiple of G
    (2, 20, 7, 1.0, 8),  # N < 32
    (3, 2501, 100, 0.3, 16),  # 4 does not divide N: scenes 1 and 2 start off 16 bytes
    (2, 20, 5, 5.0, 64),  # nsample > N
    (1, 300000, 64, 0.05, 32),
    (2, 4000, 2048, 0.2, 64),  # more centers than one block a scene
])
def test_ball_query_kernel_shapes(cuda, b, n, m, radius, nsample):
    rng = np.random.RandomState(n + m)
    xyz = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    _bq_check(cuda, radius, nsample, xyz, xyz[:, rng.choice(n, m)])


@pytest.mark.parametrize("tile", [32, 1024])
def test_ball_query_kernel_hits_only_in_the_last_tile(cuda, tile):
    n = 3 * 1024 + 77  # the last tile holds 77 points at T = 1,024, 13 at T = 32
    rng = np.random.RandomState(tile)
    xyz = rng.uniform(10, 20, (2, n, 3)).astype(np.float32)
    xyz[:, -10:] = rng.uniform(-0.1, 0.1, (2, 10, 3))
    ctr = rng.uniform(-0.05, 0.05, (2, 70, 3)).astype(np.float32)
    want = _bq_check(cuda, 0.3, 16, xyz, ctr, BallQueryLaunch(8, tile))
    assert (want >= n - 10).all()


@pytest.mark.parametrize("nsample", [20, 40, 64])
@pytest.mark.parametrize("c", BQ_CENTERS)
def test_ball_query_kernel_every_point_a_hit(cuda, c, nsample):
    """A chunk's 32 hits cross nsample in mid-ballot (20, 40), or just fill it
    (64); full centers must take no further slot."""
    xyz = np.random.RandomState(c).uniform(-1, 1, (2, 500, 3)).astype(np.float32)
    want = _bq_check(cuda, 10.0, nsample, xyz, xyz[:, :37], BallQueryLaunch(c, 64))
    assert torch.equal(want.cpu(), torch.arange(nsample, dtype=torch.int32).expand_as(want))


@pytest.mark.parametrize("tile", [32, 1024, 2048])
@pytest.mark.parametrize("c", BQ_CENTERS)
def test_ball_query_kernel_every_variant(cuda, c, tile):
    """Every instantiated C through the override, a ragged last block, and
    centers without a hit."""
    rng = np.random.RandomState(10 * c + tile)
    xyz = rng.uniform(-1, 1, (3, 1001, 3)).astype(np.float32)
    ctr = np.concatenate([xyz[:, :76], np.full((3, 1, 3), 50.0, np.float32)], axis=1)
    want = _bq_check(cuda, 0.3, 16, xyz, ctr, BallQueryLaunch(c, tile))
    assert torch.equal(want[:, -1], torch.zeros_like(want[:, -1]))


def test_ball_query_kernel_no_center_hits(cuda):
    xyz = np.random.RandomState(3).uniform(-1, 1, (2, 3000, 3)).astype(np.float32)
    want = _bq_check(cuda, 0.2, 32, xyz, np.full((2, 100, 3), -9.0, np.float32))
    assert not want.any()


def test_ball_query_kernel_more_scenes_than_a_grid_row(cuda):
    """B past 65,535, the limit of a grid's y dimension: 7 distinct scenes,
    each repeated, so the plain result is that of the 7 repeated."""
    rng = np.random.RandomState(11)
    xyz = rng.uniform(-1, 1, (7, 40, 3)).astype(np.float32)
    ctr = xyz[:, :3].copy()
    reps = 9363  # 7 x 9,363 = 65,541 scenes
    p = torch.from_numpy(xyz).to(cuda)
    got = ball_query(0.5, 4, p.repeat(reps, 1, 1), torch.from_numpy(ctr).to(cuda).repeat(reps, 1, 1))
    assert torch.equal(got, ball_query_plain(0.5, 4, p, torch.from_numpy(ctr).to(cuda)).repeat(reps, 1, 1))


def _surface_room(seed, b, n):
    """(b, n, 3) points uniform by area over the floor and four walls of a
    4 x 4 x 2.5 m room, as a scan sees it."""
    rng = np.random.RandomState(seed)
    face = rng.choice(3, size=(b, n), p=[16 / 56, 20 / 56, 20 / 56])  # floor, x walls, y walls
    u, w = rng.uniform(-2.0, 2.0, (2, b, n))
    side = np.where(rng.rand(b, n) < 0.5, -2.0, 2.0)
    z = np.where(face == 0, 0.0, rng.uniform(0.0, 2.5, (b, n)))
    x = np.where(face == 1, side, u)
    y = np.select([face == 0, face == 1], [w, u], side)
    return np.stack([x, y, z], -1).astype(np.float32)


@pytest.mark.parametrize("launch", [None, BallQueryLaunch(4, 1024), BallQueryLaunch(1, 256)])
def test_ball_query_kernel_surface_scene(cuda, launch):
    """Points on the floor and walls of a room, centers by FPS: most balls
    fill their 64 slots, so warps and blocks stop early."""
    xyz = _surface_room(0, 2, 40000)
    t = torch.from_numpy(xyz).to(cuda)
    inds = furthest_point_sample(t, 512).cpu().numpy()
    ctr = np.take_along_axis(xyz, inds[..., None].astype(np.int64), axis=1)
    want = _bq_check(cuda, 0.2, 64, xyz, ctr, launch)
    assert (want[..., -1] > want[..., -2]).float().mean() > 0.5  # most balls are full


def test_ball_query_kernel_refuses_bad_launches(cuda):
    p = torch.zeros(1, 40, 3, device=cuda)
    for launch in (BallQueryLaunch(3, 1024), BallQueryLaunch(16, 1024),
                   BallQueryLaunch(8, 100), BallQueryLaunch(8, 4096)):
        with pytest.raises(ValueError):
            ball_query(0.2, 8, p, p[:, :4].contiguous(), launch)


@pytest.mark.parametrize("c,offset", [(1, 0), (2, 0), (3, 0), (4, 0), (4, 1), (5, 0), (8, 0),
                                      (8, 2), (131, 0), (259, 0)])
def test_gather_kernel_matches_plain(cuda, c, offset):
    """B*Q*C = 231*C, not a multiple of 4 unless 4 | C; a table view may
    start off 16-byte alignment."""
    rng = np.random.RandomState(c)
    flat = torch.from_numpy(rng.randn(offset + 3 * 57 * c).astype(np.float32)).to(cuda)
    tab = flat[offset:].view(3, 57, c)
    idx = torch.from_numpy(rng.randint(-5, 62, (3, 11, 7)).astype(np.int32)).to(cuda)
    before = group_points.launches
    got = group_points(tab, idx)
    assert group_points.launches == before + 1
    assert torch.equal(got, group_points_plain(tab, idx))


def test_gather_kernel_refuses_grad_and_bad_input(cuda):
    """A table that needs a gradient is checked as strictly as one that
    does not: the checks run before the autograd Function."""
    tab = torch.randn(1, 10, 4, device=cuda)
    idx = torch.zeros(1, 2, 3, dtype=torch.int32, device=cuda)
    for t in (tab, tab.clone().requires_grad_()):
        with pytest.raises(TypeError):
            group_points(t, idx.long())
        with pytest.raises(ValueError):
            group_points(t.detach().transpose(1, 2).contiguous().transpose(1, 2), idx)
        with pytest.raises(ValueError):
            group_points(t, idx[0])


def _f64_segment_sum(g, idx, n):
    b, c = g.shape[0], g.shape[-1]
    rows = (idx.long().clamp(0, n - 1) + n * torch.arange(b, device=g.device)[:, None, None])
    out = torch.zeros(b * n, c, dtype=torch.float64, device=g.device)
    mag = torch.zeros(b * n, c, dtype=torch.float64, device=g.device)
    out.index_add_(0, rows.reshape(-1), g.reshape(-1, c).double())
    mag.index_add_(0, rows.reshape(-1), g.reshape(-1, c).double().abs())
    return out.reshape(b, n, c), mag.reshape(b, n, c)


def _check_gather_bwd(g, idx, n, launch=None):
    """Within 1e-5 x (the sum of |g| added into each element) of an f64 sum,
    so exactly 0 where nothing is added. The output is never zeroed: a
    block of NaN freed just before is what the allocator hands it."""
    torch.full((g.shape[0], n, g.shape[-1]), float("nan"), device=g.device)
    before = group_points_backward.launches
    got = group_points_backward(g, idx, n, launch)
    torch.cuda.synchronize()
    assert group_points_backward.launches == before + 1
    want, mag = _f64_segment_sum(g, idx, n)
    assert ((got.double() - want).abs() <= 1e-5 * mag).all()


@pytest.mark.parametrize("c", [1, 3, 131, 259])
def test_gather_bwd_kernel_matches_f64_sum(cuda, c):
    """Repeated and out-of-range indices (clamped to [0, N-1]); B*U*C not a
    multiple of the block's elements."""
    rng = np.random.RandomState(c)
    idx = torch.from_numpy(rng.randint(-5, 62, (3, 11, 7)).astype(np.int32)).to(cuda)
    idx[:, 0] = 4  # a ball whose slots all repeat one hit
    g = torch.from_numpy(rng.randn(3, 11, 7, c).astype(np.float32)).to(cuda)
    _check_gather_bwd(g, idx, 57)


def test_gather_bwd_kernel_all_equal_indices(cuda):
    """Every cotangent row adds into one table row: the most contention."""
    g = torch.randn(2, 512, 16, 259, device=cuda)
    _check_gather_bwd(g, torch.full((2, 512, 16), 7, dtype=torch.int32, device=cuda), 1024)


def test_gather_bwd_kernel_more_than_65535_blocks(cuda):
    """2 x 40,000 slots of 900 channels into 5,000 rows: 72 M elements of g,
    ten sum warps a run, one for each group of 96 channels."""
    g = torch.randn(2, 40_000, 1, 900, device=cuda)
    idx = torch.randint(0, 5000, (2, 40_000, 1), dtype=torch.int32, device=cuda)
    _check_gather_bwd(g, idx, 5000)


@pytest.mark.parametrize("b,n,u,c,launch", [
    (2, 40_000, 4096, 4, None),  # more rows than slots: most rows get zeros
    (1, 1024, 8192, 259, None),
    (1, 1024, 8192, 259, GatherBwdLaunch(1)),  # one sum block: 8 runs of about 1,024 slots
    (1, 1024, 8192, 259, GatherBwdLaunch(1000)),  # more runs than rows: most runs empty
    (200, 20_000, 64, 4, None),  # more scenes than SMs: 3 list blocks of 6,666 rows a scene
    (2, 500, 4096, 900, None),  # ten channel groups
    (3, 1, 77, 259, None),  # a one-row table
    (2, 3, 5000, 1, GatherBwdLaunch(4)),
])
def test_gather_bwd_kernel_runs_and_channel_passes(cuda, b, n, u, c, launch):
    rng = np.random.RandomState(n + c)
    idx = torch.from_numpy(rng.randint(-3, n + 3, (b, u, 1)).astype(np.int32)).to(cuda)
    g = torch.from_numpy(rng.randn(b, u, 1, c).astype(np.float32)).to(cuda)
    _check_gather_bwd(g, idx, n, launch)


@pytest.mark.parametrize("launch", [None, BallQueryLaunch(1, 2048), BallQueryLaunch(8, 1024)])
def test_ball_query_and_gather_bwd_kernels_at_nsample_128(cuda, launch):
    """PointnetSAModuleMSGVotes' second SA1 scale: r 0.4, nsample 128, 2,048
    centres over 2 rooms of 40,000 points (balls that fill and balls that
    do not), then the backward of the packed [xyz | height] gather at those
    262,144 slots a scene, each against its plain version."""
    rng = np.random.RandomState(41)
    pts = np.concatenate([rng.uniform(-3, 3, (2, 40000, 2)), rng.uniform(0, 2.5, (2, 40000, 1))],
                         -1).astype(np.float32)
    pts[:, :5000, 2] = 0.0  # a dense floor: balls there fill their 128 slots
    ctr = pts[:, rng.choice(40000, 2048, replace=False)]
    idx = _bq_check(cuda, 0.4, 128, pts, ctr, launch)
    full = idx[..., -1] > idx[..., -2]
    assert full.any() and (~full).any()
    g = torch.from_numpy(rng.randn(2, 2048, 128, 4).astype(np.float32)).to(cuda)
    _check_gather_bwd(g, idx, 40000)


def test_gather_bwd_kernel_first_hits_on_low_rows(cuda):
    """Balls whose first hit is a low row and whose few hits leave the rest
    of their 32 slots repeating it, as the ball query gives the step."""
    rng = np.random.RandomState(5)
    first = np.minimum(rng.geometric(1 / 300, (8, 1024)), 2047)
    idx = np.repeat(first[..., None], 32, -1)
    idx[..., 1:4] = rng.randint(0, 2048, (8, 1024, 3))
    g = torch.randn(8, 1024, 32, 131, device=cuda)
    _check_gather_bwd(g, torch.from_numpy(idx.astype(np.int32)).to(cuda), 2048)


def test_gather_bwd_kernel_refuses_bad_launches(cuda):
    g = torch.randn(1, 4, 2, 8, device=cuda)
    idx = torch.zeros(1, 4, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        group_points_backward(g, idx, 10, GatherBwdLaunch(0))


def test_group_points_gradient_on_the_card(cuda):
    """The gather's autograd on the card against an f64 CPU reference:
    forward exact, gradient within atol 1e-5 (f32 atomics against f64)."""
    rng = np.random.RandomState(9)
    feats = rng.randn(2, 50, 131)
    idx = torch.from_numpy(rng.randint(-4, 56, (2, 9, 6)).astype(np.int32))
    g = torch.from_numpy(rng.randn(2, 9, 6, 131))
    ref = torch.from_numpy(feats).requires_grad_()
    group_points_plain(ref, idx).backward(g)
    tab = torch.from_numpy(feats).float().to(cuda).requires_grad_()
    before = group_points_backward.launches
    out = group_points(tab, idx.to(cuda))
    out.backward(g.float().to(cuda))
    assert group_points_backward.launches == before + 1
    assert torch.equal(out.detach().cpu(), group_points_plain(tab.detach().cpu(), idx))
    torch.testing.assert_close(tab.grad.cpu().double(), ref.grad, rtol=0, atol=1e-5)


def _iou_boxes(rng, n, rotated):
    b = np.zeros((n, 7), np.float32)
    b[:, 0:3] = rng.uniform(-1.5, 1.5, (n, 3))
    b[:, 3:6] = rng.uniform(0.2, 1.5, (n, 3))
    if rotated:
        b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def _iou_case(name):
    rng = np.random.RandomState(len(name))
    a, b = _iou_boxes(rng, 2 * 40, name == "rotated"), _iou_boxes(rng, 2 * 24, name == "rotated")
    if name == "axis_aligned_ties":
        a[:24] = b[:24]  # coinciding candidates tie in angle
        a[24:48, 0:2] = np.round(b[:24, 0:2], 1)
        a[24:48, 3:5] = np.round(b[:24, 3:5], 1)
        b[24:, 0] = a[24:48, 0] + a[24:48, 3]  # edges that touch
    elif name == "degenerate":
        a[:20, 3] = 0.0  # zero width
        a[20:40, 3:6] = 0.0  # a point
        b[:10] = a[40:50]
        b[:10, 6] = a[40:50, 6] + np.float32(np.pi / 2)  # a square turned a quarter
        a[50:60, 3:5] = 1e-6  # tinier than the 1e-2 margin
    elif name == "placeholders":
        b[::2, 0:3] = -1000.0
    return a.reshape(2, 40, 7), b.reshape(2, 24, 7)


@pytest.mark.parametrize("case", ["rotated", "axis_aligned_ties", "degenerate", "placeholders"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_iou_kernel_matches_plain(cuda, case, mode):
    """Each mode against the plain version on the card and on the CPU, atol 1e-5."""
    a, b = (torch.from_numpy(x) for x in _iou_case(case))
    before = box_pairs.launches
    got = box_pairs(a.to(cuda), b.to(cuda), mode)
    torch.cuda.synchronize()
    assert box_pairs.launches == before + 1
    torch.testing.assert_close(got, box_pairs_plain(a.to(cuda), b.to(cuda), mode),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(got.cpu(), box_pairs_plain(a, b, mode), rtol=0, atol=1e-5)
    assert torch.isfinite(got).all()
    if case == "placeholders":
        assert (got[:, :, ::2] == 0).all()


def test_iou_kernel_all_pairs_beyond_one_tile(cuda):
    """B = 1, 1,000 x 1,500 rotated boxes in an 8 m room: 125 row tiles x 12
    column tiles, every mode, and the all-pairs entry point."""
    rng = np.random.RandomState(12)
    a = torch.from_numpy(random_boxes(rng, 1000, True, room=4.0)).to(cuda)[None]
    b = torch.from_numpy(random_boxes(rng, 1500, True, room=4.0)).to(cuda)[None]
    for mode in sorted(MODES):
        got = box_pairs(a, b, mode)
        torch.testing.assert_close(got, box_pairs_plain(a, b, mode), rtol=0, atol=1e-5)
        assert (got[pairs_apart(a[0][:, None], b[0][None], mode)[None]] == 0).all()
    torch.testing.assert_close(boxes_iou3d(a[0], b[0]), box_pairs_plain(a, b, "iou3d")[0],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("rotated", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_iou_kernel_near_the_reach(cuda, mode, rotated):
    """Pairs whose corners' extents are 0 to 2e-2 apart along x, y, a
    diagonal and z (tests/iou_cases.py), all against all in one scene and
    as one pair a scene: the kernel's reject and its warp per pair against
    the plain version, and 0 wherever pairs_apart rejects."""
    a, b, _ = gap_pairs(16 + rotated, rotated)
    ta, tb = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    for x, y in ((ta[None], tb[None]), (ta[:, None], tb[:, None])):
        got = box_pairs(x, y, mode)
        torch.testing.assert_close(got, box_pairs_plain(x, y, mode), rtol=0, atol=1e-5)
        assert (got[pairs_apart(x[:, :, None], y[:, None], mode)] == 0).all()


# --------------------------------------------------- lower-half suppression

def _lhs_on(cuda, case):
    mins, maxs, scores, cls, thresh = case
    return [torch.from_numpy(x).to(cuda) for x in (mins, maxs, scores, cls)], thresh


def _lhs_edge_cases():
    """(name, case): shapes and inputs past the step's (8, 64); k100 and
    k1024 run the thread-a-box path, the others the bit-matrix path (K <=
    SMALL_BOXES)."""
    rng = np.random.RandomState(20)
    one = np.zeros((2, 40, 3), np.float32)
    same = (one, one + 1.0, rng.rand(2, 40).astype(np.float32), np.zeros((2, 40), np.int64), 0.25)
    apart = np.arange(50, dtype=np.float32)[None, :, None].repeat(3, 2) * 3.0
    tied = np.full((1, 50), 0.5, np.float32)
    return [
        ("k1", clustered(21, 5, 1, 1)),
        ("k33_ragged_warp", clustered(22, 4, 33, 2)),
        ("k100", clustered(23, 2, 100, 3)),
        ("k1024_largest", clustered(24, 2, MAX_BOXES, 4)),
        ("one_cluster_of_copies", same),
        ("no_overlap_all_tied", (apart, apart + 1.0, tied, np.zeros((1, 50), np.int64), 0.25)),
        ("negative_threshold", clustered(25, 3, 64, 5, thresh=-0.5)),
        ("many_scenes", clustered(26, 300, 64, 3)),
    ]


@pytest.mark.parametrize("case", sorted(LHS_CASES))
def test_lhs_kernel_matches_plain(cuda, case):
    """The CPU test's cases, at (3, 16) and (8, 64) among them: equal keep
    masks, on the card and against the plain version on the CPU. Cases of
    K <= SMALL_BOXES run the bit-matrix path, the three of K = 65 and 100
    the thread-a-box path."""
    args, thresh = _lhs_on(cuda, LHS_CASES[case]())
    before = lhs_3d_samecls.launches
    got = lhs_3d_samecls(*args, thresh)
    torch.cuda.synchronize()
    assert lhs_3d_samecls.launches == before + 1
    assert got.dtype == torch.bool and got.shape == args[2].shape
    assert torch.equal(got, lhs_3d_samecls_plain(*args, thresh))
    assert torch.equal(got.cpu(), lhs_3d_samecls_plain(*(a.cpu() for a in args), thresh))


@pytest.mark.parametrize("name,case", _lhs_edge_cases(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_lhs_kernel_edge_cases(cuda, name, case):
    args, thresh = _lhs_on(cuda, case)
    got = lhs_3d_samecls(*args, thresh)
    torch.cuda.synchronize()
    assert torch.equal(got, lhs_3d_samecls_plain(*args, thresh)), name
    if name == "one_cluster_of_copies":  # the winner and the upper half of the other 39
        assert got.sum(1).tolist() == [1 + 39 // 2] * 2
    if name == "no_overlap_all_tied":
        assert bool(got.all())


@pytest.mark.parametrize("k", [SMALL_BOXES - 1, SMALL_BOXES, SMALL_BOXES + 1])
def test_lhs_kernel_either_side_of_the_path_switch(cuda, k):
    args, thresh = _lhs_on(cuda, clustered(30 + k, 5, k, 2))
    got = lhs_3d_samecls(*args, thresh)
    torch.cuda.synchronize()
    assert torch.equal(got, lhs_3d_samecls_plain(*args, thresh))


def test_lhs_kernel_refuses_bad_input(cuda):
    args, thresh = _lhs_on(cuda, clustered(27, 2, 16, 2))
    mins, maxs, scores, cls = args
    with pytest.raises(ValueError):
        lhs_3d_samecls(*_lhs_on(cuda, clustered(28, 1, MAX_BOXES + 1, 2))[0], thresh)
    with pytest.raises(TypeError):
        lhs_3d_samecls(mins, maxs, scores, cls.float(), thresh)
    with pytest.raises(TypeError):
        lhs_3d_samecls(mins.double(), maxs, scores, cls, thresh)
    with pytest.raises(ValueError):
        lhs_3d_samecls(mins, maxs.cpu(), scores, cls, thresh)
    with pytest.raises(ValueError):
        lhs_3d_samecls(mins[:, :, :2], maxs, scores, cls, thresh)
    with pytest.raises(ValueError):
        lhs_3d_samecls(mins.transpose(0, 1).contiguous().transpose(0, 1), maxs, scores, cls, thresh)
    # int32 classes are widened to int64 for the kernel
    assert torch.equal(lhs_3d_samecls(mins, maxs, scores, cls.int(), thresh),
                       lhs_3d_samecls(mins, maxs, scores, cls, thresh))


# ----------------------------------------------------- three nearest neighbours

def _nn_on(cuda, case):
    return [torch.from_numpy(x).to(cuda) for x in case]


def _nn_equal(got, want):
    assert got[1].dtype == torch.int32 and got[0].dtype == torch.float32
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("case", sorted(NN_CASES))
def test_three_nn_kernel_matches_plain(cuda, case):
    """The CPU test's cases: indices and distances bit for bit those of the
    plain version on the card, and the indices those on the CPU."""
    unknown, known = _nn_on(cuda, NN_CASES[case]())
    before = three_nn.launches
    got = three_nn(unknown, known)
    torch.cuda.synchronize()
    assert three_nn.launches == before + 1
    _nn_equal(got, three_nn_plain(unknown, known))
    assert torch.equal(got[1].cpu(), three_nn_plain(unknown.cpu(), known.cpu())[1])


@pytest.mark.parametrize("b,boxes,m", [(12, 256, 1024), (8, 128, 1024), (1, 3, 5000)])
def test_three_nn_kernel_at_grid_conv_shapes(cuda, b, boxes, m):
    """The SSL step's GridConv (12, 16,384) x 1,024, serving's (8, 8,192) x
    1,024, and seeds five tiles deep."""
    unknown, known = _nn_on(cuda, grids(b * m + boxes, b, boxes, m, duplicates=True))
    _nn_equal(three_nn(unknown, known), three_nn_plain(unknown, known))


@pytest.mark.parametrize("launch", NN_LAUNCHES)
@pytest.mark.parametrize("case", sorted(NN_CASES))
def test_three_nn_kernel_matches_plain_under_every_launch(cuda, case, launch):
    """Every (S, Q) of csrc/three_nn.cu through the ``launch`` override:
    the answer does not depend on how a query's seeds split over lanes."""
    unknown, known = _nn_on(cuda, NN_CASES[case]())
    _nn_equal(three_nn(unknown, known, NnLaunch(*launch)), three_nn_plain(unknown, known))


@pytest.mark.parametrize("b,n,m", [(8, 512, 256), (8, 1024, 512), (12, 512, 256), (12, 1024, 512)])
def test_three_nn_kernel_at_fp_shapes(cuda, b, n, m):
    """FP1 and FP2 of serving and pretraining (8 scenes) and of the SSL
    step (12): the queries a room's points, the seeds their prefix, as FP
    takes SA's FPS-ordered points."""
    pts = room_seeds(np.random.RandomState(b * n + m), b, n).astype(np.float32)
    unknown, known = _nn_on(cuda, (pts, pts[:, :m].copy()))
    _nn_equal(three_nn(unknown, known), three_nn_plain(unknown, known))


def test_three_nn_kernel_refuses_bad_input(cuda):
    unknown, known = _nn_on(cuda, NN_CASES["m3"]())
    with pytest.raises(TypeError):
        three_nn(unknown.double(), known)
    with pytest.raises(TypeError):
        three_nn(unknown, known.half())
    with pytest.raises(ValueError):
        three_nn(unknown.transpose(0, 1).contiguous().transpose(0, 1), known)
    with pytest.raises(ValueError):
        three_nn(unknown, known.cpu())
    with pytest.raises(ValueError):
        three_nn(unknown[..., :2].contiguous(), known)
    with pytest.raises(ValueError):
        three_nn(unknown, known[:, :0])
    with pytest.raises(ValueError):
        three_nn(unknown, known, NnLaunch(3, 1))  # not instantiated
    d, i = three_nn(unknown[:, :0], known)  # nothing to launch
    assert d.shape == i.shape == (2, 0, 3)


# ------------------------------------------------------------ greedy NMS

def _nms_on(cuda, case):
    """The case's tensors on the card; valid is None or a bool tensor."""
    out = {k: torch.from_numpy(case[k]).to(cuda) for k in ("mins", "maxs", "scores", "cls", "boxes")}
    out["valid"] = None if case["valid"] is None else torch.from_numpy(case["valid"]).to(cuda)
    return out


@pytest.mark.parametrize("old_type", [False, True])
@pytest.mark.parametrize("mode", ["2d", "3d", "3d_cls"])
@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_nms_kernel_box_mode_matches_plain(cuda, case, mode, old_type):
    """Every case of tests/nms_cases.py in each branch of parse_predictions
    and both old_types: keep masks equal to the plain version's on the card
    and on the CPU, one launch."""
    raw = NMS_CASES[case]()
    t = _nms_on(cuda, raw)
    args = (t["mins"], t["maxs"], t["scores"], t["cls"] if mode == "3d_cls" else None, t["valid"],
            mode, old_type, raw["thresh"])
    want = nms_boxes_plain(*args)
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    assert torch.equal(want.cpu(), nms_boxes_plain(*cpu))
    for cluster in (None,) + NMS_CLUSTERS:  # the plan's, and every size it can pick
        before = nms_boxes.launches
        got = nms_boxes(*args, cluster=cluster)
        torch.cuda.synchronize()
        assert nms_boxes.launches == before + 1
        assert got.dtype == torch.bool and got.shape == t["scores"].shape
        assert torch.equal(got, want), cluster


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_nms_kernel_matrix_mode_matches_plain(cuda, case):
    """Matrix mode on each case's float32 3D IoU and on its rotated BEV IoU
    (nms_rotated), against nms_masked_plain."""
    raw = NMS_CASES[case]()
    t = _nms_on(cuda, raw)
    iou = nms_box_overlaps(t["mins"], t["maxs"], None, "3d", False).float().contiguous()
    want = nms_masked_plain(iou, t["scores"], raw["thresh"], t["valid"])
    assert torch.equal(want.cpu(), nms_masked_plain(iou.cpu(), t["scores"].cpu(), raw["thresh"],
                                                    None if t["valid"] is None else t["valid"].cpu()))
    for cluster in (None,) + NMS_CLUSTERS:
        before = nms_masked.launches
        got = nms_masked(iou, t["scores"], raw["thresh"], t["valid"], cluster=cluster)
        torch.cuda.synchronize()
        assert nms_masked.launches == before + 1
        assert torch.equal(got, want), cluster
    bev = box_pairs(t["boxes"], t["boxes"], "iou_bev")
    assert torch.equal(nms_rotated(t["boxes"], t["scores"], raw["thresh"]),
                       nms_masked_plain(bev, t["scores"], raw["thresh"]))


NMS_KS = (1, 2, 15, 16, 31, 32, 33, 63, 64, 65, 95, 96, 97, 127, 128, 129, 255, 256, 257, 383,
          511, 512, 513, 767, 768, 769, 1000, 1023, 1024)


def test_nms_kernel_many_scenes_and_every_k(cuda):
    """Scenes past one wave of clusters, and K from 1 to 1,024 in steps that
    cross the 32- and 64-bit words of the bit rows and the shares of the
    cluster's blocks, at the planned cluster size and at 16."""
    for b, k in [(300, 128), (40, 512), (9, 1024)] + [(3, k) for k in NMS_KS]:
        raw = nms_clustered(b + k, b, k, 18)
        t = _nms_on(cuda, raw)
        for mode in ("2d", "3d", "3d_cls"):
            args = (t["mins"], t["maxs"], t["scores"], t["cls"], None, mode, False, 0.25)
            want = nms_boxes_plain(*args)
            for cluster in (None, 16):
                assert torch.equal(nms_boxes(*args, cluster=cluster), want), (b, k, mode, cluster)
        iou = nms_box_overlaps(t["mins"], t["maxs"], None, "3d", False).float().contiguous()
        assert torch.equal(nms_masked(iou, t["scores"], 0.25),
                           nms_masked_plain(iou, t["scores"], 0.25)), (b, k)


def test_nms_plan_on_the_card(cuda):
    """The planned cluster sizes at serving's shape and the largest K: one
    of NMS_CLUSTERS, all B clusters resident at once where larger than 1."""
    for b, k, mode in ((8, 128, "3d_cls"), (8, 256, "3d_cls"), (8, 1024, "3d_cls"),
                       (8, 128, "matrix"), (1, 1024, "2d"), (300, 128, "3d")):
        c = nms_planned_cluster(cuda, b, k, mode)
        assert c in NMS_CLUSTERS
        if c > 1:
            assert nms_max_active_clusters(cuda, mode, k, c) >= b


def test_nms_kernel_refuses_bad_input(cuda):
    """What the kernel cannot take, by name: a cluster size on the global
    path, a K past the global path's shared memory; the cluster path's
    sizes and the inputs' types, devices and layouts."""
    t = _nms_on(cuda, NMS_CASES["clustered_k37"]())
    mins, maxs, scores, cls = t["mins"], t["maxs"], t["scores"], t["cls"]
    big = torch.zeros((1, NMS_MAX_BOXES + 1, 3), device=cuda)
    with pytest.raises(ValueError, match="cluster sizes"):
        nms_boxes(big, big, big[..., 0].contiguous(), None, None, "3d", False, 0.25, cluster=8)
    huge = torch.zeros((1, NMS_GLOBAL_MAX_BOXES + 1, 3), device=cuda)
    with pytest.raises(ValueError, match=f"at most {NMS_GLOBAL_MAX_BOXES}"):
        nms_boxes(huge, huge, huge[..., 0].contiguous(), None, None, "3d", False, 0.25)
    with pytest.raises(ValueError, match="cluster"):
        nms_boxes(mins, maxs, scores, None, None, "3d", False, 0.25, cluster=3)
    with pytest.raises(TypeError):
        nms_boxes(mins.double(), maxs, scores, None, None, "3d", False, 0.25)
    with pytest.raises(ValueError):
        nms_boxes(mins, maxs.cpu(), scores, None, None, "3d", False, 0.25)
    with pytest.raises(ValueError):
        nms_boxes(mins, maxs, scores, cls, torch.ones_like(scores, dtype=torch.bool).cpu(), "3d",
                  False, 0.25)
    with pytest.raises(ValueError):
        nms_boxes(mins.transpose(0, 1).contiguous().transpose(0, 1), maxs, scores, None, None, "3d",
                  False, 0.25)
    with pytest.raises(TypeError):
        nms_masked(torch.zeros((3, 37, 37), device=cuda, dtype=torch.float64), scores, 0.25)
    # int32 classes are widened to int64 for the kernel
    assert torch.equal(nms_boxes(mins, maxs, scores, cls.int(), None, "3d_cls", False, 0.25),
                       nms_boxes(mins, maxs, scores, cls, None, "3d_cls", False, 0.25))


@pytest.mark.parametrize("mode", ["2d", "3d", "3d_cls", "matrix"])
@pytest.mark.parametrize("case", sorted(NMS_LARGE))
def test_nms_kernel_global_path_matches_plain(cuda, case, mode):
    """Past the cluster path's 1,024 boxes (K 1,025 to 4,096): the global
    matrix's keep masks equal the plain version's on the card, one launch
    a call."""
    raw = NMS_LARGE[case]()
    t = _nms_on(cuda, raw)
    if mode == "matrix":
        iou = nms_box_overlaps(t["mins"], t["maxs"], None, "3d", False).float().contiguous()
        args, kernel = (iou, t["scores"], raw["thresh"], t["valid"]), nms_masked
        want = nms_masked_plain(*args)
    else:
        args = (t["mins"], t["maxs"], t["scores"], t["cls"] if mode == "3d_cls" else None,
                t["valid"], mode, False, raw["thresh"])
        kernel, want = nms_boxes, nms_boxes_plain(*args)
    before = kernel.launches
    got = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.dtype == torch.bool and torch.equal(got, want)


def test_nms_kernel_either_side_of_the_global_switch(cuda):
    """K = 1,024 (the cluster path) and 1,025, 1,088 and 1,089 (the global
    path, whole and ragged last words), 9 scenes, every mode."""
    for k in (NMS_MAX_BOXES, NMS_MAX_BOXES + 1, NMS_MAX_BOXES + 64, NMS_MAX_BOXES + 65):
        raw = nms_clustered(k, 9, k, 18)
        t = _nms_on(cuda, raw)
        for mode in ("2d", "3d", "3d_cls"):
            args = (t["mins"], t["maxs"], t["scores"], t["cls"], None, mode, False, 0.25)
            assert torch.equal(nms_boxes(*args), nms_boxes_plain(*args)), (k, mode)
        iou = nms_box_overlaps(t["mins"], t["maxs"], None, "3d", False).float().contiguous()
        assert torch.equal(nms_masked(iou, t["scores"], 0.25),
                           nms_masked_plain(iou, t["scores"], 0.25)), k


def test_parse_predictions_on_the_card_picks_what_the_numpy_parse_picks(cuda):
    """parse_predictions on CUDA outputs (decode and NMS on the card, one
    copy) against parse_predictions_np on the same outputs, in every
    branch: the same proposals, corners and scores equal (the scores are
    NumPy's, computed on the host from the copied logits)."""
    from iou3dmatch_tpu_torch.data.config import get_config
    from iou3dmatch_tpu_torch.eval.ap_helper import (eval_config_dict, parse_predictions,
                                                     parse_predictions_np)

    rng = np.random.RandomState(31)
    b, k, nc = 4, 128, 18
    center = rng.uniform(-2, 2, (b, k, 3))
    center[:, k // 2:] = center[:, :k // 2] + rng.normal(0, 0.05, (b, k - k // 2, 3))
    ep = {"center": center, "heading_scores": rng.randn(b, k, 1),
          "heading_residuals": rng.randn(b, k, 1) * 0.1, "size_scores": rng.randn(b, k, nc),
          "size_residuals": rng.randn(b, k, nc, 3) * 0.1, "sem_cls_scores": rng.randn(b, k, nc),
          "objectness_scores": rng.randn(b, k, 2), "iou_scores": rng.randn(b, k, nc)}
    ep = {key: v.astype(np.float32) for key, v in ep.items()}
    for use_3d, cls_nms, iou in ((False, False, False), (True, False, False), (True, True, False),
                                 (True, True, True)):
        config = dict(eval_config_dict(get_config("scannet"), use_iou_for_nms=iou),
                      use_3d_nms=use_3d, cls_nms=cls_nms)
        got = parse_predictions({key: torch.from_numpy(v).to(cuda) for key, v in ep.items()}, config)
        want = parse_predictions_np(ep, config)
        assert [len(g) for g in got] == [len(w) for w in want]
        for gs, ws in zip(got, want):
            for (gc, gbox, gscore), (wc, wbox, wscore) in zip(gs, ws):
                assert gc == wc
                np.testing.assert_array_equal(gbox, wbox)
                assert gscore == wscore


def test_stage_batch_back_to_back_is_bit_exact(cuda):
    """stage_batch on the card: 6 batches of the pretrain step's leaves
    staged back to back behind a busy stream, so that each copy is still
    queued when the next batch is packed, each equal to its host leaves bit
    for bit, every dtype kept (int64 labels stay int64)."""
    from iou3dmatch_tpu_torch.data.staging import stage_batch

    rng = np.random.RandomState(41)
    batches = [{"point_clouds": rng.randn(8, 40000, 4).astype(np.float32),
                "vote_label": rng.randn(8, 40000, 9).astype(np.float32),
                "vote_label_mask": rng.randint(0, 2, (8, 40000)).astype(np.int64),
                "size_class_label": rng.randint(0, 18, (8, 64)).astype(np.int64),
                "scale": rng.rand(8, 1, 3).astype(np.float32),
                "odd": rng.randint(0, 255, 7).astype(np.uint8)} for _ in range(6)]
    torch.cuda._sleep(200_000_000)
    staged = [stage_batch(b) for b in batches]
    for host, dev in zip(batches, staged):
        for k, v in host.items():
            assert dev[k].device.type == "cuda" and dev[k].dtype == torch.from_numpy(v).dtype, k
            assert torch.equal(dev[k].cpu(), torch.from_numpy(v)), k


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.cpu().contiguous().view(torch.int16)


@pytest.mark.parametrize("b,n,m,ns,c", [
    (8, 1024, 512, 16, 256),  # SA3: (8, 1024, 131 words) x (8, 512 * 16)
    (8, 512, 256, 16, 256),  # SA4: (8, 512, 131 words) x (8, 256 * 16)
    (2, 64, 33, 3, 256),  # GridConv's bf16 table at the tiny model's seeds
    (3, 57, 11, 7, 2),  # 4 words a row
])
def test_bitcast_gather_kernel_matches_plain(cuda, b, n, m, ns, c):
    """The bitcast-packed bf16 table through csrc/gather.cu, bit for bit
    the plain bf16 gather: xyz bits that are no bf16 numbers a pair at a
    time (-0.0, subnormal, huge), out-of-range indices clamped."""
    rng = np.random.RandomState(n + c)
    xyz = rng.uniform(-3, 3, (b, n, 3)).astype(np.float32)
    xyz[0, :3, 0] = (-0.0, 1e-40, 3e38)
    feats = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(torch.bfloat16)
    idx = torch.from_numpy(rng.randint(-3, n + 3, (b, m, ns)).astype(np.int32))
    before = group_points.launches
    got = group_points_bitcast(torch.from_numpy(xyz).to(cuda), feats.to(cuda), idx.to(cuda))
    assert group_points.launches == before + 1
    want = group_points_bitcast(torch.from_numpy(xyz), feats, idx)
    assert torch.equal(_bits(got[0].view(torch.bfloat16)), _bits(want[0].view(torch.bfloat16)))
    assert torch.equal(_bits(got[1]), _bits(want[1]))
    with pytest.raises(ValueError, match="odd"):
        group_points_bitcast(torch.from_numpy(xyz).to(cuda), feats[..., :1].to(cuda),
                             idx.to(cuda))


@pytest.mark.parametrize("b,n,m,ns", [(8, 1024, 512, 16), (8, 512, 256, 16), (2, 57, 11, 7)])
def test_bitcast_gather_backward_within_one_bf16_ulp(cuda, b, n, m, ns):
    """The features' gradient through csrc/gather_bwd.cu over the 256
    feature channels, rounded to bf16: within one bf16 ulp of the plain f32
    sum rounded to bf16 (the sum order differs); xyz gets none."""
    rng = np.random.RandomState(m)
    xyz = torch.from_numpy(rng.uniform(-3, 3, (b, n, 3)).astype(np.float32))
    feats = torch.from_numpy(rng.randn(b, n, 256).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, n, (b, m, ns)).astype(np.int32))
    g = torch.from_numpy(rng.randn(b, m, ns, 256).astype(np.float32)).to(torch.bfloat16)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        f = feats.to(dev).requires_grad_()
        before = group_points_backward.launches
        _, gf = group_points_bitcast(xyz.to(dev), f.to(torch.bfloat16), idx.to(dev))
        (gf.float() * g.to(dev).float()).sum().backward()
        assert group_points_backward.launches == before + (dev.type == "cuda")
        grads.append(f.grad.cpu())
    got, want = grads
    ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp(min=2.0 ** -126))) - 7)
    assert ((got - want).abs() <= ulp).all()


# ------------------------------------------------------------ three_interpolate

def _interp_case(rng, b, m, n, c, device):
    f = torch.from_numpy(rng.randn(b, m, c).astype(np.float32)).to(device)
    idx = rng.randint(0, m, (b, n, 3)).astype(np.int32)
    idx[:, ::3, 1] = idx[:, ::3, 0]  # a row twice in a query
    idx[:, 1::5] = idx[:, :1]  # one triple shared by many queries
    idx[:, 2::7, 0] = -3  # clamped to 0
    idx[:, 3::11, 2] = m + 4  # clamped to m - 1
    w = rng.uniform(0.01, 1.0, (b, n, 3)).astype(np.float32)
    w[:, ::4, 2] = 0.0
    w[:, 5::9, :] = 0.0  # every product zero, some -0
    return f, torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device)


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32).cpu(), b.contiguous().view(torch.int32).cpu())


def _check_interp_bwd(g, idx, w, m, launch=None):
    """The backward kernel, launched once and counted, bit for bit the plain
    version on the CPU and itself over a second run."""
    torch.full((g.shape[0], m, g.shape[2]), float("nan"), device=g.device)  # the next block, dirty
    before = three_interpolate_backward.launches
    grad = three_interpolate_backward(g, idx, w, m, launch)
    torch.cuda.synchronize()
    assert three_interpolate_backward.launches == before + 1
    want = three_interpolate_backward_plain(g.cpu(), idx.cpu(), w.cpu(), m)
    assert _same_bits(grad, want)
    assert _same_bits(three_interpolate_backward(g, idx, w, m, launch), grad)


@pytest.mark.parametrize("b,m,n,c", [(8, 256, 512, 256), (8, 512, 1024, 256), (12, 256, 512, 256),
                                     (12, 512, 1024, 256), (3, 1, 77, 256), (2, 9, 50, 5),
                                     (2, 33, 70, 3), (1, 40, 1, 4)])
def test_three_interpolate_kernel_matches_plain(cuda, b, m, n, c):
    """FP1's and FP2's shapes at 8 and 12 scenes, one known row, channels that
    take single floats: bit for bit the plain version (the sign of zeros
    included), one launch, without skip features and with them ([interpolated
    | skip], skip widths of 256, 6 and 0); the backward bit for bit the plain
    version on the CPU and the same over two runs."""
    rng = np.random.RandomState(b * m + c)
    f, idx, w = _interp_case(rng, b, m, n, c, cuda)
    for cs in (None, 256, 6, 0):
        skip = None if cs is None else torch.from_numpy(rng.randn(b, n, cs).astype(np.float32)).to(cuda)
        before = three_interpolate.launches
        got = three_interpolate(f, idx, w, skip)
        torch.cuda.synchronize()
        assert three_interpolate.launches == before + 1
        assert _same_bits(got, three_interpolate_plain(f, idx, w, skip))
    g = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(cuda)
    _check_interp_bwd(g, idx, w, m)


@pytest.mark.parametrize("b,m,n,c", [(8, 512, 1024, 256), (2, 9, 50, 5), (3, 40, 77, 8)])
def test_three_interpolate_backward_of_a_strided_cotangent(cuda, b, m, n, c):
    """The interpolated columns of FP's (B, n, C + Cs) cotangent, read in
    place: bit for bit the CPU plain version and the contiguous copy's
    backward."""
    rng = np.random.RandomState(m + n)
    _, idx, w = _interp_case(rng, b, m, n, c, cuda)
    wide = torch.from_numpy(rng.randn(b, n, c + 7).astype(np.float32)).to(cuda)
    for g in (wide[..., :c], wide[..., 7:]):
        assert not g.is_contiguous()
        _check_interp_bwd(g, idx, w, m)
        assert _same_bits(three_interpolate_backward(g, idx, w, m),
                     three_interpolate_backward(g.contiguous(), idx, w, m))


@pytest.mark.parametrize("launch", [(1, 1), (1, 4), (5, 4), (3, 8), (16, 2), (512, 1), (2, 64)])
def test_three_interpolate_backward_every_launch(cuda, launch):
    """FP2's shape at 8 scenes under launches the plan does not pick: one
    block a scene, a row a range, every piece a slice of its own."""
    rng = np.random.RandomState(sum(launch))
    _, idx, w = _interp_case(rng, 8, 512, 1024, 256, cuda)
    g = torch.from_numpy(rng.randn(8, 1024, 256).astype(np.float32)).to(cuda)
    _check_interp_bwd(g, idx, w, 512, InterpBwdLaunch(*launch))


@pytest.mark.parametrize("b,m,n,c", [(2, 512, 4000, 64), (1, 2000, 3000, 16), (2, 3, 1025, 5),
                                     (1, 1, 20000, 4)])
def test_three_interpolate_backward_many_windows_and_rows(cuda, b, m, n, c):
    """More than one window of 3,072 slots (a row's sum carried from one
    window to the next), more rows than a block holds, all slots on one
    row: bit for bit the CPU plain version."""
    rng = np.random.RandomState(n)
    _, idx, w = _interp_case(rng, b, m, n, c, cuda)
    g = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(cuda)
    _check_interp_bwd(g, idx, w, m)


def test_three_interpolate_kernel_off_alignment(cuda):
    """A contiguous table that starts 4 bytes past 16-byte alignment takes
    single floats; equal all the same."""
    rng = np.random.RandomState(3)
    flat = torch.from_numpy(rng.randn(1 + 2 * 64 * 256).astype(np.float32)).to(cuda)
    f = flat[1:].view(2, 64, 256)
    assert f.is_contiguous() and f.data_ptr() % 16
    _, idx, w = _interp_case(rng, 2, 64, 128, 256, cuda)
    assert torch.equal(three_interpolate(f, idx, w), three_interpolate_plain(f, idx, w))


def test_three_interpolate_gradient_on_the_card(cuda):
    """Through the autograd Function at FP2's shape, with FP's skip features:
    the forward kernel, then the backward kernel, each once; the features'
    gradient bit for bit the CPU plain backward of the cotangent's
    interpolated columns, the skip's those of its skip columns; no gradient
    for the weights."""
    rng = np.random.RandomState(8)
    f, idx, w = _interp_case(rng, 8, 512, 1024, 256, cuda)
    f.requires_grad_()
    w.requires_grad_()
    skip = torch.randn(8, 1024, 256, device=cuda, requires_grad=True)
    g = torch.randn(8, 1024, 512, device=cuda)
    counts = (three_interpolate.launches, three_interpolate_backward.launches)
    got_f, got_w, got_s = torch.autograd.grad(three_interpolate(f, idx, w, skip), (f, w, skip), g,
                                              allow_unused=True)
    assert (three_interpolate.launches, three_interpolate_backward.launches) == (
        counts[0] + 1, counts[1] + 1)
    assert got_w is None
    assert torch.equal(got_s, g[..., 256:])
    want = three_interpolate_backward_plain(g[..., :256].cpu(), idx.cpu(), w.detach().cpu(), 512)
    assert _same_bits(got_f, want)


def test_three_interpolate_kernel_refuses_bad_input(cuda):
    """Other dtypes and devices, by name: the features are f32 on every path
    (FP's interpolation stays f32 under bf16); nothing falls back."""
    rng = np.random.RandomState(4)
    f, idx, w = _interp_case(rng, 2, 16, 20, 8, cuda)
    for bad in (f.double(), f.to(torch.bfloat16), f.half()):
        with pytest.raises(TypeError, match="f32 features"):
            three_interpolate(bad, idx, w)
    with pytest.raises(TypeError):
        three_interpolate(f, idx.long(), w)
    with pytest.raises(TypeError):
        three_interpolate(f, idx, w.double())
    with pytest.raises(ValueError):
        three_interpolate(f, idx.cpu(), w)
    with pytest.raises(ValueError):
        three_interpolate(f.transpose(1, 2).contiguous().transpose(1, 2), idx, w)
    with pytest.raises(ValueError):
        three_interpolate(f, idx[..., :2].contiguous(), w[..., :2].contiguous())
    skip = torch.randn(2, 20, 4, device=cuda)
    with pytest.raises(TypeError):
        three_interpolate(f, idx, w, skip.double())
    with pytest.raises(ValueError):
        three_interpolate(f, idx, w, skip[:, :19])
    with pytest.raises(ValueError):
        three_interpolate(f, idx, w, skip.cpu())
    with pytest.raises(ValueError):
        three_interpolate(f, idx, w, skip.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="no backward launch"):
        three_interpolate_backward(torch.randn(2, 20, 8, device=cuda), idx, w, 16,
                                   InterpBwdLaunch(17, 1))
    with pytest.raises(ValueError, match="channels must be contiguous"):
        three_interpolate_backward(torch.randn(2, 8, 20, device=cuda).transpose(1, 2), idx, w, 16)
    with pytest.raises(ValueError):
        three_interpolate_backward(torch.randn(2, 21, 8, device=cuda), idx, w, 16)
    with pytest.raises(TypeError):
        three_interpolate_backward(torch.randn(2, 20, 8, device=cuda).double(), idx, w, 16)
