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
tile, and pairs across the reach of the containment margin. The file
imports no JAX, so it runs on a machine with a card and without JAX; this
repository's conftest imports JAX, so run it there as ``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``.
Without a card every test skips.
"""
import numpy as np
import pytest
import torch
from iou_cases import gap_pairs, random_boxes

from iou3dmatch_tpu_torch.geometry.iou3d import (MODES, box_pairs, box_pairs_plain, boxes_iou3d,
                                                 pairs_apart)
from iou3dmatch_tpu_torch.ops.ball_query import (BQ_CENTERS, BallQueryLaunch, GatherBwdLaunch,
                                                 ball_query, ball_query_plain, group_points,
                                                 group_points_backward, group_points_plain)
from iou3dmatch_tpu_torch.ops.fps import (GLOBAL, REG_PPTS, SHARED, STREAM_THREADS, FpsLaunch,
                                          fps_plan, fps_variant, furthest_point_sample,
                                          furthest_point_sample_plain, max_active_clusters)

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
