"""The kernels' launch-shape rules (``iou3dmatch_tpu_torch/ops/fps.py`` and
``ops/ball_query.py``).

``fps_launch_plan`` is a pure function of (B, N, the card's SM count, its
``cudaOccupancyMaxActiveClusters`` answers), so its invariants are checked
here on the CPU against answers an H100 may give: 132 SMs, the answers an
H100 80GB HBM3 gave for the planned candidates at 40,000 points, and
GPC layouts that hold fewer clusters. ``ball_query_plan`` is a pure
function of (B, m, N, the SM count), and ``gather_bwd_plan`` of (B, U, N,
C, the SM count); the runs the gather backward's list kernel cuts from a scene's
slots are emulated here from its rule.
"""
import re
from pathlib import Path

import numpy as np
import pytest

from iou3dmatch_tpu_torch.ops.ball_query import (BQ_CENTERS, GBWD_BLOCKS_PER_SM, GBWD_CHUNKS,
                                                 GBWD_LIST_ROWS, GBWD_RUN_WARPS, MAX_TILE, WARPS,
                                                 BallQueryLaunch, ball_query_plan, gather_bwd_plan,
                                                 gather_bwd_splits)
from iou3dmatch_tpu_torch.ops.fps import (FAST_CLUSTER, GLOBAL, MAX_CLUSTER, PLAN_THREADS,
                                          REG_PPTS, SHARED, SHARED_MAX_POINTS, STREAM_THREADS,
                                          FpsLaunch, fps_candidates, fps_launch_plan,
                                          fps_preference, fps_variant)

N_SM = 132
ANSWERS = {
    "h100_measured": {16: 21, 8: 30, 4: 30, 2: 66, 1: 132},
    "h100_16x8": {16: 8, 8: 16, 4: 33, 2: 66, 1: 132},
    "h100_16x7": {16: 7, 8: 16, 4: 32, 2: 66, 1: 132},
    "no_large_clusters": {16: 0, 8: 0, 4: 33, 2: 66, 1: 132},
}
SHAPES = [(8, 40000), (24, 40000), (1, 40000), (12, 20000), (8, 2048), (1, 33), (2, 1),
          (64, 40000), (200, 40000), (2, 200000), (1, 300000), (3, 1001)]


def _check_holds(launch: FpsLaunch, n: int):
    assert launch.cluster * launch.share >= n  # every point has an owner
    assert launch.share == -(-n // launch.cluster)
    # blocks past the last point own nothing and offer the padding candidate;
    # at least block 0 owns a point
    assert 1 <= launch.share <= n
    if launch.ppt > 0:
        assert launch.ppt in REG_PPTS[launch.threads]
        assert launch.share <= launch.ppt * launch.threads
    elif launch.ppt == SHARED:
        assert launch.threads == STREAM_THREADS and launch.share <= SHARED_MAX_POINTS
    else:
        assert launch.ppt == GLOBAL and launch.threads == STREAM_THREADS


@pytest.mark.parametrize("answers", sorted(ANSWERS))
def test_fps_launch_plan_invariants(answers):
    ans = ANSWERS[answers]
    for b, n in SHAPES:
        launch = fps_launch_plan(b, n, N_SM, ans)
        s = launch.cluster
        assert s & (s - 1) == 0 and 1 <= s <= MAX_CLUSTER, (b, n)
        assert launch in fps_candidates(n)
        _check_holds(launch, n)
        if s > 1:  # a cluster is only taken when the whole batch runs in one wave
            assert b * s <= N_SM and ans[s] >= b, (b, n)
        # no candidate that also runs in one wave is preferred
        for c in fps_candidates(n):
            if fps_preference(c) > fps_preference(launch):
                assert b * c.cluster > N_SM or ans[c.cluster] < b, (b, n, c)
        if launch.variant == "registers":
            assert s <= FAST_CLUSTER and launch.threads in PLAN_THREADS, (b, n)


@pytest.mark.parametrize("b", [8, 24])
def test_fps_launch_plan_fills_the_card_in_one_wave(b):
    """The serving batch (8 scenes) and the SSL step's shared SA1 FPS (24
    clouds) at 40,000 points: B clusters of S blocks, all resident at once,
    the share on chip."""
    for answers, ans in ANSWERS.items():
        launch = fps_launch_plan(b, 40000, N_SM, ans)
        s = launch.cluster
        assert s == (4 if b == 24 or answers == "no_large_clusters" else 8), answers
        assert b <= ans[s] and b * s <= N_SM
        assert launch.variant == "registers"


def test_fps_variant_takes_the_fewest_threads_that_hold_the_share():
    for n, cluster, threads in [
            (40000, 8, 128),  # the serving batch: 5,000 points a block, 40 a thread
            (40000, 4, 256),  # the SSL step's 24 clouds: 10,000 a block, too many for 128
            (40000, 16, 128), (1001, 16, 128), (20000, 2, 256), (26000, 2, None)]:
        launch = fps_variant(n, cluster)
        if threads is None:
            assert launch.variant == "shared"
        else:
            assert (launch.variant, launch.threads) == ("registers", threads)
            for t in PLAN_THREADS:
                if t < threads:
                    assert fps_variant(n, cluster, t).variant != "registers"


@pytest.mark.parametrize("threads", sorted(REG_PPTS))
def test_fps_variant_holds_its_share(threads):
    for n in (1, 20, 1001, 40000, 200000, 300000):
        for cluster in (1, 2, 4, 8, 16):
            launch = fps_variant(n, cluster, threads)
            _check_holds(launch, n)
            if launch.ppt > 0:
                assert launch.threads == threads
            else:  # the asked block size cannot hold the share in registers
                assert launch.share > threads * REG_PPTS[threads][-1]


def test_fps_variant_sweep_shapes():
    """The sweep at the serving shape runs every block size in registers."""
    for cluster in (8, 16):
        for threads in sorted(REG_PPTS):
            assert fps_variant(40000, cluster, threads).variant == "registers"


def test_fps_launch_plan_keeps_large_shares_on_chip():
    """Past what 8 blocks hold in registers, 16 blocks that keep the share in
    shared memory beat 8 that stream it."""
    launch = fps_launch_plan(2, 200000, N_SM, ANSWERS["h100_measured"])
    assert (launch.cluster, launch.variant) == (16, "shared")
    launch = fps_launch_plan(1, 300000, N_SM, ANSWERS["h100_measured"])
    assert (launch.cluster, launch.variant) == (16, "global")


def test_fps_variant_prefers_registers_then_shared_then_streaming():
    assert fps_variant(40000, 16).variant == "registers"
    assert fps_variant(10240, 1).variant == "registers"  # 256 threads x 40 points
    assert fps_variant(10241, 1).variant == "shared"
    assert fps_variant(200000, 16).variant == "shared"
    assert fps_variant(300000, 16).variant == "global"
    assert fps_variant(40000, 1).variant == "global"


BQ_SHAPES = [(b, m, n) for b in (1, 2, 8, 12, 24) for m in (1, 7, 64, 128, 256, 300, 512, 1024, 2048)
             for n in (1, 20, 512, 1000, 40000)]


def test_ball_query_plan_covers_every_center():
    for n_sm in (N_SM, 114, 78, 1):
        for b, m, n in BQ_SHAPES:
            launch = ball_query_plan(b, m, n, n_sm)
            assert launch.centers in BQ_CENTERS
            assert launch.tile % 32 == 0 and 32 <= launch.tile <= MAX_TILE
            assert launch.tile >= min(n, MAX_TILE)  # a cloud that fits takes one tile
            blocks = launch.blocks(b, m)
            assert blocks % b == 0 and (blocks // b) * launch.group >= m > (blocks // b - 1) * launch.group
            # the largest C that still gives every SM a block
            if launch.centers > 1:
                assert blocks >= n_sm, (b, m, n, n_sm)
            bigger = [c for c in BQ_CENTERS if c > launch.centers]
            if bigger:
                assert BallQueryLaunch(bigger[0], launch.tile).blocks(b, m) < n_sm


def test_ball_query_plan_at_the_forward_shapes():
    """The plans PERF.md records: the five ball queries of the serving
    forward at B = 8 and SA1 at the SSL forward's 12 clouds, on 132 SMs."""
    for (b, m, n), want in [
            ((8, 2048, 40000), (8, 2048)),  # SA1: 256 blocks
            ((12, 2048, 40000), (8, 2048)),  # SA1 of the SSL forward: 384 blocks
            ((8, 1024, 2048), (4, 2048)),  # SA2
            ((8, 512, 1024), (2, 1024)),  # SA3
            ((8, 256, 512), (1, 512)),  # SA4
            ((8, 128, 1024), (1, 1024))]:  # vote aggregation: 128 blocks, 4 SMs idle
        assert tuple(ball_query_plan(b, m, n, N_SM)) == want, (b, m, n)


def _gbwd_runs(idx, n, runs):
    """The runs csrc/gather_bwd.cu's list kernel cuts, emulated: run j's
    first row is the first whose weighted start (where its sorted slots
    start, plus its index) is at least ceil(j (U + N) / runs), the last run
    ends at N; -> (first rows, first sorted slots, the rows' slot counts)."""
    u = idx.size
    counts = np.bincount(np.clip(idx, 0, n - 1), minlength=n)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    weighted = start + np.arange(n)
    rows = [int(np.searchsorted(weighted, -(-j * (u + n) // runs), side="left"))
            for j in range(runs)] + [n]
    return rows, [int(start[r]) if r < n else u for r in rows], counts


def _gbwd_indices(case, rng):
    """(indices, N): a ball query's slots, first hits on low rows and balls
    with few hits repeating theirs; one row named by every slot; a one-row
    table; more rows than slots; more rows than a list window of 8,192; and
    indices out of range."""
    if case == "balls":
        first = np.minimum(rng.geometric(1 / 300, 1024), 2047)
        idx = np.repeat(first, 32).reshape(1024, 32)
        hits = rng.randint(1, 8, 1024)
        for i, h in enumerate(hits):
            idx[i, 1:h] = rng.randint(0, 2048, h - 1)
        return idx.ravel(), 2048
    if case == "one_row_named":
        return np.full(8192, 7), 1024
    if case == "one_row_table":
        return rng.randint(0, 3, 4096), 1
    if case == "wide":
        return rng.randint(0, 40_000, 4096), 40_000
    if case == "windows":
        return rng.randint(0, 20_000, 30_000), 20_000
    return rng.randint(-5, 262, 2000), 257  # out of range: clamped


@pytest.mark.parametrize("case", ["balls", "one_row_named", "one_row_table", "wide", "windows",
                                  "out_of_range"])
def test_gather_bwd_runs_cover_every_row_and_slot_once(case):
    idx, n = _gbwd_indices(case, np.random.RandomState(len(case)))
    u = idx.size
    for parts in (1, 3, 66, gather_bwd_plan(8, u, n, 131, N_SM).parts):
        runs = GBWD_RUN_WARPS * parts
        rows, slots, counts = _gbwd_runs(idx, n, runs)
        assert rows[0] == 0 and rows[-1] == n and slots[0] == 0 and slots[-1] == u
        assert all(a <= b for a, b in zip(rows, rows[1:]))  # runs tile [0, N) in order
        for j in range(runs):
            assert slots[j + 1] - slots[j] == counts[rows[j]:rows[j + 1]].sum(), (case, parts, j)
            # about a share of the work, a row's write weighing a slot's add:
            # at most a share and one row more
            work = slots[j + 1] - slots[j] + rows[j + 1] - rows[j]
            assert work <= -(-(u + n) // runs) + counts.max() + 1


def test_gather_bwd_channel_groups_cover_every_channel_once():
    """The sum warps of a run, one for each group of GBWD_CHUNKS 32-channel
    chunks, lane l on channel 32 q + l of chunk q: C = 1, 3, 131, 259 and
    900."""
    for c, splits in ((1, 1), (3, 1), (131, 2), (259, 3), (900, 10)):
        assert gather_bwd_splits(c) == splits
        seen = np.zeros(c, int)
        for split in range(splits):
            for q in range(GBWD_CHUNKS):
                for lane in range(32):
                    ch = 32 * (split * GBWD_CHUNKS + q) + lane
                    if ch < c:
                        seen[ch] += 1
        assert (seen == 1).all(), c


def test_gather_bwd_plan_at_the_step_shapes():
    """GBWD_BLOCKS_PER_SM sum blocks an SM and a list block an SM, in one
    wave, at the pretrain step's four shapes and SA2 of the SSL student's 12
    scenes."""
    for b, u, n, c, parts in [(8, 32768, 2048, 131, 25), (8, 8192, 1024, 259, 17),
                              (8, 4096, 512, 259, 17), (8, 2048, 1024, 259, 17),
                              (12, 32768, 2048, 131, 17)]:
        launch = gather_bwd_plan(b, u, n, c, N_SM)
        assert launch.parts == parts, (b, u, c)
        assert GBWD_BLOCKS_PER_SM * N_SM <= launch.blocks(b, c) < (GBWD_BLOCKS_PER_SM + 1) * N_SM
        assert launch.lists == N_SM // b  # a list block an SM, in one wave


def test_gather_bwd_plan_edge_shapes():
    assert gather_bwd_plan(1, 1, 1, 1, N_SM) == (1, 1)  # one slot, one row
    assert gather_bwd_plan(1, 4096, 64, 4, N_SM) == (396, 64)  # 3,168 runs; a list block a row
    assert gather_bwd_plan(1, 1000, 64, 4, N_SM) == (125, 64)  # as many runs as slots
    assert gather_bwd_plan(200, 4096, 64, 4, N_SM) == (2, 1)  # more scenes than SMs
    assert gather_bwd_plan(2, 40_000, 40_000, 4, N_SM) == (198, 66)
    assert gather_bwd_plan(1, 4096, 1_000_000, 4, N_SM).lists == 132  # 7,576 rows a list block
    assert gather_bwd_plan(1, 4096, 2_000_000, 4, N_SM).lists == 245  # 8,164 rows: over one an SM
    for b in (1, 2, 8, 12, 24, 64):
        for u in (1, 7, 32, 2048, 40_000, 300_000):
            for n, c in ((1, 1), (57, 131), (2048, 900), (100_000, 3)):
                launch = gather_bwd_plan(b, u, n, c, N_SM)
                assert launch.parts >= 1
                assert launch.scratch_ints(b, u) == 2 * b * (u + launch.runs + 1)
                assert launch.parts == 1 or launch.runs <= u  # never more runs than slots
                assert 1 <= launch.lists <= n and -(-n // launch.lists) <= GBWD_LIST_ROWS


def test_gather_bwd_constants_match_the_source():
    """The sum kernel's warps and chunks, and the scratch layout of
    csrc/gather_bwd.cu, are the plan's."""
    src = (Path(__file__).resolve().parents[1] / "iou3dmatch_tpu_torch" / "csrc"
           / "gather_bwd.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kSumThreads"] // 32 == GBWD_RUN_WARPS
    assert "constexpr int kSumWarps = kSumThreads / 32;" in src
    assert consts["kChunks"] == GBWD_CHUNKS and consts["kListRows"] == GBWD_LIST_ROWS
    assert "(n + lists - 1) / lists > kListRows" in src
    assert "const int splits = ((c + 31) / 32 + kChunks - 1) / kChunks;" in src
    assert "int* went = wrow + static_cast<long long>(b) * (runs + 1);" in src
    assert "const int runs = parts * kSumWarps;" in src


def test_ball_query_instantiations_match_the_source():
    """BQ_CENTERS is what csrc/ball_query.cu dispatches on, and its blocks
    are WARPS warps."""
    src = (Path(__file__).resolve().parents[1] / "iou3dmatch_tpu_torch" / "csrc"
           / "ball_query.cu").read_text()
    cases = tuple(int(c) for c in re.findall(r"case (\d+): err = launch<\1>", src))
    assert cases == BQ_CENTERS
    assert f"constexpr int kWarps = {WARPS};" in src
