"""The kernels' launch-shape rules (``iou3dmatch_tpu_torch/ops/fps.py`` and
``ops/ball_query.py``).

``fps_launch_plan`` is a pure function of (B, N, the card's SM count, its
``cudaOccupancyMaxActiveClusters`` answers), so its invariants are checked
here on the CPU against answers an H100 may give: 132 SMs, the answers an
H100 80GB HBM3 gave for the planned candidates at 40,000 points, and
GPC layouts that hold fewer clusters. ``ball_query_plan`` is a pure
function of (B, m, N, the SM count).
"""
import re
from pathlib import Path

import pytest

from iou3dmatch_tpu_torch.ops.ball_query import (BQ_CENTERS, MAX_TILE, WARPS, BallQueryLaunch,
                                                 ball_query_plan)
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


def test_ball_query_instantiations_match_the_source():
    """BQ_CENTERS is what csrc/ball_query.cu dispatches on, and its blocks
    are WARPS warps."""
    src = (Path(__file__).resolve().parents[1] / "iou3dmatch_tpu_torch" / "csrc"
           / "ball_query.cu").read_text()
    cases = tuple(int(c) for c in re.findall(r"case (\d+): err = launch<\1>", src))
    assert cases == BQ_CENTERS
    assert f"constexpr int kWarps = {WARPS};" in src
