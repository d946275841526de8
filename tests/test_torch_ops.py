"""The port's ops (plain PyTorch versions) against the JAX package's ops.

Inputs are seeded NumPy arrays fed to both. FPS, ball-query and gather
indices must be identical; interpolated values agree within 1e-6 (f32
sums of three terms in another order).
"""
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

# the modules, not the functions that iou3dmatch_tpu_torch.ops re-exports
port_bq = importlib.import_module("iou3dmatch_tpu_torch.ops.ball_query")
port_fps = importlib.import_module("iou3dmatch_tpu_torch.ops.fps")
from iou3dmatch_tpu_torch.ops.interpolate import three_interpolate, three_nn  # noqa: E402
from iou3dmatch_tpu_torch.ops.sampling import gather_points  # noqa: E402

torch.set_num_threads(1)


def _cloud(seed, b, n, lo=-3.0, hi=3.0):
    return np.random.RandomState(seed).uniform(lo, hi, (b, n, 3)).astype(np.float32)


def _fps_input():
    rng = np.random.RandomState(7)
    xyz = rng.randn(2, 700, 3).astype(np.float32)
    xyz[:, rng.choice(700, 70, replace=False)] = 0.0  # never chosen
    xyz[:, 100:150] = xyz[:, 300:350]  # duplicated points: distance ties
    return xyz


def test_fps_matches_xla():
    from iou3dmatch_tpu.ops.fps import furthest_point_sample_xla

    xyz = _fps_input()
    want = np.asarray(furthest_point_sample_xla(jnp.asarray(xyz), 96))
    got = port_fps.furthest_point_sample_plain(torch.from_numpy(xyz), 96)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


def test_fps_matches_pallas_interpret():
    from iou3dmatch_tpu.ops.fps_pallas import furthest_point_sample_pallas

    xyz = _fps_input()
    want = np.asarray(furthest_point_sample_pallas(jnp.asarray(xyz), 96, interpret=True))
    got = port_fps.furthest_point_sample_plain(torch.from_numpy(xyz), 96)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fps_wrapper_takes_plain_version_on_cpu_without_counting():
    xyz = torch.from_numpy(_fps_input())
    before = port_fps.furthest_point_sample.launches
    got = port_fps.furthest_point_sample(xyz, 32)
    assert torch.equal(got, port_fps.furthest_point_sample_plain(xyz, 32))
    assert port_fps.furthest_point_sample.launches == before


# (radius, nsample, points, centers): the model path's layers, shrunk
BQ_CASES = [(0.2, 64, 4096, 256), (0.4, 32, 1024, 128), (0.8, 16, 512, 64),
            (1.2, 16, 256, 32), (0.3, 16, 1024, 128)]


@pytest.mark.parametrize("radius,nsample,n,m", BQ_CASES)
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "approx"])
def test_ball_query_matches_jax(radius, nsample, n, m, exact):
    """Identical index arrays against both JAX paths. The JAX side computes
    d^2 by the matmul identity, the port directly, so the two may only
    differ for a point within an ulp of the radius; these seeded clouds
    have none."""
    from iou3dmatch_tpu.ops.ball_query import ball_query

    xyz = _cloud(n + m, 2, n)
    ctr = xyz[:, :m].copy()
    want = np.asarray(ball_query(radius, nsample, jnp.asarray(xyz), jnp.asarray(ctr),
                                 exact=exact))
    got = port_bq.ball_query_plain(radius, nsample, torch.from_numpy(xyz), torch.from_numpy(ctr))
    np.testing.assert_array_equal(got.numpy(), want)


def test_ball_query_matches_oracle_with_misses_and_overflow():
    from tests.oracles import ball_query_oracle

    xyz = _cloud(3, 1, 300, -1.0, 1.0)
    ctr = np.concatenate([xyz[:, :20], np.full((1, 1, 3), 9.0, np.float32)], axis=1)
    for radius, ns in [(0.3, 8), (0.6, 40), (5.0, 400)]:
        got = port_bq.ball_query_plain(radius, ns, torch.from_numpy(xyz), torch.from_numpy(ctr))
        np.testing.assert_array_equal(got[0].numpy(), ball_query_oracle(radius, ns, xyz[0], ctr[0]))
        assert (got[0, -1] == 0).all()  # the far center has no hit


@pytest.mark.parametrize("c", [4, 131])
def test_group_points_matches_pallas_gather(c):
    """Out-of-range indices clamp to [0, N-1] on both sides."""
    from iou3dmatch_tpu.ops.ball_query import group_points
    from iou3dmatch_tpu.ops.gather_pallas import gather_rows_vmem

    rng = np.random.RandomState(c)
    tab = rng.randn(3, 40, c).astype(np.float32)
    idx = rng.randint(-6, 46, (3, 8, 8)).astype(np.int32)
    got = port_bq.group_points(torch.from_numpy(tab), torch.from_numpy(idx)).numpy()
    pal = np.asarray(gather_rows_vmem(jnp.asarray(tab), jnp.asarray(idx.reshape(3, 64)), True))
    np.testing.assert_array_equal(got.reshape(3, 64, c), pal)
    np.testing.assert_array_equal(
        got, np.asarray(group_points(jnp.asarray(tab), jnp.asarray(idx))))


def test_gather_points_matches_jax():
    from iou3dmatch_tpu.ops.sampling import gather_points as jax_gather_points

    rng = np.random.RandomState(1)
    feats = rng.randn(2, 30, 5).astype(np.float32)
    idx = rng.randint(-3, 33, (2, 12)).astype(np.int32)
    np.testing.assert_array_equal(
        gather_points(torch.from_numpy(feats), torch.from_numpy(idx)).numpy(),
        np.asarray(jax_gather_points(jnp.asarray(feats), jnp.asarray(idx))))


def test_three_nn_and_interpolate_match_jax():
    from iou3dmatch_tpu.ops.interpolate import three_interpolate as jax_interp
    from iou3dmatch_tpu.ops.interpolate import three_nn as jax_three_nn

    rng = np.random.RandomState(2)
    unknown = rng.uniform(-2, 2, (2, 300, 3)).astype(np.float32)
    known = rng.uniform(-2, 2, (2, 64, 3)).astype(np.float32)
    known[:, 10] = known[:, 20]  # a tie: the lower index wins on both sides
    feats = rng.randn(2, 64, 7).astype(np.float32)
    jd, ji = jax_three_nn(jnp.asarray(unknown), jnp.asarray(known))
    d, i = three_nn(torch.from_numpy(unknown), torch.from_numpy(known))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    w = rng.uniform(0, 1, (2, 300, 3)).astype(np.float32)
    np.testing.assert_allclose(
        three_interpolate(torch.from_numpy(feats), i, torch.from_numpy(w)).numpy(),
        np.asarray(jax_interp(jnp.asarray(feats), ji, jnp.asarray(w))), rtol=0, atol=1e-6)


def test_wrappers_take_plain_versions_on_cpu_without_counting():
    xyz = torch.from_numpy(_cloud(5, 2, 200))
    ctr = xyz[:, :16].contiguous()
    counts = (port_bq.ball_query.launches, port_bq.group_points.launches)
    idx = port_bq.ball_query(0.5, 8, xyz, ctr)
    assert torch.equal(idx, port_bq.ball_query_plain(0.5, 8, xyz, ctr))
    assert torch.equal(port_bq.group_points(xyz, idx), port_bq.group_points_plain(xyz, idx))
    assert (port_bq.ball_query.launches, port_bq.group_points.launches) == counts
