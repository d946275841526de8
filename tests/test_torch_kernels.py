"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Edge cases the full-width run in ``chip_smoke.py`` does not reach: ragged
sizes, zeroed points and ties, centers without hits, out-of-range indices,
every gather width. The file imports no JAX, so it runs on a machine with a
card and without JAX; this repository's conftest imports JAX, so run it
there as ``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``.
Without a card every test skips.
"""
import numpy as np
import pytest
import torch

from iou3dmatch_tpu_torch.ops.ball_query import (ball_query, ball_query_plain,
                                                 group_points, group_points_plain)
from iou3dmatch_tpu_torch.ops.fps import furthest_point_sample, furthest_point_sample_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("b,n,npoint", [(3, 1000, 96), (1, 33, 33), (2, 5000, 1), (1, 70000, 64)])
def test_fps_kernel_matches_plain(cuda, b, n, npoint):
    rng = np.random.RandomState(n)
    xyz = rng.randn(b, n, 3).astype(np.float32)
    xyz[:, rng.choice(n, n // 10, replace=False)] = 0.0  # never chosen
    xyz[:, 1:n // 4] = xyz[:, n // 4:2 * (n // 4) - 1]  # duplicates: distance ties
    t = torch.from_numpy(xyz).to(cuda)
    before = furthest_point_sample.launches
    got = furthest_point_sample(t, npoint)
    assert furthest_point_sample.launches == before + 1
    torch.testing.assert_close(got, furthest_point_sample_plain(t, npoint), rtol=0, atol=0)


def test_fps_kernel_all_points_invalid(cuda):
    t = torch.zeros(2, 100, 3, device=cuda)
    assert torch.equal(furthest_point_sample(t, 8), furthest_point_sample_plain(t, 8))


@pytest.mark.parametrize("radius,nsample,n,m", [(0.3, 16, 777, 50), (0.2, 64, 4000, 300),
                                                (1.0, 1, 31, 5), (5.0, 40, 33, 7)])
def test_ball_query_kernel_matches_plain(cuda, radius, nsample, n, m):
    rng = np.random.RandomState(m)
    xyz = rng.uniform(-1, 1, (2, n, 3)).astype(np.float32)
    ctr = np.concatenate([xyz[:, :m - 1], np.full((2, 1, 3), 50.0, np.float32)], axis=1)
    p, c = torch.from_numpy(xyz).to(cuda), torch.from_numpy(ctr).to(cuda)
    before = ball_query.launches
    got = ball_query(radius, nsample, p, c)
    assert ball_query.launches == before + 1
    want = ball_query_plain(radius, nsample, p, c)
    assert torch.equal(got, want)
    assert torch.equal(got[:, -1], torch.zeros_like(got[:, -1]))  # no hit -> index 0


@pytest.mark.parametrize("c", [1, 3, 4, 8, 131, 259])
def test_gather_kernel_matches_plain(cuda, c):
    rng = np.random.RandomState(c)
    tab = torch.from_numpy(rng.randn(3, 57, c).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rng.randint(-5, 62, (3, 11, 7)).astype(np.int32)).to(cuda)
    before = group_points.launches
    got = group_points(tab, idx)
    assert group_points.launches == before + 1
    assert torch.equal(got, group_points_plain(tab, idx))


def test_gather_kernel_refuses_grad_and_bad_input(cuda):
    tab = torch.randn(1, 10, 4, device=cuda)
    idx = torch.zeros(1, 2, 3, dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="training slice"):
        group_points(tab.requires_grad_(), idx)
    with pytest.raises(TypeError):
        group_points(tab.detach(), idx.long())
    with pytest.raises(ValueError):
        group_points(tab.detach().transpose(1, 2).contiguous().transpose(1, 2), idx)
