"""Group-Free-3D on the card: the hand kernels at the widths this model
gives them, and the whole forward at the deployment's size against the
plain reference (``reference/groupfree.py``) computed in blocks.

- The grouping gather over tables 259, 515 and 291 wide (SA2's, SA3's and
  SA4's [xyz | features] of the 2x backbone, GridConv's [xyz | 288-d
  seeds]) bit for bit the plain gather, and its backward at SA2-SA4's
  shapes within 1e-5 of the summed magnitudes of an f64 sum;
  ``three_interpolate`` at FP1's and FP2's shapes (512 channels beside 512
  skip channels) bit for bit the plain version, its backward bit for bit
  the plain version on the CPU; ``three_nn`` at GridConv's 2 x 256 boxes
  over the 1,024 seeds equal to the plain version.
- L12-O256-w2x in eval mode on 8 scenes of 50,000 points (BatchNorm's
  running statistics taken from the batch first), against the reference
  run a scene at a time (eval-mode BatchNorm keeps the scenes apart). Both
  run float32 with TF32 off; they differ in the order of the same sums (a
  batch of 8 against 1 picks other GEMM kernels), so two seeds whose
  objectness lies within round-off can swap places in the KPS ranking.
  Inside the top 256 that only reorders the queries, which attend to each
  other without an order, so they are compared in their seeds' order; at
  its edge it changes which seed is picked. The scenes whose picks agree,
  at least 7 of the 8, hold every stage's heads within 1e-4 of the head's
  largest magnitude, the bound the CPU tests set, plus 1e-6: a head whose
  outputs cancel to 1e-3 keeps the round-off of its O(1) inputs' sums (2.5e-7
  measured). The IoU logits are held so against the reference's GridConv
  on the port's boxes: on its own boxes, a box whose size differs by that
  round-off can move a lattice point across the midpoint of two seeds, and
  its query reads other logits (1-3 of a scene's 256 on the card).

The file imports no JAX; run it on the card as ``python -m pytest
--noconftest -m gpu tests/test_torch_groupfree_card.py``. Without a card
every test skips.
"""
import numpy as np
import pytest
import torch

from iou3dmatch_tpu_torch.data.config import get_config
from iou3dmatch_tpu_torch.data.synthetic import synthetic_scene
from iou3dmatch_tpu_torch.models.factory import build_groupfree
from iou3dmatch_tpu_torch.models.mlp import set_bn_momentum
from iou3dmatch_tpu_torch.ops.ball_query import (group_points, group_points_backward,
                                                 group_points_plain)
from iou3dmatch_tpu_torch.ops.interpolate import (three_interpolate, three_interpolate_backward,
                                                  three_interpolate_backward_plain,
                                                  three_interpolate_plain, three_nn,
                                                  three_nn_plain)
from reference import groupfree as ref

pytestmark = pytest.mark.gpu
HEADS_RTOL = 1e-4
HEADS_ATOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same_bits(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.int32).cpu(), b.contiguous().view(torch.int32).cpu())


# (table rows, width, queries a scene): SA2's, SA3's and SA4's grouping of
# the 2x backbone, and GridConv's gather of 2 x 256 boxes' 64 lattice points
# x 3 neighbours from the 1,024 seeds
GATHERS = [(2048, 259, 1024 * 32), (1024, 515, 512 * 16), (512, 515, 256 * 16),
           (1024, 291, 2 * 256 * 64 * 3)]


@pytest.mark.parametrize("n,c,q", GATHERS)
def test_gather_and_its_backward_at_groupfree_widths(cuda, n, c, q):
    rng = np.random.RandomState(c + n)
    tab = torch.from_numpy(rng.randn(8, n, c).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rng.randint(0, n, (8, q // 16, 16)).astype(np.int32)).to(cuda)
    assert torch.equal(group_points(tab, idx), group_points_plain(tab, idx))
    if c == 291:  # GridConv's seeds are detached: no backward
        return
    g = torch.from_numpy(rng.randn(8, q // 16, 16, c).astype(np.float32)).to(cuda)
    got = group_points_backward(g, idx, n).double()
    rows = (idx.long() + n * torch.arange(8, device=cuda)[:, None, None]).reshape(-1)
    want = torch.zeros(8 * n, c, dtype=torch.float64, device=cuda)
    mag = torch.zeros_like(want)
    want.index_add_(0, rows, g.reshape(-1, c).double())
    mag.index_add_(0, rows, g.reshape(-1, c).double().abs())
    assert ((got.reshape(-1, c) - want).abs() <= 1e-5 * mag).all()


@pytest.mark.parametrize("m,n", [(256, 512), (512, 1024)])
def test_three_interpolate_at_groupfree_fp_shapes(cuda, m, n):
    rng = np.random.RandomState(m)
    f = torch.from_numpy(rng.randn(8, m, 512).astype(np.float32)).to(cuda)
    skip = torch.from_numpy(rng.randn(8, n, 512).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rng.randint(0, m, (8, n, 3)).astype(np.int32)).to(cuda)
    w = torch.from_numpy(rng.uniform(0.01, 1.0, (8, n, 3)).astype(np.float32)).to(cuda)
    assert _same_bits(three_interpolate(f, idx, w, skip), three_interpolate_plain(f, idx, w, skip))
    g = torch.from_numpy(rng.randn(8, n, 512).astype(np.float32)).to(cuda)
    assert _same_bits(three_interpolate_backward(g, idx, w, m),
                      three_interpolate_backward_plain(g.cpu(), idx.cpu(), w.cpu(), m))


def test_three_nn_at_groupfree_grid_conv_shape(cuda):
    rng = np.random.RandomState(0)
    known = torch.from_numpy(rng.uniform(-4, 4, (8, 1024, 3)).astype(np.float32)).to(cuda)
    unknown = torch.from_numpy(rng.uniform(-4, 4, (8, 2 * 256 * 64, 3)).astype(np.float32)).to(cuda)
    (d, i), (dp, ip) = three_nn(unknown, known), three_nn_plain(unknown, known)
    assert torch.equal(i, ip) and torch.equal(d, dp)


def test_forward_at_full_size_matches_the_reference_in_blocks(cuda):
    model, cfg = build_groupfree(num_decoder_layers=12, width=2, num_proposal=256, device=cuda,
                                 generator=torch.Generator().manual_seed(11))
    rng = np.random.RandomState(0)
    pc = torch.from_numpy(np.stack([synthetic_scene(rng, get_config("scannet"), 50000,
                                                    num_boxes=12)["point_clouds"]
                                    for _ in range(8)])).to(cuda)
    with torch.no_grad():
        # BatchNorm's running statistics those of this batch, as a trained
        # model's are of its data (no dropout: no generator)
        model.train()
        set_bn_momentum(model, 1.0)
        model(pc)
        model.eval()
        r = ref.GroupFree(cfg.mean_size_arr, num_proposal=256, num_decoder_layers=12, width=2)
        r.load_state_dict(model.state_dict())
        r = r.to(cuda).eval()
        ep = model(pc)
        same = 0
        for i in range(8):
            out = r(pc[i:i + 1])
            # the queries attend to each other without an order: compare them
            # in the order of their seeds
            got, want = ep["query_points_sample_inds"][i].long(), out["query_inds"][0]
            pg, pw = got.argsort(), want.argsort()
            if not torch.equal(got[pg], want[pw]):
                continue
            same += 1
            for prefix in r.prefixes():
                for head in ("center", "objectness_scores", "sem_cls_scores", "size_scores",
                             "size_residuals"):
                    a, b = ep[prefix + head][i][pg], out[prefix + head][0][pw]
                    tol = HEADS_RTOL * b.abs().max() + HEADS_ATOL
                    assert (a - b).abs().max() <= tol, (i, prefix + head)
            # GridConv on the port's boxes, over the reference's seeds
            b = r.grid_conv(ep["center"][i:i + 1], ep["size"][i:i + 1], out["seed_xyz"],
                            out["seed_features"])[0]
            a = ep["iou_scores"][i]
            assert (a - b).abs().max() <= HEADS_RTOL * b.abs().max() + HEADS_ATOL
    assert same >= 7
