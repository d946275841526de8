"""The rotated IoU's reject rule, ``geometry/iou3d.py::pairs_apart``, on the
CPU, against the candidate vertices and the JAX package.

``csrc/iou3d.cu`` writes 0 for every pair the rule rejects and never
computes it, so the rule must be exact: it never rejects a pair that has a
candidate vertex (a BEV overlap can only come from those), and where it
rejects, the JAX package's ``boxes_iou3d_paired_rows``, ``boxes_iou_bev``
and ``boxes_overlap_bev`` and the port's ``box_pairs_plain`` all give
exactly 0. Inputs: seeded random boxes, rotated and axis-aligned, and pairs
whose corners' extents are 0 to 2e-2 apart along x, y, a diagonal and z,
across the reach of the 1e-2 containment margin (``tests/iou_cases.py``).
Where nothing is rejected, the plain version agrees with JAX within atol
1e-5, as in ``tests/test_torch_train.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from iou_cases import gap_pairs, random_boxes  # noqa: E402

from iou3dmatch_tpu_torch.geometry.iou3d import (MODES, REACH, REL_REACH,  # noqa: E402
                                                 bev_candidates, box_pairs_plain, pairs_apart)

CASES = ["random_rotated", "random_axis_aligned", "gaps_axis_aligned", "gaps_rotated"]


def _case(name):
    """(a (N, 7), b (M, 7), the gap labels of the pairs (i, i) or None)."""
    if name.startswith("gaps"):
        return gap_pairs(len(name), name == "gaps_rotated")
    rng = np.random.RandomState(len(name))
    rotated = name == "random_rotated"
    return random_boxes(rng, 48, rotated), random_boxes(rng, 40, rotated), None


def _jax(a, b, mode):
    """The JAX package's all-pairs (N, M) result for ``mode``."""
    from iou3dmatch_tpu.geometry import iou3d as jiou

    ja, jb = jnp.asarray(a), jnp.asarray(b)
    if mode == "iou3d":
        return np.asarray(jiou.boxes_iou3d_paired_rows(ja[None], jb[None]))[0]
    if mode == "iou_bev":
        return np.asarray(jiou.boxes_iou_bev(ja, jb))
    return np.asarray(jiou.boxes_overlap_bev(ja, jb))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("case", CASES)
def test_pairs_apart_is_exact(case, mode):
    a, b, labels = _case(case)
    ta, tb = torch.from_numpy(a)[:, None], torch.from_numpy(b)[None]
    apart = pairs_apart(ta, tb, mode)
    cnt = bev_candidates(*torch.broadcast_tensors(ta, tb))[2].sum(-1)
    # no pair with a candidate vertex is rejected for its x or y extents
    assert not (cnt[pairs_apart(ta, tb, "overlap_bev")] > 0).any()
    want = _jax(a, b, mode)
    got = box_pairs_plain(ta[:, 0][None], tb[0][None], mode)[0].numpy()
    assert (want[apart.numpy()] == 0).all() and (got[apart.numpy()] == 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert apart.any() and (~apart).any()  # the rule is not vacuous here
    if labels is None:
        return
    # the designed pairs (i, i): past the reach along x or y they are
    # rejected; a corner within the margin's reach along the diagonal is a
    # candidate, and is kept
    for i, (gap, d) in enumerate(labels):
        if d in ("x", "y") and gap >= 2e-2:
            assert apart[i, i], (gap, d)
        if gap == 0.0 and d != "z":
            assert not apart[i, i], (gap, d)
        if d == "diagonal" and 0 < gap < 1.4e-2 and case == "gaps_axis_aligned":
            assert cnt[i, i] > 0 and not apart[i, i], (gap, d)
        if d == "z" and mode == "iou3d" and gap > 0:
            assert apart[i, i], (gap, d)  # apart in z: no volume in common


def test_reject_constants_match_the_kernel():
    """csrc/iou3d.cu grows each box by half of REACH and by REL_REACH of its
    coordinates, as pairs_apart does."""
    src = (Path(__file__).resolve().parents[1] / "iou3dmatch_tpu_torch" / "csrc"
           / "iou3d.cu").read_text()
    half = float(re.search(r"constexpr float kHalfReach = ([0-9.e-]+)f;", src)[1])
    rel = float(re.search(r"constexpr float kRelReach = ([0-9.e-]+)f;", src)[1])
    assert (half, rel) == (0.5 * REACH, REL_REACH)
    assert REACH > np.sqrt(2.0) * 1e-2  # the containment margin's reach along x or y
