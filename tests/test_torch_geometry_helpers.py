"""The geometry helpers no path calls, against the JAX package's.

The NumPy helpers (``get_iou``, ``box2d_iou``, ``box3d_iou_batch_np``,
``corners3d_to_parameter``, ``check_valid_corners3d``, and ``rotz``,
``roty_np``, ``get_3d_box_depth_np`` which the port's geometry package now
exports too) must give equal results; the tensor ones
(``box3d_iou_axis_aligned``, ``nn_distance_exclude_self``,
``nn_distance_exclude_self_with_cls``, ``nn_distance_inbox``) equal indices
and values within 1e-6 (the same f32 operations; XLA may fuse them). Seeded
inputs, with the cases of ``tests/test_geometry.py:130-150, 253-350``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from iou3dmatch_tpu_torch import geometry as pg  # noqa: E402

jg = pytest.importorskip("iou3dmatch_tpu.geometry")
TOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def test_geometry_package_exports_what_jax_exports():
    renamed = {"nms_rotated_jax": "nms_rotated", "nms_normal_jax": "nms_normal",
               "lhs_3d_samecls_jax": "lhs_3d_samecls_plain"}
    assert sorted(renamed.get(n, n) for n in jg.__all__) == sorted(pg.__all__)
    for name in pg.__all__:
        assert callable(getattr(pg, name)), name


def _boxes2d(rng, n):
    lo = rng.uniform(-2, 2, (n, 2))
    return np.concatenate([lo, lo + rng.uniform(0.1, 2.0, (n, 2))], 1)


def test_2d_ious_equal_jax():
    rng = np.random.RandomState(0)
    a, b = _boxes2d(rng, 40), _boxes2d(rng, 40)
    b[:5] = a[:5]  # identical boxes
    b[5:10, :2] = a[5:10, 2:]  # touching at a corner
    b[5:10, 2:] = b[5:10, :2] + 1.0
    for x, y in zip(a, b):
        assert pg.box2d_iou(x, y) == jg.box2d_iou(x, y)
        d1 = dict(zip(("x1", "y1", "x2", "y2"), x))
        d2 = dict(zip(("x1", "y1", "x2", "y2"), y))
        assert pg.get_iou(d1, d2) == jg.get_iou(d1, d2)
    assert pg.get_iou({"x1": 0, "y1": 0, "x2": 2, "y2": 2},
                      {"x1": 1, "y1": 1, "x2": 3, "y2": 3}) == 1 / 7
    bad = {"x1": 1, "y1": 0, "x2": 1, "y2": 2}
    with pytest.raises(AssertionError):
        jg.get_iou(bad, bad)
    with pytest.raises(ValueError, match="x1 < x2"):
        pg.get_iou(bad, bad)


def _corners(rng, n, heading=True):
    return np.stack([jg.get_3d_box_np(rng.uniform(0.2, 2.0, 3),
                                      rng.uniform(-np.pi, np.pi) if heading else 0.0,
                                      rng.uniform(-1, 1, 3)) for _ in range(n)])


def test_box3d_iou_batch_np_equals_jax():
    rng = np.random.RandomState(1)
    c1, c2 = _corners(rng, 30), _corners(rng, 30)
    c2[:3] = c1[:3]
    for a, b in ((c1, c2), (c1.reshape(5, 6, 8, 3), c2.reshape(5, 6, 8, 3))):
        np.testing.assert_array_equal(pg.box3d_iou_batch_np(a, b), jg.box3d_iou_batch_np(a, b))
    np.testing.assert_allclose(pg.box3d_iou_batch_np(c1[:3], c1[:3]), 1.0, atol=1e-6)


def test_box3d_iou_axis_aligned_matches_jax():
    rng = np.random.RandomState(2)
    lo = rng.uniform(-1, 1, (4, 16, 3)).astype(np.float32)
    c1 = np.stack([lo + rng.uniform(0.1, 1.5, lo.shape).astype(np.float32), lo], -2)
    c2 = c1 + rng.uniform(-0.5, 0.5, c1.shape).astype(np.float32)
    c2[0, :4] = c1[0, :4]
    want = np.asarray(jg.box3d_iou_axis_aligned(jnp.asarray(c1), jnp.asarray(c2)))
    got = pg.box3d_iou_axis_aligned(_t(c1), _t(c2))
    assert got.shape == want.shape and (want > 0).any() and (want == 0).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    unit = _t([[[1.0, 1.0, 1.0], [0.0, 0.0, 0.0]]])
    shifted = _t([[[1.5, 1.0, 1.0], [0.5, 0.0, 0.0]]])
    assert abs(float(pg.box3d_iou_axis_aligned(unit, shifted)[0]) - 0.5 / 1.5) < 1e-6
    # differentiable in both boxes
    a, b = _t(c1).requires_grad_(True), _t(c2).requires_grad_(True)
    pg.box3d_iou_axis_aligned(a, b).sum().backward()
    assert a.grad.abs().sum() > 0 and b.grad.abs().sum() > 0


def test_corners3d_to_parameter_and_validity_equal_jax():
    rng = np.random.RandomState(3)
    for c in _corners(rng, 20):
        np.testing.assert_array_equal(pg.corners3d_to_parameter(c), jg.corners3d_to_parameter(c))
        assert pg.check_valid_corners3d(c) == jg.check_valid_corners3d(c) is True
    params = pg.corners3d_to_parameter(pg.get_3d_box_np(np.array([2.0, 1.0, 0.5]), 0.3,
                                                        np.array([1.0, 2.0, 3.0])))
    np.testing.assert_allclose(params, [1.0, 3.0, -2.0, 2.0, 1.0, 0.5, 0.3], atol=1e-6)
    corners = _corners(rng, 1)[0]
    cases = [np.zeros((8, 3)), corners + rng.uniform(-0.2, 0.2, (8, 3))]
    bent = corners.copy()
    bent[0] += 0.5
    sheared = corners.copy()
    sheared[[0, 1, 2, 3]] += np.array([0.3, 0.0, 0.0])  # parallel edges equal, corners not square
    for c in cases + [bent, sheared]:
        assert pg.check_valid_corners3d(c) == jg.check_valid_corners3d(c)
    assert not any(pg.check_valid_corners3d(c) for c in cases + [bent])


def test_rotations_and_depth_box_equal_jax():
    for t in np.random.RandomState(4).uniform(-np.pi, np.pi, 8):
        np.testing.assert_array_equal(pg.rotz(t), jg.rotz(t))
        np.testing.assert_array_equal(pg.roty_np(t), jg.roty_np(t))
        size, center = (2.0, 1.0, 3.0), (5.0, 6.0, 7.0)
        np.testing.assert_array_equal(pg.get_3d_box_depth_np(size, t, center),
                                      jg.get_3d_box_depth_np(size, t, center))


def _check_nn(got, want):
    d1, i1, d2, i2 = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[1].numpy(), i1)
    np.testing.assert_array_equal(got[3].numpy(), i2)
    np.testing.assert_allclose(got[0].numpy(), d1, rtol=0, atol=TOL * max(1.0, np.abs(d1).max()))
    np.testing.assert_allclose(got[2].numpy(), d2, rtol=0, atol=TOL * max(1.0, np.abs(d2).max()))


MODES = {"l2": {}, "l1": {"l1": True}, "huber": {"l1smooth": True, "delta": 0.5}}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_nn_distance_exclude_self_matches_jax(mode):
    kw = MODES[mode]
    rng = np.random.RandomState(5)
    pc = rng.randn(2, 24, 3).astype(np.float32)
    pc2 = pc + rng.randn(2, 24, 3).astype(np.float32) * 0.05
    cls = rng.randint(0, 3, (2, 24))
    for a, b in ((pc, pc), (pc, pc2)):
        _check_nn(pg.nn_distance_exclude_self(_t(a), _t(b), **kw),
                  jg.nn_distance_exclude_self(jnp.asarray(a), jnp.asarray(b), **kw))
        _check_nn(pg.nn_distance_exclude_self_with_cls(_t(a), _t(b), _t(cls), _t(cls), **kw),
                  jg.nn_distance_exclude_self_with_cls(jnp.asarray(a), jnp.asarray(b),
                                                       jnp.asarray(cls), jnp.asarray(cls), **kw))
    # the reference's diagonal: a point's own pair is its distance to -1000s
    d = pg.nn_distance_exclude_self(_t(pc[:, :1]), _t(pc[:, :1]))[0]
    np.testing.assert_allclose(d.numpy(), ((pc[:, :1] + 1000.0) ** 2).sum(-1), rtol=1e-6)
    with pytest.raises(ValueError, match="one size"):
        pg.nn_distance_exclude_self(_t(pc), _t(pc[:, :5]))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_nn_distance_inbox_matches_jax(mode):
    kw = MODES[mode]
    rng = np.random.RandomState(6)
    pc1 = rng.randn(2, 30, 3).astype(np.float32)
    seed = pc1 + rng.randn(2, 30, 3).astype(np.float32) * 0.3
    pc2 = rng.randn(2, 7, 3).astype(np.float32)
    half = np.abs(rng.randn(2, 7, 3)).astype(np.float32)
    want = jg.nn_distance_inbox(*map(jnp.asarray, (pc1, seed, pc2, half)), **kw)
    assert (np.asarray(want[0]) >= 1000).any() and (np.asarray(want[0]) < 1000).any()
    _check_nn(pg.nn_distance_inbox(*map(_t, (pc1, seed, pc2, half)), **kw), want)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_nn_distance_options_match_jax(mode):
    """The options the exclude-self and in-box helpers share with
    ``nn_distance`` and ``nn_distance_withcls``."""
    kw = MODES[mode]
    rng = np.random.RandomState(7)
    a, b = rng.randn(2, 20, 3).astype(np.float32), rng.randn(2, 9, 3).astype(np.float32)
    c1, c2 = rng.randint(0, 3, (2, 20)), rng.randint(0, 3, (2, 9))
    _check_nn(pg.nn_distance(_t(a), _t(b), **kw), jg.nn_distance(jnp.asarray(a), jnp.asarray(b),
                                                                 **kw))
    _check_nn(pg.nn_distance_withcls(_t(a), _t(b), _t(c1), _t(c2), **kw),
              jg.nn_distance_withcls(*map(jnp.asarray, (a, b, c1, c2)), **kw))
