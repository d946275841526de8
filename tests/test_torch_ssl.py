"""The port's pseudo labels, lower-half suppression and unlabeled loss
against the JAX package's, on the CPU.

Inputs (tests/lhs_cases.py, and end points here) are made with NumPy from
seeds and handed to both packages; the SSL step itself is held in
tests/test_torch_ssl_step.py, tests/test_torch_ssl_knobs.py and
tests/test_torch_ssl_teacher.py.
Tolerances, and why:

- Lower-half suppression: keep masks equal bit for bit, on clustered
  boxes with exact duplicates, tied scores, one class and many, K = 16
  and 64, and pairs whose IoU lies a few rounding steps either side of
  the threshold.
- ``corners_aabb``, ``nn_distance_withcls``, ``angle2class_tensor`` and the
  four frame transforms: atol 1e-6 (the same f32 steps; a 3-term ``bmm``
  sums in another order), integer outputs equal.
- ``get_pseudo_labels`` and ``get_unlabeled_loss`` fed the same end
  points: masks and integer labels equal, float labels within atol 1e-5,
  the loss and every metric within rtol 1e-4 (atol 1e-7 where one is 0).
  The end points are those of 3 scenes of 128 proposals, the full
  model's count, half of them near-copies of others as a trained
  teacher's clusters, so that the top-64 pick cuts and LHS thins them.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from iou3dmatch_tpu_torch.data.config import get_config  # noqa: E402
from iou3dmatch_tpu_torch.geometry.boxes import corners_aabb  # noqa: E402
from iou3dmatch_tpu_torch.geometry.nn_distance import nn_distance_withcls  # noqa: E402
from iou3dmatch_tpu_torch.losses import unlabeled as punl  # noqa: E402
from iou3dmatch_tpu_torch.ops.lhs import lhs_3d_samecls  # noqa: E402
from tests import torch_ssl_cases as C  # noqa: E402
from tests.lhs_cases import CASES as LHS_CASES  # noqa: E402
from tests.test_torch_train import labels_near  # noqa: E402

torch.set_num_threads(1)
t, close = C.t, C.close


# ------------------------------------------------------ lower-half suppression

@pytest.mark.parametrize("case", sorted(LHS_CASES))
def test_lhs_matches_jax(case):
    from iou3dmatch_tpu.geometry.nms import lhs_3d_samecls_jax

    mins, maxs, scores, cls, thresh = LHS_CASES[case]()
    want = jax.jit(jax.vmap(lambda a, b, c, d: lhs_3d_samecls_jax(a, b, c, d, thresh)))(
        mins, maxs, scores, cls.astype(np.float32))
    got = lhs_3d_samecls(t(mins), t(maxs), t(scores), t(cls), thresh)
    assert got.dtype == torch.bool and got.shape == scores.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < got.numel() or case.startswith("many_classes")


# ------------------------------------------------------ geometry and frames

def test_corners_aabb_matches_jax():
    from iou3dmatch_tpu.geometry.boxes import corners_aabb as jax_corners_aabb

    rng = np.random.RandomState(0)
    center = rng.uniform(-3, 3, (2, 50, 3)).astype(np.float32)
    size = rng.uniform(0.1, 2.0, (2, 50, 3)).astype(np.float32)
    heading = rng.uniform(-np.pi, np.pi, (2, 50)).astype(np.float32)
    heading[:, :10] = 0.0  # ScanNet's boxes
    got = corners_aabb(t(center), t(size), t(heading))
    want = jax_corners_aabb(jnp.asarray(center), jnp.asarray(size), jnp.asarray(heading))
    for g, w in zip(got, want):
        close(g, w, atol=1e-6)
    close(got[0][:, :10], center[:, :10] - size[:, :10] / 2, atol=1e-6)


def test_nn_distance_withcls_matches_jax():
    from iou3dmatch_tpu.geometry.nn_distance import nn_distance_withcls as jax_withcls

    rng = np.random.RandomState(1)
    pc1, pc2 = rng.randn(2, 30, 3).astype(np.float32), rng.randn(2, 20, 3).astype(np.float32)
    cls1, cls2 = rng.randint(0, 3, (2, 30)), rng.randint(0, 3, (2, 20))
    cls1[:, 0] = 7  # a class the other set lacks
    got = nn_distance_withcls(t(pc1), t(pc2), t(cls1), t(cls2))
    want = jax_withcls(jnp.asarray(pc1), jnp.asarray(pc2), jnp.asarray(cls1), jnp.asarray(cls2))
    for g, w in zip(got, want):
        close(g, w, atol=1e-6)
    assert float(got[0].max()) > 1000  # some point has no neighbour of its class


def test_angle2class_tensor_matches_jax():
    from iou3dmatch_tpu.data.config import get_config as jax_config

    angles = np.random.RandomState(2).uniform(-7, 7, 500).astype(np.float32)
    got = get_config("sunrgbd").angle2class_tensor(t(angles))
    want = jax_config("sunrgbd").angle2class_jnp(jnp.asarray(angles))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].dtype == torch.int32
    close(got[1], want[1], atol=1e-6)
    with pytest.raises(NotImplementedError):
        get_config("scannet").angle2class_tensor(t(angles))


def test_frame_transforms_match_jax():
    """trans_center, reverse_trans_center, trans_size (ScanNet) and
    trans_angle (SUN RGB-D) on the batch recipe's flips, rotations and
    scales. The reverse flips before it rotates, as the reference does, so
    it undoes the forward only where nothing is flipped."""
    from iou3dmatch_tpu.data.config import get_config as jax_config
    from iou3dmatch_tpu.losses import unlabeled as junl

    rng = np.random.RandomState(3)
    _, aug = C.augment(np.zeros((4, 1, 4), np.float32), 4)
    aug["flip_x_axis"][:] = (1, 1, 0, 0)
    aug["flip_y_axis"][:] = (0, 1, 1, 0)
    args = [aug[k] for k in ("flip_x_axis", "flip_y_axis", "rot_mat", "scale")]
    center = rng.uniform(-3, 3, (4, 64, 3)).astype(np.float32)
    got = punl.trans_center(t(center), *map(t, args))
    close(got, junl.trans_center(jnp.asarray(center), *map(jnp.asarray, args)), atol=1e-6)
    back = punl.reverse_trans_center(got, *map(t, args))
    close(back, junl.reverse_trans_center(jnp.asarray(got.numpy()), *map(jnp.asarray, args)),
          atol=1e-6)
    close(back[3], center[3], atol=1e-5)  # the scene with no flip

    cls = rng.randint(0, 18, (4, 64))
    res = rng.uniform(-0.1, 0.1, (4, 64, 3)).astype(np.float32)
    close(punl.trans_size(t(cls), t(res), t(aug["scale"]), get_config("scannet")),
          junl.trans_size(jnp.asarray(cls), jnp.asarray(res), jnp.asarray(aug["scale"]),
                          jax_config("scannet")), atol=1e-6)

    hcls = rng.randint(0, 12, (4, 64))
    hres = rng.uniform(-0.25, 0.25, (4, 64)).astype(np.float32)
    rot = rng.uniform(-np.pi, np.pi, 4).astype(np.float32)
    got = punl.trans_angle(t(hcls), t(hres), t(args[0]), t(args[1]), t(rot), get_config("sunrgbd"))
    want = junl.trans_angle(jnp.asarray(hcls), jnp.asarray(hres), jnp.asarray(args[0]),
                            jnp.asarray(args[1]), jnp.asarray(rot), jax_config("sunrgbd"))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    close(got[1], want[1], atol=1e-6)


# ------------------------------------------------------------ pseudo labels

def _compare_pseudo(got, want):
    for k, w in want.items():
        w = np.asarray(w)
        if np.issubdtype(w.dtype, np.floating):
            close(got[k], w, atol=1e-5, what=k)
        else:
            np.testing.assert_array_equal(got[k].numpy().astype(np.int64), w.astype(np.int64),
                                          err_msg=k)


def _compare_metrics(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        close(got[k], w, rtol=1e-4, atol=1e-7, what=k)


@pytest.mark.parametrize("view_stats", [False, True])
def test_pseudo_labels_match_jax(view_stats):
    """On teacher outputs of 3 scenes of 128 proposals, the full model's
    count, so that the top-64 pick cuts and LHS runs at K = 64, with the
    real labels of those scenes for the view-stats metrics; LHS drops
    boxes that passed the thresholds."""
    from iou3dmatch_tpu.data.config import get_config as jax_config
    from iou3dmatch_tpu.losses.unlabeled import get_pseudo_labels as jax_pseudo

    cfg = get_config("scannet")
    teacher = {k: v for k, v in synthetic_outputs(40, cfg, 3).items() if k in punl.TEACHER_KEYS}
    args = (0.6, 0.5, 0.3, 0.25)  # objectness, class and IoU thresholds; LHS IoU
    gt = None
    if view_stats:
        labels = labels_near(41, teacher["center"], cfg)
        gt = {k: labels[k] for k in punl.GT_KEYS}
    want = C.np_tree(jax_pseudo(teacher, jax_config("scannet"), *args, gt_labels=gt))
    t_teacher = {k: t(v) for k, v in teacher.items()}
    t_gt = None if gt is None else {k: t(v) for k, v in gt.items()}
    got = punl.get_pseudo_labels(t_teacher, cfg, *args, gt_labels=t_gt)
    _compare_pseudo(got[0], want[0])
    _compare_metrics(got[1], want[1])
    assert got[0]["unlabeled_box_label_mask"].shape == (3, punl.MAX_NUM_OBJ)
    assert float(got[1]["pseudo_gt_ratio"]) > 0
    no_lhs = punl.get_pseudo_labels(t_teacher, cfg, *args, use_lhs=False)[0]
    kept = got[0]["unlabeled_box_label_mask"]
    assert int(no_lhs["unlabeled_box_label_mask"].sum()) > int(kept.sum())


def test_proposal_gt_iou_matches_jax_reverse():
    """The one (B, K, G) IoU that view-stats reads, transposed, against the
    JAX ``compute_iou_labels(..., reverse=True)``; the labels taken from it
    against the JAX forward call."""
    from iou3dmatch_tpu.data.config import get_config as jax_config
    from iou3dmatch_tpu.losses.iou_labels import compute_iou_labels as jax_iou_labels
    from iou3dmatch_tpu_torch.losses.iou_labels import iou_labels_from, proposal_gt_iou

    cfg = get_config("scannet")
    ep = synthetic_outputs(42, cfg, 3)
    labels = labels_near(43, ep["center"], cfg)
    keys = ("center", "heading_scores", "heading_residuals", "size_scores", "size_residuals")
    gt = {k: labels[k] for k in punl.GT_KEYS}
    jargs = (jnp.asarray(ep["aggregated_vote_xyz"]), *(jnp.asarray(ep[k]) for k in keys),
             jax_config("scannet"))
    iou = proposal_gt_iou({k: t(v) for k, v in gt.items()}, *(t(ep[k]) for k in keys), cfg)
    close(iou.transpose(1, 2), jax_iou_labels(gt, *jargs, reverse=True), atol=1e-5)
    assert float(iou.max()) > 0.05  # the GT boxes overlap some proposals
    got = iou_labels_from({k: t(v) for k, v in gt.items()}, t(ep["aggregated_vote_xyz"]), iou)
    want = jax_iou_labels(gt, *jargs)
    close(got[0], want[0], atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def synthetic_outputs(seed, cfg, b, k=128, near=None):
    """End points of a VoteNet for ``cfg`` on b scenes of k proposals, half
    of them jittered copies (class scores included) of others, so that LHS
    has clusters; the votes sit at ``near`` where given."""
    rng = np.random.RandomState(seed)
    nh, ns, nc = cfg.num_heading_bin, cfg.num_size_cluster, cfg.num_class
    src = np.where(rng.rand(b, k) < 0.5, rng.randint(0, k, (b, k)), np.arange(k))

    def copies(x):
        return np.take_along_axis(x, src.reshape(b, k, *([1] * (x.ndim - 2))), 1)

    center = copies(rng.uniform(-2, 2, (b, k, 3))) + rng.normal(0, 0.05, (b, k, 3))
    ep = {
        "center": center,
        "aggregated_vote_xyz": (center if near is None else near) + rng.normal(0, 0.05, (b, k, 3)),
        "objectness_scores": rng.randn(b, k, 2) * 2,
        "sem_cls_scores": copies(rng.randn(b, k, nc) * 3),
        "heading_scores": copies(rng.randn(b, k, nh)),
        "heading_residuals_normalized": rng.randn(b, k, nh) * 0.3,
        "size_scores": copies(rng.randn(b, k, ns)),
        "size_residuals_normalized": rng.randn(b, k, ns, 3) * 0.1,
        "iou_scores": rng.randn(b, k, nc),
    }
    ep["heading_residuals"] = ep["heading_residuals_normalized"] * (np.pi / nh)
    ep["size_residuals"] = ep["size_residuals_normalized"] * cfg.mean_size_arr[None, None]
    return {key: v.astype(np.float32) for key, v in ep.items()}


@pytest.mark.parametrize("dataset", ["scannet", "sunrgbd"])
@pytest.mark.parametrize("samecls_match", [False, True])
def test_unlabeled_loss_matches_jax(dataset, samecls_match):
    """1 labeled + 3 unlabeled scenes of 128 proposals (so the top-64 pick
    cuts), view-stats on; SUN RGB-D moves headings with trans_angle."""
    from iou3dmatch_tpu.data.config import get_config as jax_config
    from iou3dmatch_tpu.losses import get_unlabeled_loss as jax_unlabeled_loss

    cfg, jcfg = get_config(dataset), jax_config(dataset)
    ema_ep = synthetic_outputs(50, cfg, 4)
    _, batch = C.augment(np.zeros((4, 1, 4), np.float32), 51)
    student_votes = punl.trans_center(t(ema_ep["center"]), *(t(batch[k]) for k in (
        "flip_x_axis", "flip_y_axis", "rot_mat", "scale"))).numpy()
    ep = synthetic_outputs(52, cfg, 4, near=student_votes)
    labels = labels_near(53, ema_ep["center"], cfg)
    batch.update({k: labels[k] for k in punl.GT_KEYS})
    kw = dict(obj_threshold=0.6, cls_threshold=0.5, iou_threshold=0.3, nms_iou=0.25,
              samecls_match=samecls_match, dataset=dataset, view_stats=True)
    want = jax_unlabeled_loss(ep, ema_ep, batch, jcfg, 1, **kw)
    loss, metrics = punl.get_unlabeled_loss(*({k: t(v) for k, v in d.items()}
                                              for d in (ep, ema_ep, batch)), cfg, 1, **kw)
    close(loss, want[0], rtol=1e-4)
    _compare_metrics(metrics, C.np_tree(want[1]))
    assert 0 < float(metrics["pseudo_gt_ratio"]) < 1
    assert float(metrics["unlabeled_pos_ratio"]) > 0
    assert float(metrics["final_coverage_0.25_value"]) > 0
