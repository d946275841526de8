"""The port's pretrain step against the JAX package's, on the CPU.

A tiny JAX VoteNet (ScanNet config, ``tiny=True``, 16 proposals) and 2
scenes of 2,048 points made from NumPy seeds (and the same on the SUN RGB-D
config, 10 classes and 12 heading bins with rotated GT boxes, for the IoU
labels, the labeled loss, the step-0 gradient and the trajectory); its weights, with BN running
statistics perturbed away from (0, 1), go into the port by
``state_dict_from_jax``. The GT boxes sit near the proposals' vote
centers, so objectness has positives and the box losses are not all
masked away. The jitter noise is JAX's own draws, handed to the port.

Tolerances, and why:

- BatchNorm alone: rtol 1e-5 (one-pass statistics in JAX, two-pass here).
- Gather backward: atol 1e-6 (sums of a few f32 values in another order).
- Rotated IoU: atol 1e-5 (the same f32 steps; sums in another order).
- End points, losses and metrics: atol 1e-4, or rtol 1e-4 on a loss
  (CPU matmuls of XLA and PyTorch, and GridConv's one-hot interpolation
  on the JAX side against the port's gather, as in test_torch_models).
- The 3-step pretrain trajectory, with the methodology of
  tests/test_trajectory_diff.py: Adam eps 1e-3 on both sides (at eps 1e-8
  the first update is lr * sign(g), which turns f32 noise in near-zero
  gradients into full-size steps); the step-0 loss within rtol 2e-3; the
  step-0 gradient (its own test) with cosine > 0.999 and relative L2 <
  0.05; later losses
  and final parameters within 4x the port's own chaos envelope (the same
  steps from inputs moved by 1e-6), or 0.02 and 5e-3 where that is
  smaller; BN running statistics after step 0 within rtol 1e-3 and atol
  1e-3 (GridConv's BatchNorm sees 64 rows, and its inputs differ by up
  to 4.4e-3 between the packages in train mode).
"""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.tree_util as jtu  # noqa: E402
import torch  # noqa: E402

from iou3dmatch_tpu_torch.data.config import get_config  # noqa: E402
from iou3dmatch_tpu_torch.geometry import iou3d as piou  # noqa: E402
from iou3dmatch_tpu_torch.geometry.nn_distance import huber_loss, nn_distance  # noqa: E402
from iou3dmatch_tpu_torch.losses import common as pcommon  # noqa: E402
from iou3dmatch_tpu_torch.losses import iou_labels as plabels  # noqa: E402
from iou3dmatch_tpu_torch.losses import labeled as plabeled  # noqa: E402
from iou3dmatch_tpu_torch.losses.supervised import get_loss  # noqa: E402
from iou3dmatch_tpu_torch.models.factory import build_votenet  # noqa: E402
from iou3dmatch_tpu_torch.models.mlp import BatchNorm, set_bn_momentum  # noqa: E402
from iou3dmatch_tpu_torch.train import schedules  # noqa: E402
from iou3dmatch_tpu_torch.train.state import create_train_state, make_optimizer  # noqa: E402
from iou3dmatch_tpu_torch.train.steps import make_eval_loss, make_pretrain_step  # noqa: E402
from iou3dmatch_tpu_torch.train.torch_import import state_dict_from_jax  # noqa: E402

pbq = importlib.import_module("iou3dmatch_tpu_torch.ops.ball_query")
torch.set_num_threads(1)
B, N, G = 2, 2048, 8  # scenes, points a scene, GT slots (the last 2 empty)
ATOL = 1e-4
MOMENTUM = 0.5  # epoch 0 of the BN momentum schedule
ADAM_EPS = 1e-3
LR = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def scenes(seed, b=B, n=N):
    rng = np.random.RandomState(seed)
    pc = np.zeros((b, n, 4), np.float32)
    pc[..., 0:3] = rng.uniform(-3.0, 3.0, (b, n, 3))
    pc[..., 3] = pc[..., 2] - pc[..., 2].min(axis=1, keepdims=True)
    return pc


def labels_near(seed, anchors, cfg):
    """GT dict whose first G - 2 boxes sit within 0.1 of ``anchors``
    (b, >= G, 3), the vote centers of the proposals. With more than one
    heading bin (SUN RGB-D's 12) the boxes turn: heading classes and
    residuals are drawn after every other draw, so ScanNet's labels are
    those of a config without headings."""
    rng = np.random.RandomState(seed)
    b = anchors.shape[0]
    mask = np.ones((b, G), np.float32)
    mask[:, -2:] = 0
    center = np.asarray(anchors)[:, :G] + rng.uniform(-0.05, 0.05, (b, G, 3))
    center[:, -2:] = 0.0  # empty slots hold zeros, as the datasets write them
    labels = {
        "center_label": center.astype(np.float32),
        "box_label_mask": mask,
        "heading_class_label": np.zeros((b, G), np.int64),
        "heading_residual_label": np.zeros((b, G), np.float32),
        "size_class_label": rng.randint(0, cfg.num_size_cluster, (b, G)).astype(np.int64),
        "size_residual_label": rng.uniform(-0.05, 0.05, (b, G, 3)).astype(np.float32),
        "sem_cls_label": rng.randint(0, cfg.num_class, (b, G)).astype(np.int64),
        "vote_label": (rng.randn(b, N, 9) * 0.1).astype(np.float32),
        "vote_label_mask": rng.randint(0, 2, (b, N)).astype(np.int64),
    }
    if cfg.num_heading_bin > 1:
        half_bin = np.pi / cfg.num_heading_bin
        labels["heading_class_label"] = rng.randint(0, cfg.num_heading_bin, (b, G)).astype(np.int64)
        labels["heading_residual_label"] = rng.uniform(-half_bin, half_bin, (b, G)).astype(np.float32)
    return labels


def jitter_noise(key, b, k):
    """forward_with_pred_jitter's draws: k1, k2 = split(key), normal(ki, (B, K, 3))."""
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.normal(k1, (b, k, 3)), np.float32),
            np.asarray(jax.random.normal(k2, (b, k, 3)), np.float32))


def perturb_batch_stats(variables, seed=5):
    rng = np.random.RandomState(seed)

    def perturb(path, x):
        names = [p.key for p in path]
        if names[0] != "batch_stats":
            return x
        if names[-1] == "mean":
            return (rng.randn(*x.shape) * 0.05).astype(x.dtype)
        return (1.0 + rng.uniform(-0.2, 0.2, x.shape)).astype(x.dtype)

    return jtu.tree_map_with_path(perturb, variables)


_SETUPS = {}


def make_setup(dataset):
    """The tiny model of ``dataset``, its perturbed weights, the scenes, the
    JAX forward's end points and GT near them; one a dataset a module."""
    if dataset not in _SETUPS:
        _SETUPS[dataset] = _build_setup(dataset)
    return _SETUPS[dataset]


def _build_setup(dataset):
    from iou3dmatch_tpu.models.factory import build_votenet as build_jax

    jm, cfg = build_jax(dataset, tiny=True)
    pc = scenes(11)
    variables = jax.jit(lambda x: jm.init({"params": jax.random.PRNGKey(4)}, x, train=False))(
        jnp.asarray(pc))
    variables = perturb_batch_stats(_np_tree(dict(variables)))
    forward = jax.jit(
        lambda v, x, key: jm.apply(v, x, key, train=True, momentum=MOMENTUM,
                                   mutable=["batch_stats"], method=jm.forward_with_pred_jitter))
    key = jax.random.PRNGKey(7)
    ep, mut = forward(variables, jnp.asarray(pc), key)
    ep, stats = _np_tree(ep), _np_tree(mut["batch_stats"])
    batch = labels_near(12, ep["aggregated_vote_xyz"], cfg)
    batch["point_clouds"] = pc
    return SimpleNamespace(jm=jm, cfg=cfg, pcfg=get_config(dataset), variables=variables,
                           pc=pc, key=key, ep=ep, stats=stats, batch=batch, forward=forward,
                           dataset=dataset)


@pytest.fixture(scope="module")
def setup():
    return make_setup("scannet")


@pytest.fixture(scope="module", params=["scannet", "sunrgbd"])
def dataset_setup(request):
    """ScanNet's setup, then SUN RGB-D's: 10 classes, 12 heading bins and
    rotated GT boxes."""
    return make_setup(request.param)


def port_model(setup):
    pm, _ = build_votenet(setup.dataset, tiny=True, device="cpu")
    pm.load_state_dict(state_dict_from_jax(setup.variables), strict=True)
    return pm.train()


def torch_batch(batch):
    return {k: _t(v) for k, v in batch.items()}


def _close(got, want, atol=ATOL, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


# ---------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize("shape", [(64, 32), (2, 16, 8, 32)])
def test_batchnorm_train_matches_flax(shape):
    """Output, running statistics at momentum 0.5, and the input and
    parameter gradients of train-mode BatchNorm."""
    from iou3dmatch_tpu.models.mlp import BatchNorm as FlaxBatchNorm

    rng = np.random.RandomState(len(shape))
    c = shape[-1]
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, c).astype(np.float32), rng.randn(c).astype(np.float32)
    mean0, var0 = rng.randn(c).astype(np.float32), rng.uniform(0.5, 2, c).astype(np.float32)

    fbn = FlaxBatchNorm(c)

    def f(x_, s_, b_):
        return fbn.apply({"params": {"scale": s_, "bias": b_},
                          "batch_stats": {"mean": mean0, "var": var0}},
                         x_, train=True, momentum=MOMENTUM, mutable=["batch_stats"])

    out_and_stats, vjp = jax.vjp(lambda *a: f(*a)[0], jnp.asarray(x), jnp.asarray(scale),
                                 jnp.asarray(bias))
    _, mut = f(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    dx, ds, db = vjp(jnp.asarray(g))

    bn = BatchNorm(c).train()
    set_bn_momentum(bn, MOMENTUM)
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
        bn.running_mean.copy_(_t(mean0))
        bn.running_var.copy_(_t(var0))
    xt = _t(x).requires_grad_()
    out = bn(xt)
    out.backward(_t(g))
    tol = dict(rtol=1e-5, atol=1e-5)
    _close(out.detach(), out_and_stats, what="output", **tol)
    _close(bn.running_mean, mut["batch_stats"]["mean"], what="running mean", **tol)
    _close(bn.running_var, mut["batch_stats"]["var"], what="running var", **tol)
    _close(xt.grad, dx, what="input grad", **tol)
    _close(bn.weight.grad, ds, what="scale grad", **tol)
    _close(bn.bias.grad, db, what="bias grad", **tol)


def test_set_bn_momentum_reaches_every_batchnorm():
    pm, _ = build_votenet("scannet", tiny=True, device="cpu")
    bns = [m for m in pm.modules() if isinstance(m, BatchNorm)]
    assert len(bns) > 20 and all(m.momentum is None for m in bns)
    set_bn_momentum(pm, schedules.get_bn_momentum(20))
    assert all(m.momentum == 0.25 for m in bns)


def test_schedules_match_jax():
    from iou3dmatch_tpu.train import schedules as js

    for epoch in (0, 19, 20, 399, 400, 650, 10_000):
        assert schedules.get_bn_momentum(epoch) == js.get_bn_momentum(epoch)
        assert schedules.get_lr(epoch, 1e-3, [400, 600, 800], [0.1] * 3) == \
            js.get_lr(epoch, 1e-3, [400, 600, 800], [0.1] * 3)


# ------------------------------------------------------ the gather's backward

@pytest.mark.parametrize("c", [1, 7, 131])
def test_group_points_grad_matches_jax_vjp(c):
    """Duplicate and out-of-range indices: the cotangent of an index
    outside [0, N-1] lands on the row the clamped forward read."""
    from iou3dmatch_tpu.ops.ball_query import group_points as jax_group_points

    rng = np.random.RandomState(c)
    feats = rng.randn(2, 50, c).astype(np.float32)
    idx = rng.randint(-4, 56, (2, 9, 6)).astype(np.int32)
    idx[:, 0] = 3  # a ball whose slots all repeat one hit
    g = rng.randn(2, 9, 6, c).astype(np.float32)
    want, vjp = jax.vjp(lambda f: jax_group_points(f, jnp.asarray(idx)), jnp.asarray(feats))
    (want_grad,) = vjp(jnp.asarray(g))
    ft = _t(feats).requires_grad_()
    got = pbq.group_points(ft, _t(idx))
    got.backward(_t(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    _close(ft.grad, want_grad, atol=1e-6)
    f64 = np.zeros((2, 50, c))
    for b in range(2):
        np.add.at(f64[b], np.clip(idx[b], 0, 49).reshape(-1), g[b].reshape(-1, c))
    _close(pbq.group_points_backward(_t(g), _t(idx), 50), f64, atol=1e-6)


def test_group_points_backward_runs_only_where_the_table_needs_a_gradient(setup, monkeypatch):
    """One pretrain forward and backward sums cotangents into SA2, SA3,
    SA4 and vote aggregation's tables; SA1's table is the point cloud and
    GridConv's seeds are detached, so theirs are never asked for."""
    calls = []
    plain = pbq.group_points_backward_plain

    def counting(g, idx, n):
        calls.append(tuple(g.shape))
        return plain(g, idx, n)

    monkeypatch.setattr(pbq, "group_points_backward_plain", counting)
    pm = port_model(setup)
    set_bn_momentum(pm, MOMENTUM)
    batch = torch_batch(setup.batch)
    noise = tuple(map(_t, jitter_noise(setup.key, B, 16)))
    ep = pm.forward_with_pred_jitter(batch["point_clouds"], noise=noise)
    loss, _ = plabeled.get_labeled_loss(ep, batch, setup.pcfg, B)
    loss.backward()
    assert sorted(calls) == sorted([(B, 64, 32, 131), (B, 32, 16, 259), (B, 16, 16, 259),
                                    (B, 16, 16, 259)])


# ----------------------------------------------------------- the jittered forward

def _compare_end_points(got, want, atol):
    keys = sorted(set(got) & set(want))
    assert {"iou_scores", "iou_scores_jitter", "jitter_center", "jitter_size",
            "jitter_heading", "center", "aggregated_vote_xyz"} <= set(keys)
    for k in keys:
        if np.issubdtype(np.asarray(want[k]).dtype, np.integer):
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        else:
            assert got[k].shape == want[k].shape, k
            _close(got[k], want[k], atol=atol, what=k)


@pytest.mark.parametrize("jitter_rows", [None, 1])
def test_forward_with_pred_jitter_matches_flax(setup, jitter_rows):
    """Both branches, BN on running statistics: every end point within
    atol 1e-4, fed JAX's noise draws."""
    jm = setup.jm
    want = jax.jit(lambda v, x: jm.apply(v, x, setup.key, train=False,
                                         method=jm.forward_with_pred_jitter,
                                         jitter_rows=jitter_rows))(setup.variables,
                                                                   jnp.asarray(setup.pc))
    pm = port_model(setup).eval()
    noise = tuple(map(_t, jitter_noise(setup.key, B, 16)))
    with torch.no_grad():
        got = pm.forward_with_pred_jitter(_t(setup.pc), noise=noise, jitter_rows=jitter_rows)
    _compare_end_points(got, _np_tree(want), ATOL)
    k = 16 if jitter_rows is None else 1
    assert got["iou_scores_jitter"].shape[0:2] == ((B, k) if jitter_rows is None else (1, 16))
    assert got["jitter_heading"].shape[0] == (B if jitter_rows is None else 1)


def test_forward_with_pred_jitter_train_mode_matches_flax(setup):
    """Train mode at BN momentum 0.5: indices equal, SA1's features within
    5e-4, every end point within 1e-2, the running statistics the forward
    leaves within rtol 1e-3 and atol 1e-4. BN normalises by the batch statistics, which
    each package sums in its own order and precision: against a float64
    run of the port, JAX's SA1 output is off by 1.3e-4 and the port's by
    4.5e-5, and the later layers' max pools and small batches amplify
    that (the end points differ by up to 4.4e-3, GridConv's IoU scores)."""
    pm = port_model(setup)
    set_bn_momentum(pm, MOMENTUM)
    noise = tuple(map(_t, jitter_noise(setup.key, B, 16)))
    with torch.no_grad():
        got = pm.forward_with_pred_jitter(_t(setup.pc), noise=noise)
    _close(got["sa1_features"], setup.ep["sa1_features"], atol=5e-4)
    _compare_end_points(got, setup.ep, 1e-2)
    for key, val in state_dict_from_jax({"batch_stats": setup.stats}).items():
        _close(pm.state_dict()[key], val, rtol=1e-3, atol=1e-4, what=key)


# ---------------------------------------------------------------- rotated IoU

def _boxes(rng, n, rotated=True):
    b = np.zeros((n, 7), np.float32)
    b[:, 0:3] = rng.uniform(-1.5, 1.5, (n, 3))
    b[:, 3:6] = rng.uniform(0.2, 1.5, (n, 3))
    if rotated:
        b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def _iou_case(name):
    rng = np.random.RandomState(len(name))
    a, b = _boxes(rng, 24), _boxes(rng, 12)
    if name == "identical":
        b = a[:12].copy()
    elif name == "disjoint":
        b[:, 0] += 10.0
    elif name == "nested":
        b = a[:12].copy()
        b[:, 3:6] *= 0.5
        b[:, 6] = a[:12, 6] + rng.uniform(-0.2, 0.2, 12)
    elif name == "shared_edges":
        a[:, 6] = b[:1, 6].repeat(24)
        a[:12, 0:3] = b[:, 0:3]
        a[:12, 0] += b[:, 3] * 0.5 + a[:12, 3] * 0.5  # touching in x
        a[:12, 1] = b[:, 1]
        a[:12, 6] = b[:, 6]
    elif name == "scannet_axis_aligned":
        a, b = _boxes(rng, 24, rotated=False), _boxes(rng, 12, rotated=False)
        a[:6] = b[:6]  # ties in angle between coinciding candidates
        a[6:12, 0:2] = np.round(b[:6, 0:2], 1)
        a[6:12, 3:5] = np.round(b[:6, 3:5], 1)
    elif name == "placeholders":
        b[6:, 0:3] = -1000.0
    return a, b


IOU_CASES = ["random_rotated", "identical", "disjoint", "nested", "shared_edges",
             "scannet_axis_aligned", "placeholders"]


@pytest.mark.parametrize("case", IOU_CASES)
def test_rotated_iou_matches_jax(case):
    """The plain version against JAX boxes_iou3d_paired_rows (two scenes)
    and boxes_iou3d, atol 1e-5."""
    from iou3dmatch_tpu.geometry import iou3d as jiou

    a, b = _iou_case(case)
    pa, pb = a.reshape(2, 12, 7), np.stack([b, b[::-1]])
    want = np.asarray(jiou.boxes_iou3d_paired_rows(jnp.asarray(pa), jnp.asarray(pb)))
    got = piou.boxes_iou3d_paired_rows(_t(pa), _t(pb))
    _close(got, want, atol=1e-5)
    _close(piou.boxes_iou3d(_t(a), _t(b)), jiou.boxes_iou3d(jnp.asarray(a), jnp.asarray(b)),
           atol=1e-5)
    if case == "identical":
        _close(np.diagonal(want[0]), np.ones(12), atol=1e-5)
    if case == "disjoint":
        assert (want == 0).all()
    if case == "placeholders":
        assert (want[0, :, 6:] == 0).all() and (want[1, :, :6] == 0).all()


def test_bev_overlap_and_iou_match_jax():
    from iou3dmatch_tpu.geometry import iou3d as jiou

    a, b = _iou_case("random_rotated")
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    _close(piou.boxes_overlap_bev(_t(a), _t(b)), jiou.boxes_overlap_bev(ja, jb), atol=1e-5)
    _close(piou.boxes_iou_bev(_t(a), _t(b)), jiou.boxes_iou_bev(ja, jb), atol=1e-5)
    cnt = piou.bev_candidates(*torch.broadcast_tensors(_t(a)[:, None], _t(b)[None]))[2].sum(-1)
    overlap = piou.boxes_overlap_bev(_t(a), _t(b))
    assert not ((overlap > 0) & (cnt < 3)).any() and cnt.max() <= 24


# ------------------------------------------------------ distances, CE, config

@pytest.mark.parametrize("mode", ["l2", "l1"])
def test_nn_distance_and_huber_match_jax(mode):
    jnn = importlib.import_module("iou3dmatch_tpu.geometry.nn_distance")

    rng = np.random.RandomState(3)
    p1, p2 = rng.randn(2, 30, 3).astype(np.float32), rng.randn(2, 20, 3).astype(np.float32)
    want = jnn.nn_distance(jnp.asarray(p1), jnp.asarray(p2), l1=mode == "l1")
    got = nn_distance(_t(p1), _t(p2), l1=mode == "l1")
    for g, w in zip(got, want):
        if g.dtype == torch.int64:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w, atol=1e-6)
    err = rng.randn(100).astype(np.float32) * 2
    _close(huber_loss(_t(err), 1.0), jnn.huber_loss(jnp.asarray(err), 1.0), atol=1e-6)


def test_cross_entropy_and_masked_mean_match_jax():
    from iou3dmatch_tpu.losses import common as jc

    rng = np.random.RandomState(4)
    logits, labels = rng.randn(3, 10, 2).astype(np.float32), rng.randint(0, 2, (3, 10))
    mask = rng.randint(0, 2, (3, 10)).astype(np.float32)
    for w in (None, jc.OBJECTNESS_CLS_WEIGHTS):
        want = jc.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), w)
        _close(pcommon.cross_entropy(_t(logits), _t(labels), w), want, atol=1e-6)
        _close(pcommon.masked_mean(_t(np.asarray(want)), _t(mask)),
               jc.masked_mean(want, jnp.asarray(mask)), atol=1e-6)


@pytest.mark.parametrize("dataset", ["scannet", "sunrgbd"])
def test_config_tensor_helpers_match_jax(dataset):
    from iou3dmatch_tpu.data.config import get_config as jax_config

    rng = np.random.RandomState(5)
    pc, jc = get_config(dataset), jax_config(dataset)
    cls = rng.randint(0, pc.num_size_cluster, (2, 6))
    res = rng.uniform(-0.2, 0.2, (2, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(pc.class2size_tensor(_t(cls), _t(res)).numpy(),
                                  np.asarray(jc.class2size_jnp(jnp.asarray(cls), jnp.asarray(res))))
    hcls = rng.randint(0, pc.num_heading_bin, (2, 6))
    hres = rng.uniform(-0.3, 0.3, (2, 6)).astype(np.float32)
    _close(pc.class2angle_tensor(_t(hcls), _t(hres)),
           jc.class2angle_jnp(jnp.asarray(hcls), jnp.asarray(hres)), atol=1e-6)


# -------------------------------------------------------------------- losses

def _loss_inputs(setup):
    """The JAX end points and GT of ``setup`` on both sides."""
    jep = {k: jnp.asarray(v) for k, v in setup.ep.items()}
    jbatch = {k: jnp.asarray(v) for k, v in setup.batch.items()}
    return jep, jbatch, {k: _t(v) for k, v in setup.ep.items()}, torch_batch(setup.batch)


@pytest.fixture(scope="module")
def loss_inputs(setup):
    return _loss_inputs(setup)


def test_vote_and_objectness_losses_match_jax(setup, loss_inputs):
    from iou3dmatch_tpu.losses import labeled as jl

    jep, jb, pep, pb = loss_inputs
    _close(plabeled.compute_vote_loss(pep, pb, B), jl.compute_vote_loss(jep, jb, B))
    want = jl.compute_objectness_loss(jep, jb, B)
    got = plabeled.compute_objectness_loss(pep, pb, B)
    _close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].sum() >= B * (G - 2)  # a positive at each GT at least


def test_box_and_sem_cls_losses_match_jax(setup, loss_inputs):
    from iou3dmatch_tpu.losses import labeled as jl

    jep, jb, pep, pb = loss_inputs
    _, label, _, assignment = jl.compute_objectness_loss(jep, jb, B)
    want = jl._box_and_sem_cls_losses(jep, jb, B, setup.cfg, assignment, label)
    got = plabeled.box_and_sem_cls_losses(pep, pb, B, setup.pcfg, _t(assignment), _t(label))
    for i, (g, w) in enumerate(zip(got[:6], want[:6])):
        _close(g, w, rtol=1e-4, what=f"loss {i}")
        assert float(w) > 0 or i in (1, 2), i  # ScanNet's single heading bin has no heading loss
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(want[6]))
    _close(got[7]["cls_acc"], want[7]["cls_acc"])


def test_iou_labels_match_jax(dataset_setup):
    """On SUN RGB-D the GT boxes are rotated: the clipping and the
    ``pairs_apart`` rejection see turned extents."""
    from iou3dmatch_tpu.losses import iou_labels as jil

    setup = dataset_setup
    jep, jb, pep, pb = _loss_inputs(setup)
    keys = ("aggregated_vote_xyz", "center", "heading_scores", "heading_residuals",
            "size_scores", "size_residuals")
    want = jil.compute_iou_labels(jb, *(jep[k] for k in keys), setup.cfg)
    got = plabels.compute_iou_labels(pb, *(pep[k] for k in keys), setup.pcfg)
    _close(got[0], want[0], atol=1e-5)
    assert float(want[0].max()) > 0.05  # the GT boxes overlap some proposals
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _close(plabels._gt_boxes(pb, setup.pcfg), jil._gt_boxes(jb, setup.cfg), atol=0)
    size = np.abs(setup.ep["size"]) * 2
    size[0, 0] = -1.0  # a non-positive size is clamped to 1e-6
    want = jil.compute_iou_from_given_size(jb, jep["center"], jnp.asarray(size), jep["heading"],
                                           setup.cfg)
    got = plabels.compute_iou_from_given_size(pb, pep["center"], _t(size), pep["heading"],
                                              setup.pcfg)
    for g, w in zip(got, want):
        _close(g, w, atol=1e-5)


def test_labeled_loss_and_metrics_match_jax(dataset_setup):
    from iou3dmatch_tpu.losses import get_labeled_loss as jax_labeled_loss

    setup = dataset_setup
    jep, jb, pep, pb = _loss_inputs(setup)
    want_loss, want = jax_labeled_loss(jep, jb, setup.cfg, B)
    got_loss, got = plabeled.get_labeled_loss(pep, pb, setup.pcfg, B)
    assert set(got) == set(want)
    _close(got_loss, want_loss, rtol=1e-4)
    for k in want:
        _close(got[k], want[k], rtol=1e-4, what=k)
    assert float(want["pos_ratio"]) > 0 and float(want["obj_count"]) >= B * (G - 2)
    assert float(want["jitter_iou_loss"]) > 0 and float(want["center_loss"]) > 0


def test_eval_loss_and_eval_forward_metrics_match_jax(setup, loss_inputs):
    from iou3dmatch_tpu.losses import get_loss as jax_get_loss

    jep, jb, pep, pb = loss_inputs
    want_loss, want = jax_get_loss(jep, jb, setup.cfg)
    got_loss, got = get_loss(pep, pb, setup.pcfg)
    assert set(got) == set(want)
    _close(got_loss, want_loss, rtol=1e-4)
    for k in want:
        _close(got[k], want[k], rtol=1e-4, what=k)
    # the eval forward: eval mode, metrics beside the outputs
    pm = port_model(setup)
    labels = {k: v for k, v in pb.items() if k != "point_clouds"}
    out, metrics = make_eval_loss(pm, setup.pcfg)(pb["point_clouds"], labels)
    assert not pm.training and "loss" in metrics and set(want) <= set(metrics)
    assert torch.isfinite(metrics["loss"]) and out["center"].shape == (B, 16, 3)


# --------------------------------------------------- gradients and the step

BRANCHES = ("backbone_net", "vgen", "pnet")


def test_grid_conv_stops_the_gradient_in_both_packages(setup):
    """The IoU predictions give zero gradient to every backbone, voting
    and proposal parameter, in JAX (stop_gradient at grid_conv.py:124-125)
    and in the port (the seeds are detached)."""
    jm = setup.jm

    def iou_only(params):
        ep = jm.apply({"params": params, "batch_stats": setup.variables["batch_stats"]},
                      jnp.asarray(setup.pc), setup.key, train=True, momentum=MOMENTUM,
                      mutable=["batch_stats"], method=jm.forward_with_pred_jitter)[0]
        return jnp.sum(jax.nn.sigmoid(ep["iou_scores"])) + jnp.sum(
            jax.nn.sigmoid(ep["iou_scores_jitter"]))

    grads = _np_tree(jax.jit(jax.grad(iou_only))(setup.variables["params"]))
    for branch in BRANCHES:
        assert all((leaf == 0).all() for leaf in jax.tree.leaves(grads[branch])), branch
    assert any(np.abs(leaf).max() > 0 for leaf in jax.tree.leaves(grads["grid_conv"]))
    pm = port_model(setup)
    set_bn_momentum(pm, MOMENTUM)
    noise = tuple(map(_t, jitter_noise(setup.key, B, 16)))
    ep = pm.forward_with_pred_jitter(_t(setup.pc), noise=noise)
    (torch.sigmoid(ep["iou_scores"]).sum() + torch.sigmoid(ep["iou_scores_jitter"]).sum()).backward()
    for name, p in pm.named_parameters():
        if name.startswith(BRANCHES):
            assert p.grad is None or not p.grad.any(), name
    assert any(p.grad is not None and p.grad.any() for p in pm.grid_conv.parameters())


FD_CASES = [  # (loss terms, parameters moved together)
    ("detection", "backbone_net.sa4.mlp_module.layer1.conv.weight"),
    ("detection", "vgen.conv1.weight"),  # through vote aggregation's gather backward
    ("detection", "pnet.vote_aggregation.mlp_module.layer0.conv.weight"),
    ("detection", "pnet.conv1.weight"),
    ("iou", "grid_conv.mlp_before_iou.layer0.conv.weight"),
    ("iou", "grid_conv.conv1_iou.weight"),
]


@pytest.mark.parametrize("terms,name", FD_CASES)
def test_pretrain_gradient_matches_finite_differences(setup, terms, name):
    """The port's float64 gradient against central differences along a
    random direction (step 1e-7, rtol 1e-4): a check of the backward that
    rests on neither package's float32 sums. The IoU labels are detached
    on purpose, as in JAX and the reference, so the loss is split: the
    detection terms (vote, objectness, box, semantic class), whose labels
    are piecewise constant in the weights, and the IoU terms for GridConv,
    whose labels do not depend on its weights. Deeper backbone weights
    are left out: near-ties of their max pools put kinks within any step."""
    pm = port_model(setup).double()
    set_bn_momentum(pm, MOMENTUM)
    batch = {k: (v.double() if v.is_floating_point() else v)
             for k, v in torch_batch(setup.batch).items()}
    noise = tuple(_t(x).double() for x in jitter_noise(setup.key, B, 16))
    state = {k: v.clone() for k, v in pm.state_dict().items()}
    param = dict(pm.named_parameters())[name]

    def loss():
        ep = pm.forward_with_pred_jitter(batch["point_clouds"], noise=noise)
        m = plabeled.get_labeled_loss(ep, batch, setup.pcfg, B)[1]
        if terms == "iou":
            return m["iou_loss"] + m["jitter_iou_loss"]
        return m["vote_loss"] + 0.5 * m["objectness_loss"] + m["box_loss"] + 0.1 * m["sem_cls_loss"]

    loss().backward()
    d = torch.randn(param.shape, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    want = float((param.grad * d).sum())
    vals = []
    for sign in (1.0, -1.0):
        pm.load_state_dict(state)  # running statistics too
        with torch.no_grad():
            param.add_(sign * 1e-7 * d)
            vals.append(float(loss()))
    np.testing.assert_allclose((vals[0] - vals[1]) / 2e-7, want, rtol=1e-4)
    assert abs(want) > 1e-3


def _flat(tree_a, tree_b):
    a = np.concatenate([np.asarray(tree_a[k], np.float64).ravel() for k in sorted(tree_b)])
    b = np.concatenate([np.asarray(tree_b[k], np.float64).ravel() for k in sorted(tree_b)])
    return a, b


def _drift(got: dict, want: dict) -> float:
    """Max over parameters of max |got - want| over the parameter's scale."""
    return max(float((got[k] - want[k]).abs().max()) / max(float(want[k].abs().max()), 1e-3)
               for k in want)


def test_adam_matches_optax():
    """One torch Adam step against optax add_decayed_weights + scale_by_adam."""
    from iou3dmatch_tpu.train.state import make_optimizer as jax_optimizer

    rng = np.random.RandomState(9)
    p0, grads = rng.randn(3, 50).astype(np.float32), rng.randn(3, 3, 50).astype(np.float32)
    for wd in (0.0, 1e-2):
        tx = jax_optimizer(wd, eps=1e-8)
        jp, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
        p = torch.nn.Parameter(_t(p0))
        opt = make_optimizer([p], weight_decay=wd, eps=1e-8)
        for g in grads:
            updates, state = tx.update(jnp.asarray(g), state, jp)
            jp = jp - LR * updates
            for group in opt.param_groups:
                group["lr"] = LR
            p.grad = _t(g)
            opt.step()
        _close(p.detach(), jp, atol=1e-6)
        assert not np.allclose(np.asarray(jp), p0)


def test_step0_gradient_matches_jax(dataset_setup):
    """The whole step-0 gradient in float32 against JAX's: cosine > 0.999
    and relative L2 < 0.05, the JAX package's own step-0 bounds against the
    reference. Two float32 hazards stand behind it: PyTorch's CPU
    batch_norm kernel loses precision on channels whose mean dwarfs their
    spread, which put the port's own float32 and float64 gradients at
    cosine 0.998 until the CPU path wrote the two-pass statistics out
    (models/mlp.py); and JAX's float32 statistics can be far off too: on 6
    scenes of this recipe its gradient has cosine 0.589 with the port's
    float64 one, which central differences confirm
    (tests/torch_grad_precision.py; ROADMAP.md, Queue 3)."""
    from iou3dmatch_tpu.losses import get_labeled_loss as jax_labeled_loss

    setup = dataset_setup
    jm, cfg = setup.jm, setup.cfg
    key = jax.random.fold_in(jax.random.PRNGKey(42), 0)
    jb = {k: jnp.asarray(v) for k, v in setup.batch.items()}

    def loss(p):
        ep = jm.apply({"params": p, "batch_stats": setup.variables["batch_stats"]},
                      jb["point_clouds"], key, train=True, momentum=MOMENTUM,
                      mutable=["batch_stats"], method=jm.forward_with_pred_jitter)[0]
        return jax_labeled_loss(ep, jb, cfg, B)[0]

    want = state_dict_from_jax({"params": _np_tree(
        jax.jit(jax.grad(loss))(setup.variables["params"]))})
    pm = port_model(setup)
    set_bn_momentum(pm, MOMENTUM)
    batch = torch_batch(setup.batch)
    ep = pm.forward_with_pred_jitter(batch["point_clouds"],
                                     noise=tuple(map(_t, jitter_noise(key, B, 16))))
    plabeled.get_labeled_loss(ep, batch, setup.pcfg, B)[0].backward()
    got = {k: p.grad for k, p in pm.named_parameters()}
    assert set(want) == set(got)
    g_port, g_jax = _flat(got, want)
    cos = g_port @ g_jax / (np.linalg.norm(g_port) * np.linalg.norm(g_jax))
    rel_l2 = np.linalg.norm(g_port - g_jax) / np.linalg.norm(g_jax)
    assert cos > 0.999, f"step-0 gradient cosine {cos}"
    assert rel_l2 < 0.05, f"step-0 gradient relative L2 {rel_l2}"


def test_pretrain_trajectory_matches_jax(dataset_setup):
    """3 steps of the port's make_pretrain_step against 3 of the JAX one,
    in float32, from the same weights, batches and jitter draws: the
    step-0 loss, the BN running statistics after step 0, later losses and
    the final parameters (tolerances in the module docstring)."""
    from iou3dmatch_tpu.train import make_pretrain_step as jax_pretrain_step
    from iou3dmatch_tpu.train.state import TrainState
    from iou3dmatch_tpu.train.state import make_optimizer as jax_optimizer
    from jax.flatten_util import ravel_pytree

    setup = dataset_setup
    jm, cfg = setup.jm, setup.cfg
    keys = [jax.random.fold_in(jax.random.PRNGKey(42), i) for i in range(3)]
    batches = [setup.batch]
    for i in (1, 2):
        pc = scenes(100 + i)
        anchors = setup.forward(setup.variables, jnp.asarray(pc), keys[i])[0][
            "aggregated_vote_xyz"]
        batch = labels_near(200 + i, np.asarray(anchors), cfg)
        batch["point_clouds"] = pc
        batches.append(batch)

    params = setup.variables["params"]
    jstate = TrainState(params=params, batch_stats=setup.variables["batch_stats"],
                        opt_state=jax_optimizer().init(ravel_pytree(params)[0]),
                        step=jnp.zeros((), jnp.int32))
    jax_step = jax_pretrain_step(jm, cfg, adam_eps=ADAM_EPS)
    jax_losses, stats0 = [], None
    jstate = jax.tree.map(jnp.copy, jstate)
    for i, batch in enumerate(batches):
        jstate, metrics = jax_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                   keys[i], LR, MOMENTUM)
        jax_losses.append(float(metrics["loss"]))
        if i == 0:
            stats0 = state_dict_from_jax({"batch_stats": _np_tree(jstate.batch_stats)})
    jax_final = state_dict_from_jax({"params": _np_tree(jstate.params)})

    def run_port(perturb):
        pm = port_model(setup)
        state = create_train_state(pm, adam_eps=ADAM_EPS)
        step = make_pretrain_step(setup.pcfg)
        losses, bn0 = [], None
        for i, batch in enumerate(batches):
            tb = torch_batch(batch)
            if perturb:
                tb["point_clouds"] = tb["point_clouds"] + 1e-6 * _t(
                    np.random.RandomState(1234 + i).randn(*batch["point_clouds"].shape)
                    .astype(np.float32))
            noise = tuple(map(_t, jitter_noise(keys[i], B, 16)))
            metrics = step(state, tb, LR, MOMENTUM, noise=noise)
            losses.append(float(metrics["loss"]))
            if i == 0:
                bn0 = {k: v.clone() for k, v in pm.state_dict().items() if "running" in k}
        assert state.step == 3 and set(metrics) >= {"loss", "iou_loss", "jitter_iou_loss"}
        return losses, bn0, {k: p.detach().clone() for k, p in pm.named_parameters()}

    losses, bn0, final = run_port(perturb=False)
    chaos_losses, _, chaos_final = run_port(perturb=True)

    np.testing.assert_allclose(losses[0], jax_losses[0], rtol=2e-3)
    for k, v in stats0.items():
        _close(bn0[k], v, rtol=1e-3, atol=1e-3, what=k)
    chaos = max(abs(a - c) / abs(a) for a, c in zip(losses[1:], chaos_losses[1:]))
    for i in (1, 2):
        cross = abs(losses[i] - jax_losses[i]) / abs(jax_losses[i])
        assert cross <= max(4 * chaos, 0.02), (i, losses, chaos_losses, jax_losses)
    self_drift = _drift(final, chaos_final)
    cross_drift = _drift(final, {k: v for k, v in jax_final.items() if k in final})
    assert cross_drift <= max(4 * self_drift, 5e-3), (cross_drift, self_drift)
