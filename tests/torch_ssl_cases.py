"""Inputs shared by the SSL tests of the port (tests/test_torch_ssl*.py).

A tiny JAX VoteNet (ScanNet config, or SUN RGB-D's with ``make_setup("sunrgbd")``:
10 classes, 12 heading bins, rotated GT, the SSL step's ``trans_angle``;
``tiny=True``, 16 proposals) with BN
running statistics perturbed away from (0, 1), and a teacher whose
parameters are the student's times (1 + 0.01 N(0, 1)) and whose running
statistics are perturbed on their own, so that the EMA's mix and the
teacher's BN updates show. One labeled and one unlabeled scene of 2,048
points, the batch recipe of tests/test_train.py::_ssl_batch and
tests/test_trajectory_diff.py:370-380: the teacher sees the scenes as
they are, the student after flips, a rotation about z of up to 0.1 rad
and a scale in [0.9, 1.1]. Every scene has real labels (view-stats reads
the unlabeled scene's): the labeled scene's GT boxes sit near the
student's vote centers, the unlabeled scene's near the teacher's, in the
teacher's frame. The pseudo-label thresholds are quantiles of the
teacher's own outputs, so that a share of its boxes passes. Everything is
made from NumPy seeds and handed to both packages.
"""
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import torch
from jax.flatten_util import ravel_pytree

from iou3dmatch_tpu_torch.data.config import get_config
from iou3dmatch_tpu_torch.models.factory import build_votenet
from iou3dmatch_tpu_torch.train.state import create_train_state
from iou3dmatch_tpu_torch.train.steps import make_ssl_step
from iou3dmatch_tpu_torch.train.torch_import import state_dict_from_jax
from tests.test_torch_train import jitter_noise, labels_near, perturb_batch_stats, scenes

K = 16  # the tiny model's proposals
MOMENTUM = 0.5  # epoch 0 of the BN momentum schedule
LR = 2e-3  # train.py:49
ADAM_EPS = 1e-3  # at 1e-8 the first update is lr * sign(g), see tests/test_torch_train.py
# (reference_exact, full_teacher, exact_jitter, view_stats)
KNOBS = {
    "reference_exact": (True, False, False, True),
    "pruned": (False, False, False, False),
    "full_teacher": (False, True, False, True),
    "exact_jitter": (False, False, True, False),
}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, atol=0.0, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def augment(pc, seed, dataset="scannet"):
    """The student's view of ``pc`` (b, n, 4): flips, rotation about z,
    scale, as the SSL datasets make it; returns (clouds, batch keys). SUN
    RGB-D's datasets never flip y and turn by up to 30 degrees: the same
    draws, flip_y set to 0 and the angles scaled by (pi / 6) / 0.1."""
    rng = np.random.RandomState(seed)
    b = pc.shape[0]
    flip_x, flip_y = rng.randint(0, 2, b), rng.randint(0, 2, b)
    angles = rng.uniform(-0.1, 0.1, b)
    if dataset == "sunrgbd":
        flip_y[:] = 0
        angles = angles * (np.pi / 6) / 0.1
    angles = angles.astype(np.float32)
    c, s = np.cos(angles), np.sin(angles)
    zero, one = np.zeros(b), np.ones(b)
    rot_mat = np.stack([np.stack([c, -s, zero], -1), np.stack([s, c, zero], -1),
                        np.stack([zero, zero, one], -1)], 1).astype(np.float32)
    scale = np.tile(rng.uniform(0.9, 1.1, (b, 1, 1)), (1, 1, 3)).astype(np.float32)
    xyz = pc[..., 0:3].copy()
    xyz[..., 0] = np.where(flip_x[:, None] > 0, -xyz[..., 0], xyz[..., 0])
    xyz[..., 1] = np.where(flip_y[:, None] > 0, -xyz[..., 1], xyz[..., 1])
    out = pc.copy()
    out[..., 0:3] = np.einsum("bnc,bdc->bnd", xyz, rot_mat) * scale
    return out.astype(np.float32), {"flip_x_axis": flip_x.astype(np.int64),
                                     "flip_y_axis": flip_y.astype(np.int64),
                                     "rot_mat": rot_mat, "rot_angle": angles, "scale": scale}


def thresholds(ep, rows, between=False):
    """Pseudo-label thresholds at quantiles of the teacher outputs ``ep``
    on scenes ``rows``: a share of the boxes passes each. The 0.2 quantile
    of 16 scores is one box's own score, which each package computes to its
    own last bits, so that box may pass in one and not in the other. With
    ``between`` each threshold lies halfway between the two scores around
    its quantile instead (SUN RGB-D's setup, whose box at the IoU quantile
    passed in JAX only)."""
    import scipy.special as sp

    pos_obj = sp.softmax(ep["objectness_scores"][rows], -1)[..., 1]
    cls_probs = sp.softmax(ep["sem_cls_scores"][rows], -1)
    iou = sp.expit(np.take_along_axis(ep["iou_scores"][rows], cls_probs.argmax(-1)[..., None],
                                      axis=2)[..., 0])

    def at(x, q):
        if not between:
            return float(np.quantile(x, q))
        v = np.sort(x.ravel())
        i = int(q * (v.size - 1))
        return float((v[i] + v[i + 1]) / 2)

    return dict(obj_threshold=at(pos_obj, 0.3), cls_threshold=at(cls_probs.max(-1), 0.3),
                iou_threshold=at(iou, 0.2))


def make_setup(dataset="scannet"):
    from iou3dmatch_tpu.models.factory import build_votenet as build_jax

    jm, cfg = build_jax(dataset, tiny=True)
    ema_pc = scenes(31)
    pc, aug = augment(ema_pc, 32, dataset)
    variables = jax.jit(lambda x: jm.init({"params": jax.random.PRNGKey(4)}, x, train=False))(
        jnp.asarray(pc))
    variables = perturb_batch_stats(np_tree(dict(variables)))
    rng = np.random.RandomState(33)
    ema = {"params": jax.tree.map(
        lambda x: (x * (1.0 + 0.01 * rng.randn(*x.shape))).astype(np.float32),
        variables["params"]),
        "batch_stats": perturb_batch_stats(variables, seed=34)["batch_stats"]}
    forward = jax.jit(
        lambda v, x, key: jm.apply(v, x, key, train=True, momentum=MOMENTUM,
                                   mutable=["batch_stats"], method=jm.forward_with_pred_jitter)[0])
    key = jax.random.PRNGKey(5)
    t_key, s_key = jax.random.split(key)
    teacher = np_tree(forward(ema, jnp.asarray(ema_pc), t_key))
    student = np_tree(forward(variables, jnp.asarray(pc), s_key))
    labeled = labels_near(35, student["aggregated_vote_xyz"][:1], cfg)
    unlabeled = labels_near(36, teacher["aggregated_vote_xyz"][1:], cfg)
    batch = {k: np.concatenate([labeled[k], unlabeled[k]]) for k in labeled}
    batch.update(aug, point_clouds=pc, ema_point_clouds=ema_pc)
    return SimpleNamespace(jm=jm, cfg=cfg, pcfg=get_config(dataset), variables=variables,
                           ema=ema, batch=batch, key=key, forward=forward, teacher=teacher,
                           thr=thresholds(teacher, slice(1, None), dataset == "sunrgbd"),
                           dataset=dataset)


def knobs(name):
    reference_exact, full_teacher, exact_jitter, view_stats = KNOBS[name]
    return dict(reference_exact=reference_exact, full_teacher=full_teacher,
                exact_jitter=exact_jitter, view_stats=view_stats)


def jax_state(setup):
    from iou3dmatch_tpu.train.state import TrainState
    from iou3dmatch_tpu.train.state import make_optimizer as jax_optimizer

    params = setup.variables["params"]
    state = TrainState(params=params, batch_stats=setup.variables["batch_stats"],
                       opt_state=jax_optimizer(eps=ADAM_EPS).init(ravel_pytree(params)[0]),
                       step=jnp.zeros((), jnp.int32), ema_params=setup.ema["params"],
                       ema_batch_stats=setup.ema["batch_stats"])
    return jax.tree.map(jnp.asarray, state)


def jax_ssl_step(setup, name):
    from iou3dmatch_tpu.train import make_ssl_step as jax_make_ssl_step

    return jax_make_ssl_step(setup.jm, setup.cfg, 1, adam_eps=ADAM_EPS, dataset=setup.dataset,
                             **setup.thr, **knobs(name))


def jax_gradient(params, new_state):
    """The step-0 gradient from the Adam state after one step: the first
    moment is (1 - 0.9) g."""
    mu = new_state.opt_state.mu
    return ravel_pytree(params)[1](np.asarray(mu, np.float32) / np.float32(0.1))


def port_state(setup):
    pm, _ = build_votenet(setup.dataset, tiny=True, device="cpu")
    pm.load_state_dict(state_dict_from_jax(setup.variables), strict=True)
    state = create_train_state(pm, adam_eps=ADAM_EPS, with_ema=True)
    state.ema_model.load_state_dict(state_dict_from_jax(setup.ema), strict=True)
    return state


def port_ssl_step(setup, name):
    return make_ssl_step(setup.pcfg, 1, dataset=setup.dataset, **setup.thr, **knobs(name))


def port_noise(key, name, b=2):
    """The jitter draws of the JAX step for ``key``: t_key, s_key =
    split(key), each giving forward_with_pred_jitter's two draws."""
    reference_exact, full_teacher, _, _ = KNOBS[name]
    t_key, s_key = jax.random.split(key)
    n_teacher = b if reference_exact or full_teacher else b - 1
    return (tuple(map(t, jitter_noise(t_key, n_teacher, K))),
            tuple(map(t, jitter_noise(s_key, b, K))))


def torch_batch(batch):
    return {k: t(v) for k, v in batch.items()}


def sa1_inds_of(state):
    """Hooks that keep the SA1 indices each of the two forwards was given."""
    seen = {}
    hooks = [m.backbone_net.register_forward_hook(
        lambda mod, a, ep, who=who: seen.__setitem__(who, ep["sa1_inds"].clone()))
        for who, m in (("teacher", state.ema_model), ("student", state.model))]
    return seen, hooks


def flat(tree, keys):
    return np.concatenate([np.asarray(tree[k], np.float64).ravel() for k in keys])


def cosine_and_rel_l2(got, want):
    return (float(got @ want / (np.linalg.norm(got) * np.linalg.norm(want))),
            float(np.linalg.norm(got - want) / np.linalg.norm(want)))


def run_port_step(setup, name, dtype=torch.float32):
    """One port SSL step from the setup's weights and batch, fed the JAX
    step's jitter draws; in float64 with ``dtype``. Returns (state,
    metrics, {"teacher", "student"}: SA1 indices)."""
    state = port_state(setup)
    batch = torch_batch(setup.batch)
    noise = port_noise(setup.key, name)
    if dtype == torch.float64:
        state.model.double()
        state.ema_model.double()
        batch = {k: (v.double() if v.is_floating_point() else v) for k, v in batch.items()}
        noise = tuple(tuple(x.double() for x in pair) for pair in noise)
    seen, hooks = sa1_inds_of(state)
    try:
        metrics = port_ssl_step(setup, name)(state, batch, LR, MOMENTUM, noise=noise)
    finally:
        for h in hooks:
            h.remove()
    assert state.step == 1
    return state, metrics, seen


def check_one_step(setup, name):
    """One make_ssl_step with the knobs ``name`` in both packages and in
    the port's float64 (tolerances in tests/test_torch_ssl.py)."""
    from iou3dmatch_tpu.ops.fps import furthest_point_sample as jax_fps
    from iou3dmatch_tpu_torch.train.state import make_optimizer
    from iou3dmatch_tpu_torch.train.steps import ema_update

    jstate = jax_state(setup)
    jbatch = {k: jnp.asarray(v) for k, v in setup.batch.items()}
    new, jmetrics = jax_ssl_step(setup, name)(jstate, jbatch, setup.key, LR, MOMENTUM)
    jmetrics = np_tree(jmetrics)
    state, metrics, seen = run_port_step(setup, name)
    state64, metrics64, _ = run_port_step(setup, name, torch.float64)

    # the shared FPS: the teacher's clouds, then the student's
    reference_exact, full_teacher = KNOBS[name][:2]
    ema_clouds = setup.batch["ema_point_clouds"][0 if reference_exact or full_teacher else 1:]
    xyz = np.concatenate([ema_clouds[..., 0:3], setup.batch["point_clouds"][..., 0:3]])
    np.testing.assert_array_equal(
        np.concatenate([seen["teacher"].numpy(), seen["student"].numpy()]),
        np.asarray(jax_fps(jnp.asarray(xyz), 128)))

    assert set(metrics) == set(jmetrics) and "unlabeled_detection_loss" in metrics
    assert float(metrics["pseudo_gt_ratio"]) > 0
    for k, v in jmetrics.items():
        close(metrics[k], metrics64[k], rtol=1e-4, atol=1e-7, what=f"{k} against float64")
        close(metrics[k], v, rtol=1e-3, atol=1e-7, what=k)

    grads = {k: p.grad for k, p in state.model.named_parameters()}
    want = state_dict_from_jax({"params": jax_gradient(setup.variables["params"], new)})
    keys = sorted(want)
    assert set(grads) == set(want)
    cos, rel = cosine_and_rel_l2(flat(grads, keys), flat(want, keys))
    assert cos > 0.999 and rel < 0.05, (cos, rel)
    grads64 = {k: p.grad for k, p in state64.model.named_parameters()}
    cos, rel = cosine_and_rel_l2(flat(grads, keys), flat(grads64, keys))
    assert cos > 0.99999 and rel < 1e-3, (cos, rel)

    # the teacher's BN running statistics after its train-mode forward
    ema_want = state_dict_from_jax({"params": np_tree(new.ema_params),
                                    "batch_stats": np_tree(new.ema_batch_stats)})
    ema_got, ema64 = state.ema_model.state_dict(), state64.ema_model.state_dict()
    for k in ema_want:
        if "running" in k:
            close(ema_got[k], ema64[k], rtol=1e-4, atol=1e-5, what=f"{k} against float64")
            close(ema_got[k], ema_want[k], rtol=1e-3, atol=1e-3, what=k)

    # the step's EMA, after Adam, at alpha = 1 - 1/(0 + 2)
    ema0 = state_dict_from_jax({"params": setup.ema["params"]})
    teacher = dict(state.ema_model.named_parameters())
    for k, p in state.model.named_parameters():
        assert torch.equal(teacher[k].detach(), ema0[k] * 0.5 + p.detach() * 0.5), k

    # Adam and the EMA on JAX's own gradient give JAX's parameters
    replay = port_state(setup)
    opt = make_optimizer(replay.model.parameters(), eps=ADAM_EPS)
    for group in opt.param_groups:
        group["lr"] = LR
    for k, p in replay.model.named_parameters():
        p.grad = want[k].clone()
    opt.step()
    ema_update(replay.ema_model, replay.model, 0.5)
    jparams = state_dict_from_jax({"params": np_tree(new.params)})
    for k, p in replay.model.named_parameters():
        close(p.detach(), jparams[k], atol=1e-6, what=k)
    ema = dict(replay.ema_model.named_parameters())
    for k in jparams:
        close(ema[k].detach(), ema_want[k], atol=1e-6, what=f"EMA {k}")
    return state, metrics


def drift(got: dict, want: dict) -> float:
    """Max over parameters of max |got - want| over the parameter's scale."""
    return max(float((got[k] - want[k]).abs().max()) / max(float(want[k].abs().max()), 1e-3)
               for k in want)
