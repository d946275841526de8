"""Inputs of the port's data-parallel step tests (tests/test_torch_parallel_*.py).

The global batch of tests/torch_ssl_cases.py's recipe at twice its size: a
tiny JAX VoteNet (ScanNet config, 16 proposals) with perturbed BN running
statistics, a teacher of its own, and 2 labeled + 2 unlabeled scenes of
2,048 points, so that each of 2 ranks holds 1 + 1 (``[L_r; U_r]``). The
pseudo-label thresholds lie halfway between two of the teacher's own scores
around the 0.3, 0.3 and 0.2 quantiles over both unlabeled scenes
(``torch_ssl_cases.thresholds(between=True)``), so that no box sits on a
threshold and boxes pass on both ranks. ``step_case`` packs one case for
``tests/torch_parallel_ranks.py::run_steps``, which runs it in each rank
under the group and, here, in one process on the whole batch.
"""
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import torch

from iou3dmatch_tpu_torch.data.config import get_config
from iou3dmatch_tpu_torch.train.torch_import import state_dict_from_jax
from tests import torch_ssl_cases as C
from tests.test_torch_train import labels_near, perturb_batch_stats, scenes

BL = BU = 2  # the global batch; each of 2 ranks holds 1 + 1
F32_RTOL = 1e-6  # 8 float32 ulps: a float32 sum split in two, or a ratio's share


def make_setup():
    from iou3dmatch_tpu.models.factory import build_votenet as build_jax

    jm, cfg = build_jax("scannet", tiny=True)
    ema_pc = scenes(41, BL + BU)
    pc, aug = C.augment(ema_pc, 42)
    variables = jax.jit(lambda x: jm.init({"params": jax.random.PRNGKey(6)}, x, train=False))(
        jnp.asarray(pc))
    variables = perturb_batch_stats(C.np_tree(dict(variables)))
    rng = np.random.RandomState(43)
    ema = {"params": jax.tree.map(
        lambda x: (x * (1.0 + 0.01 * rng.randn(*x.shape))).astype(np.float32),
        variables["params"]),
        "batch_stats": perturb_batch_stats(variables, seed=44)["batch_stats"]}
    forward = jax.jit(
        lambda v, x, key: jm.apply(v, x, key, train=True, momentum=C.MOMENTUM,
                                   mutable=["batch_stats"], method=jm.forward_with_pred_jitter)[0])
    key = jax.random.PRNGKey(7)
    t_key, s_key = jax.random.split(key)
    teacher = C.np_tree(forward(ema, jnp.asarray(ema_pc), t_key))
    student = C.np_tree(forward(variables, jnp.asarray(pc), s_key))
    labeled = labels_near(45, student["aggregated_vote_xyz"][:BL], cfg)
    unlabeled = labels_near(46, teacher["aggregated_vote_xyz"][BL:], cfg)
    batch = {k: np.concatenate([labeled[k], unlabeled[k]]) for k in labeled}
    batch.update(aug, point_clouds=pc, ema_point_clouds=ema_pc)
    return SimpleNamespace(jm=jm, cfg=cfg, pcfg=get_config("scannet"), variables=variables,
                           ema=ema, batch=batch, key=key, teacher=teacher,
                           thr=C.thresholds(teacher, slice(BL, None), between=True),
                           dataset="scannet")


def step_case(setup, ssl=True, knobs="reference_exact", dtype=torch.float32,
              sampling="seed_fps", noise=True, steps=2, compute_dtype=None):
    """One case of ``run_steps``: the setup's weights, global batch and, with
    ``noise``, the JAX step's jitter draws at the global shape for the first
    step (later steps, and every step without it, draw from the state's
    generator). The pretrain step trains on the student's view of all four
    scenes, their labels and votes. ``compute_dtype`` goes to
    ``build_votenet`` (bf16 mixed precision)."""
    batch = C.torch_batch(setup.batch)
    if ssl:
        step_noise = C.port_noise(setup.key, knobs, b=BL + BU) if noise else None
        num_labeled = BL
    else:
        step_noise = C.port_noise(setup.key, knobs, b=BL + BU)[1] if noise else None
        batch = {k: v for k, v in batch.items() if k != "ema_point_clouds"}
        num_labeled = BL + BU
    return {"ssl": ssl, "dataset": "scannet", "dtype": dtype, "sampling": sampling,
            "model": state_dict_from_jax(setup.variables),
            "ema": state_dict_from_jax(setup.ema) if ssl else None,
            "batch": batch, "noise": step_noise, "num_labeled": num_labeled,
            "thresholds": setup.thr, "knobs": C.knobs(knobs) if ssl else {},
            "adam_eps": C.ADAM_EPS, "lr": C.LR, "momentum": C.MOMENTUM, "steps": steps,
            "compute_dtype": compute_dtype}


def close(got, want, rtol, what, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def flat(tree: dict) -> np.ndarray:
    return np.concatenate([np.asarray(tree[k], np.float64).ravel() for k in sorted(tree)])


EXACT = dict(metrics=1e-9, grad=1e-9, state=1e-9)  # float64
FLOAT32 = dict(metrics=1e-4, grad=None, state=1e-4)  # the SSL tests' float32 against float64


def check_against_one_process(ranks, want, tol, what="", start=None):
    """Each step of the 2 ranks (``ranks``: each rank's ``run_steps`` output)
    against one process's (``want``), and the two ranks' states equal bit for
    bit. With ``EXACT``: every metric key within rtol 1e-9 (atol 1e-12;
    ``F32_RTOL`` for a metric the step computes in float32 in every run:
    those of the float32 IoU labels and the ratios of counts), the gradient
    summed over the ranks within rtol 1e-9 and atol 1e-9 x its largest
    element (rounding noise where BN makes a bias's gradient 0), the
    parameters after Adam, the teacher after the EMA and both models' BN
    running statistics within rtol 1e-9. With ``FLOAT32``, the SSL tests'
    bounds of the port's float32 against its float64: metrics rtol 1e-4
    (atol 1e-7), the gradient's cosine > 0.99999 and relative L2 < 1e-3,
    running statistics within rtol 1e-4 and atol 1e-5; and the change of
    the parameters and of the teacher's from ``start`` (the case's weights)
    with cosine > 0.999 and relative L2 < 0.05, the bounds of the pretrain
    gradient against JAX: Adam's first step is lr x g / (|g| + eps), which
    turns float32 noise in a near-zero gradient element into a step of up
    to 2 lr."""
    for i, ref in enumerate(want):
        for r, run in enumerate(ranks):
            got = run[i]
            assert set(got["metrics"]) == set(ref["metrics"]), (what, i)
            for k, v in ref["metrics"].items():
                g, w = float(got["metrics"][k]), float(v)
                rtol = tol["metrics"]
                if tol is EXACT and v.dtype != torch.float64:
                    rtol = F32_RTOL
                atol = 1e-12 if tol is EXACT else 1e-7
                assert abs(g - w) <= atol + rtol * abs(w), (what, i, r, k, g, w)
            assert got["step"] == ref["step"]
            assert set(got["grads"]) == set(ref["grads"])
            g, w = flat(got["grads"]), flat(ref["grads"])
            if tol is EXACT:
                close(g, w, tol["grad"], f"{what} step {i} gradient", tol["grad"] * np.abs(w).max())
            else:
                cos = float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w)))
                rel = float(np.linalg.norm(g - w) / np.linalg.norm(w))
                assert cos > 0.99999 and rel < 1e-3, (what, i, cos, rel)
            for part in ("model", "ema"):
                for k, v in ref[part].items():
                    if tol is EXACT:
                        close(got[part][k], v, tol["state"], f"{what} step {i} {part} {k}", 1e-12)
                    elif "running" in k:
                        close(got[part][k], v, tol["state"], f"{what} step {i} {part} {k}", 1e-5)
                if tol is not EXACT:
                    names = sorted(ref["grads"])
                    w0 = {k: start[part][k] for k in names}
                    g = flat({k: got[part][k] for k in names}) - flat(w0)
                    w = flat({k: ref[part][k] for k in names}) - flat(w0)
                    cos = float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w)))
                    rel = float(np.linalg.norm(g - w) / np.linalg.norm(w))
                    assert cos > 0.999 and rel < 0.05, (what, i, part, cos, rel)
        a, b = ranks[0][i], ranks[1][i]
        for part in ("model", "ema", "grads"):
            for k in a[part]:
                assert torch.equal(a[part][k], b[part][k]), (what, i, part, k)
