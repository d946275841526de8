"""The port's bf16 VoteNet, whole, against the JAX package's
``build_votenet(compute_dtype="bfloat16", f32_gridconv=...)`` on the CPU:
the eval forward and the pretrain step, for ``--bf16`` and ``--bf16
--f32_gridconv``.

The inputs are tests/test_torch_train.py's: the tiny ScanNet VoteNet, its
f32 weights with perturbed BN statistics crossed over by
``state_dict_from_jax`` (one state dict serves both dtypes), 2 scenes of
2,048 points, GT boxes at the proposals' vote centers and JAX's own
jitter draws. JAX's backbone SA layers take their exact ball query.

Tolerances, and why:

- The eval forward: every index equal; end points within atol 1e-3 plus
  rtol 1e-3 (bf16 flips in the backbone reach the f32 heads as changes of
  a few 1e-4; the IoU logits, whose GridConv runs in bf16, within 5e-3);
  the objectness logits' correlation > 0.98, JAX's own bound for bf16
  against f32 (tests/test_model.py:227-244), here > 0.9999.
- The pretrain step's loss and step-0 gradient. In bf16 the tiny model's
  train-mode step is chaotic: random weights leave channels of tiny
  spread, whose batch statistics turn a one-ulp bf16 flip into O(0.1) in
  the heads. With every index equal, the packages' seed features stand
  0.29 apart (of 6.3) in train mode and 0.016 (of 17.5) in eval mode; the
  port's own step from clouds moved by 1e-5 (which also moves FPS's picks)
  has gradient cosine 0.72 to the unmoved one and a loss 1.4e-4 apart.
  The packages agree as closely: loss rtol 2e-3 (measured 4.7e-4),
  gradient cosine > 0.7 (measured 0.765). Both gates tell bf16 from f32:
  JAX's bf16 loss is 3.5e-2 from its f32 loss, and its bf16 gradient at
  cosine 0.56 to its f32 one.
"""
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from iou3dmatch_tpu_torch.models.factory import build_votenet  # noqa: E402
from iou3dmatch_tpu_torch.models.mlp import set_bn_momentum  # noqa: E402
from iou3dmatch_tpu_torch.train.state import create_train_state  # noqa: E402
from iou3dmatch_tpu_torch.train.steps import make_pretrain_step  # noqa: E402
from iou3dmatch_tpu_torch.train.torch_import import state_dict_from_jax  # noqa: E402
from torch_bf16_cases import cosine  # noqa: E402

T = importlib.import_module("test_torch_train")
jp = pytest.importorskip("iou3dmatch_tpu.models.pointnet2")
torch.set_num_threads(1)
FLAGS = [False, True]
FLAG_IDS = ["bf16", "bf16_f32_gridconv"]


@pytest.fixture(scope="module", autouse=True)
def exact_jax_ball_query():
    real = jp.ball_query
    jp.ball_query = lambda r, ns, xyz, new_xyz, exact=False: real(r, ns, xyz, new_xyz, exact=True)
    yield
    jp.ball_query = real


@pytest.fixture(scope="module")
def setup(exact_jax_ball_query):
    return T.make_setup("scannet")


def jax_model(f32_gridconv):
    from iou3dmatch_tpu.models.factory import build_votenet as build_jax

    return build_jax("scannet", tiny=True, compute_dtype="bfloat16", f32_gridconv=f32_gridconv)[0]


def port_model(setup, f32_gridconv, train):
    pm, _ = build_votenet("scannet", tiny=True, device="cpu", compute_dtype="bfloat16",
                          f32_gridconv=f32_gridconv)
    pm.load_state_dict(state_dict_from_jax(setup.variables), strict=True)
    set_bn_momentum(pm, T.MOMENTUM)
    return pm.train(train)


@pytest.mark.parametrize("f32_gridconv", FLAGS, ids=FLAG_IDS)
def test_bf16_eval_forward_matches_jax(setup, f32_gridconv):
    jm = jax_model(f32_gridconv)
    want = T._np_tree(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        setup.variables, jnp.asarray(setup.pc)))
    with torch.no_grad():
        got = port_model(setup, f32_gridconv, False)(T._t(setup.pc))
    for k in ("sa1_inds", "sa2_inds", "seed_inds", "aggregated_vote_inds"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in ("vote_xyz", "center", "objectness_scores", "sem_cls_scores", "heading_scores",
              "size_residuals", "iou_scores"):
        assert got[k].dtype == torch.float32, k
        atol = 5e-3 if k == "iou_scores" else 1e-3
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-3, atol=atol, err_msg=k)
    assert np.corrcoef(got["objectness_scores"].numpy().ravel(),
                       want["objectness_scores"].ravel())[0, 1] > 0.9999


@pytest.mark.parametrize("f32_gridconv", FLAGS, ids=FLAG_IDS)
def test_bf16_pretrain_step_matches_jax(setup, f32_gridconv):
    """One make_pretrain_step in each package from the same weights, batch
    and jitter draws: the loss and the step-0 gradient (module docstring);
    f32 parameters, gradients and BN statistics after it."""
    from iou3dmatch_tpu.train import make_pretrain_step as jax_pretrain_step
    from iou3dmatch_tpu.train.state import TrainState
    from iou3dmatch_tpu.train.state import make_optimizer as jax_optimizer
    from jax.flatten_util import ravel_pytree

    jm = jax_model(f32_gridconv)
    params = setup.variables["params"]
    jstate = TrainState(params=params, batch_stats=setup.variables["batch_stats"],
                        opt_state=jax_optimizer(eps=T.ADAM_EPS).init(ravel_pytree(params)[0]),
                        step=jnp.zeros((), jnp.int32))
    jstate = jax.tree.map(jnp.asarray, jstate)
    key = jax.random.fold_in(jax.random.PRNGKey(42), 0)
    new, jmetrics = jax_pretrain_step(jm, setup.cfg, adam_eps=T.ADAM_EPS)(
        jstate, {k: jnp.asarray(v) for k, v in setup.batch.items()}, key, T.LR, T.MOMENTUM)
    mu = np.asarray(new.opt_state.mu, np.float32) / np.float32(0.1)  # (1 - 0.9) g
    want = state_dict_from_jax({"params": ravel_pytree(params)[1](mu)})

    pm = port_model(setup, f32_gridconv, True)
    state = create_train_state(pm, adam_eps=T.ADAM_EPS)
    metrics = make_pretrain_step(setup.pcfg)(state, T.torch_batch(setup.batch), T.LR, T.MOMENTUM,
                                             noise=tuple(map(T._t, T.jitter_noise(key, 2, 16))))
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=2e-3)
    grads = {k: p.grad for k, p in pm.named_parameters()}
    keys = sorted(want)
    assert set(grads) == set(want)
    flat = [np.concatenate([np.asarray(t[k], np.float64).ravel() for k in keys])
            for t in (grads, want)]
    assert cosine(*flat) > 0.7
    for k, p in pm.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, k
    for k, b in pm.named_buffers():
        assert b.dtype == torch.float32, k
