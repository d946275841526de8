"""One pretrain step with ``fps_prefix=False`` and each ``query_feats``,
against the JAX package's ``make_pretrain_step``, on the CPU.

For each setting a tiny JAX VoteNet (ScanNet config, ``tiny=True``) built
with it is initialised, its BN running statistics perturbed away from (0,
1), and its weights carried into the port's model built with the same
knobs. 2 scenes of 2,048 points get GT boxes near the proposals' vote
centres (the port's train-mode forward on a copy of the model), so the box
losses carry gradient. One step on each side from the same weights, batch
and jitter draws (JAX's, handed to the port), Adam eps 1e-3 as in
``tests/test_torch_train.py``, whose bounds hold the default setting and
hold these: the loss within rtol 2e-3; the step's gradient (JAX's read from
its Adam state, whose first moment is 0.1 g) with cosine > 0.999 and
relative L2 < 0.05; the BN running statistics after the step within rtol
1e-3 and atol 1e-3.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from iou3dmatch_tpu_torch.data.config import get_config  # noqa: E402
from iou3dmatch_tpu_torch.models.factory import build_votenet  # noqa: E402
from iou3dmatch_tpu_torch.models.mlp import set_bn_momentum  # noqa: E402
from iou3dmatch_tpu_torch.train.state import create_train_state  # noqa: E402
from iou3dmatch_tpu_torch.train.steps import make_pretrain_step  # noqa: E402
from iou3dmatch_tpu_torch.train.torch_import import state_dict_from_jax  # noqa: E402
from tests.test_torch_train import (ADAM_EPS, LR, MOMENTUM, jitter_noise, labels_near,  # noqa: E402
                                   perturb_batch_stats, scenes)

torch.set_num_threads(1)
KNOBS = {
    "no_fps_prefix": dict(fps_prefix=False),
    "query_vote": dict(query_feats="vote"),
    "query_seed_vote": dict(query_feats="seed+vote"),
}


@pytest.mark.parametrize("name", sorted(KNOBS))
def test_pretrain_step_matches_jax(name):
    from iou3dmatch_tpu.models.factory import build_votenet as build_jax
    from iou3dmatch_tpu.train import make_pretrain_step as jax_pretrain_step
    from iou3dmatch_tpu.train.state import TrainState
    from iou3dmatch_tpu.train.state import make_optimizer as jax_optimizer

    kw = KNOBS[name]
    jm, cfg = build_jax("scannet", tiny=True, **kw)
    pc = scenes(11)
    variables = jax.jit(lambda x: jm.init({"params": jax.random.PRNGKey(4)}, x, train=False))(
        jnp.asarray(pc))
    variables = perturb_batch_stats(jax.tree.map(np.asarray, dict(variables)))
    weights = state_dict_from_jax(variables)

    def port_model():
        pm, _ = build_votenet("scannet", tiny=True, device="cpu", **kw)
        pm.load_state_dict(weights, strict=True)
        return pm

    probe = port_model().train()
    set_bn_momentum(probe, MOMENTUM)
    with torch.no_grad():
        anchors = probe.forward_backbone(torch.from_numpy(pc))["aggregated_vote_xyz"].numpy()
    batch = labels_near(12, anchors, cfg)
    batch["point_clouds"] = pc
    key = jax.random.fold_in(jax.random.PRNGKey(42), 0)

    params = variables["params"]
    jstate = TrainState(params=params, batch_stats=variables["batch_stats"],
                        opt_state=jax_optimizer(eps=ADAM_EPS).init(ravel_pytree(params)[0]),
                        step=jnp.zeros((), jnp.int32))
    jstate = jax.tree.map(jnp.asarray, jstate)
    jstate, metrics = jax_pretrain_step(jm, cfg, adam_eps=ADAM_EPS)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key, LR, MOMENTUM)
    jax_grad = ravel_pytree(params)[1](np.asarray(jstate.opt_state.mu, np.float32)
                                       / np.float32(0.1))
    want_grad = state_dict_from_jax({"params": jax.tree.map(np.asarray, jax_grad)})
    want_stats = state_dict_from_jax({"batch_stats": jax.tree.map(np.asarray,
                                                                  jstate.batch_stats)})

    pm = port_model()
    state = create_train_state(pm, adam_eps=ADAM_EPS)
    noise = tuple(torch.from_numpy(np.array(x)) for x in jitter_noise(key, 2, 16))
    got = make_pretrain_step(get_config("scannet"))(
        state, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, LR, MOMENTUM,
        noise=noise)

    assert float(metrics["pos_ratio"]) > 0 and float(got["pos_ratio"]) > 0
    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]), rtol=2e-3)
    grads = {k: p.grad for k, p in pm.named_parameters()}
    assert set(grads) == set(want_grad)
    g_port = np.concatenate([grads[k].double().numpy().ravel() for k in sorted(want_grad)])
    g_jax = np.concatenate([want_grad[k].double().numpy().ravel() for k in sorted(want_grad)])
    cos = g_port @ g_jax / (np.linalg.norm(g_port) * np.linalg.norm(g_jax))
    rel_l2 = np.linalg.norm(g_port - g_jax) / np.linalg.norm(g_jax)
    assert cos > 0.999, f"step gradient cosine {cos}"
    assert rel_l2 < 0.05, f"step gradient relative L2 {rel_l2}"
    stats = pm.state_dict()
    for k, v in want_stats.items():
        np.testing.assert_allclose(stats[k].numpy(), v.numpy(), rtol=1e-3, atol=1e-3, err_msg=k)
