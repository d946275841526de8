"""Test-time IoU optimisation of the port against the JAX package, on the CPU.

A tiny JAX VoteNet (``tiny=True``, 16 proposals) of ScanNet and one of SUN
RGB-D (12 heading bins: the headings turn GridConv's grid, so the gradient
goes through the rotation), BN running statistics moved off (0, 1), carried
into the port by ``state_dict_from_jax``. Both take the JAX eval forward's
end points, so the IoU branch starts from the same inputs.

- ``forward_onlyiou``: the IoU logits within atol 1e-4, and the gradient of
  their sum at the argmax classes with respect to center and size within
  2e-3 of the largest gradient entry (JAX interpolates by one-hot matmuls,
  the port by a gather: the same function, summed in another order; the
  gradient is a sum over 64 grid points x 3 neighbours of such terms).
- ``iou_optimize`` at opt_step 5, at opt_rate 5e-4 (train.py:69's rate),
  which moves the tiny models' boxes by 1e-4 to 3e-4, and at 5e-2, which
  moves them by about 1e-2: refined center, size and re-encoded size
  residuals within atol 1e-6, IoU logits within 1e-5. (Measured on these
  inputs: 0 at 5e-4 and at most 2.4e-7 at 5e-2 for the boxes, 7e-7 for
  the logits.)
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.tree_util as jtu  # noqa: E402

from iou3dmatch_tpu_torch.eval.iou_opt import iou_optimize  # noqa: E402
from iou3dmatch_tpu_torch.models.factory import build_votenet  # noqa: E402
from iou3dmatch_tpu_torch.train.torch_import import state_dict_from_jax  # noqa: E402

torch.set_num_threads(1)
OPT_STEP = 5


def _perturb_batch_stats(variables, seed=5):
    rng = np.random.RandomState(seed)

    def perturb(path, x):
        names = [p.key for p in path]
        if names[0] != "batch_stats":
            return x
        if names[-1] == "mean":
            return (rng.randn(*x.shape) * 0.05).astype(x.dtype)
        return (1.0 + rng.uniform(-0.2, 0.2, x.shape)).astype(x.dtype)

    return jtu.tree_map_with_path(perturb, variables)


@pytest.fixture(scope="module", params=["scannet", "sunrgbd"])
def models(request):
    from iou3dmatch_tpu.models.factory import build_votenet as build_jax

    dataset = request.param
    jm, cfg = build_jax(dataset, tiny=True)
    rng = np.random.RandomState(11)
    pc = np.zeros((2, 2048, 4), np.float32)
    pc[..., 0:3] = rng.uniform(-3.0, 3.0, (2, 2048, 3))
    pc[..., 3] = pc[..., 2] - pc[..., 2].min(axis=1, keepdims=True)
    variables = jax.jit(lambda x: jm.init({"params": jax.random.PRNGKey(4)}, x, train=False))(
        jnp.asarray(pc))
    variables = _perturb_batch_stats(jax.tree.map(np.asarray, variables))
    pm, _ = build_votenet(dataset, tiny=True, device="cpu")
    pm.load_state_dict(state_dict_from_jax(variables), strict=True)
    ep = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(pc))
    ep = {k: np.asarray(v) for k, v in ep.items()}
    return dataset, jm, variables, pm, ep


def _torch_ep(ep):
    return {k: torch.from_numpy(v.copy()) for k, v in ep.items()}


def test_forward_onlyiou_and_its_gradient_match_jax(models):
    dataset, jm, variables, pm, ep = models
    sem = np.argmax(ep["sem_cls_scores"], -1)

    def jax_sum(center, size):
        iou = jm.apply(variables, dict(ep), center, size, jnp.asarray(ep["heading"]),
                       method=jm.forward_onlyiou)["iou_scores"]
        return jnp.sum(jnp.take_along_axis(iou, jnp.asarray(sem)[..., None], axis=2)), iou

    (_, want_iou), want_grads = jax.jit(jax.value_and_grad(jax_sum, argnums=(0, 1), has_aux=True))(
        jnp.asarray(ep["center"]), jnp.asarray(ep["size"]))
    tep = _torch_ep(ep)
    c = tep["center"].clone().requires_grad_(True)
    s = tep["size"].clone().requires_grad_(True)
    iou = pm.forward_onlyiou(tep, c, s, tep["heading"])["iou_scores"]
    torch.gather(iou, 2, torch.from_numpy(sem)[..., None]).sum().backward()
    np.testing.assert_allclose(iou.detach().numpy(), np.asarray(want_iou), rtol=0, atol=1e-4)
    for got, want in zip((c.grad, s.grad), want_grads):
        want = np.asarray(want)
        assert np.abs(want).max() > 0, dataset
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3 * np.abs(want).max())


@pytest.mark.parametrize("opt_rate", [5e-4, 5e-2])
def test_iou_optimize_matches_jax(models, opt_rate):
    from iou3dmatch_tpu.eval.iou_opt import iou_optimize as jax_iou_optimize

    dataset, jm, variables, pm, ep = models
    want = jax_iou_optimize(jm, variables, {k: jnp.asarray(v) for k, v in ep.items()},
                            opt_rate, OPT_STEP)
    got = iou_optimize(pm, _torch_ep(ep), opt_rate, OPT_STEP)
    moved = np.abs(np.asarray(want["center"]) - ep["center"]).max()
    assert moved > 5e-5, dataset  # the ascent moved the boxes
    for key, atol in (("center", 1e-6), ("size", 1e-6), ("size_residuals", 1e-6),
                      ("iou_scores", 1e-5)):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]), rtol=0,
                                   atol=atol, err_msg=f"{dataset} {key}")
    for key in set(ep) - {"center", "size", "size_residuals", "iou_scores"}:
        assert got[key] is not None and torch.equal(got[key], _torch_ep({key: ep[key]})[key])
