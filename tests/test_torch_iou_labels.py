"""``losses/iou_labels.py::compute_iou_labels_axis_aligned`` against the
JAX package's, on the CPU, on tests/test_losses.py:271-295's cases (its
``_mk_batch`` and ``_mk_ep``: 2 scenes, 8 proposals, 4 GT slots with one
empty), perfect proposals on the GT and random ones, for the ScanNet and
SUN RGB-D configs.

Tolerances: the IoU labels, the statistics and the gradient to the
predicted center and size residuals within atol 1e-6 (the same f32 steps);
the zero mask and both assignments equal.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from iou3dmatch_tpu_torch.data.config import get_config  # noqa: E402
from iou3dmatch_tpu_torch.losses.iou_labels import compute_iou_labels_axis_aligned  # noqa: E402
from test_losses import B, G, K, _mk_batch, _mk_ep  # noqa: E402

ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("perfect", [True, False], ids=["perfect", "random"])
@pytest.mark.parametrize("dataset", ["scannet", "sunrgbd"])
def test_axis_aligned_iou_labels_match_jax(dataset, perfect):
    from iou3dmatch_tpu.data.config import get_config as jax_config
    from iou3dmatch_tpu.losses.iou_labels import compute_iou_labels_axis_aligned as jax_labels

    cfg = jax_config(dataset)
    rng = np.random.RandomState(2)
    batch = _mk_batch(rng, cfg)
    ep = _mk_ep(rng, cfg, batch, perfect=perfect)
    origin = rng.randint(0, G, (B, K))
    w = rng.randn(B, K).astype(np.float32)

    def jax_run(center, size_residuals):
        iou, zero, assign, stats = jax_labels(batch, ep["aggregated_vote_xyz"], center,
                                              ep["size_scores"], size_residuals,
                                              jnp.asarray(origin), cfg)
        return jnp.sum(iou * w), (iou, zero, assign, stats)

    (_, want), grads = jax.value_and_grad(jax_run, argnums=(0, 1), has_aux=True)(
        ep["center"], ep["size_residuals"])
    center = _t(ep["center"]).requires_grad_()
    size_res = _t(ep["size_residuals"]).requires_grad_()
    got = compute_iou_labels_axis_aligned(
        {k: _t(v) for k, v in batch.items()}, _t(ep["aggregated_vote_xyz"]), center,
        _t(ep["size_scores"]), size_res, _t(origin), get_config(dataset))
    (got[0] * _t(w)).sum().backward()

    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert set(got[3]) == set(want[3]) == {"acc_pred_iou", "acc_pred_iou_obj"}
    for k in got[3]:
        np.testing.assert_allclose(float(got[3][k].detach()), float(want[3][k]), rtol=0, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(center.grad.numpy(), np.asarray(grads[0]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(size_res.grad.numpy(), np.asarray(grads[1]), rtol=0, atol=ATOL)
    iou, zero = got[0].detach().numpy(), got[1].numpy()
    if perfect and dataset == "scannet":  # heading 0: the proposals on the GT score ~1
        assert (iou[:, : (K // G) * G].reshape(B, -1, G).max(-1) > 0.99).all()
    else:  # some proposals meet no GT and keep their original assignment
        assert zero.any() and (got[2].numpy()[zero == 1] == origin[zero == 1]).all()
    assert np.abs(center.grad.numpy()).max() > 0
