"""The port's SSL step in bf16 against the JAX package's ``make_ssl_step``
on ``build_votenet(compute_dtype="bfloat16", f32_gridconv=...)``, on the
CPU, with ``reference_exact`` (run_train.sh's setting).

The inputs are tests/torch_ssl_cases.py's: the tiny ScanNet VoteNet, 1
labeled + 1 unlabeled scene, the student's and the teacher's f32 weights
crossed over by ``state_dict_from_jax``, the JAX step's own jitter draws.
JAX's backbone SA layers take their exact ball query.

Tolerances, and why. The bf16 SSL step on 2 scenes is more chaotic still
than the pretrain step (tests/test_torch_bf16_steps.py): the pseudo
labels are picked by thresholds, argmaxes and LHS on the teacher's
outputs, whose train-mode batch statistics over a few dozen rows amplify
one-ulp bf16 flips. The port's own step from clouds moved by 1e-5 (which
also moves FPS's picks) has a loss 75 % apart and gradient cosine 0.10.
The packages agree well inside that: the shared FPS indices equal, the
loss within rtol 2e-2 (measured 9.8e-3), the step-0 gradient at cosine >
0.4 (measured 0.48).
Both gates tell bf16 from f32: JAX's bf16 loss is 0.18 from its f32 loss
and its bf16 gradient at cosine 0.01 to its f32 one. This is the JAX
package's own finding at scale: bf16 occasionally destabilised the SSL
loop, which is why f32 is the default (bench.py).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from iou3dmatch_tpu_torch.models.factory import build_votenet  # noqa: E402
from iou3dmatch_tpu_torch.train.state import create_train_state  # noqa: E402
from iou3dmatch_tpu_torch.train.torch_import import state_dict_from_jax  # noqa: E402
from tests import torch_ssl_cases as C  # noqa: E402

jp = pytest.importorskip("iou3dmatch_tpu.models.pointnet2")
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def exact_jax_ball_query():
    real = jp.ball_query
    jp.ball_query = lambda r, ns, xyz, new_xyz, exact=False: real(r, ns, xyz, new_xyz, exact=True)
    yield
    jp.ball_query = real


@pytest.fixture(scope="module")
def setup(exact_jax_ball_query):
    return C.make_setup()


@pytest.mark.parametrize("f32_gridconv", [False, True], ids=["bf16", "bf16_f32_gridconv"])
def test_bf16_ssl_step_matches_jax(setup, f32_gridconv):
    from iou3dmatch_tpu.models.factory import build_votenet as build_jax
    from iou3dmatch_tpu.ops.fps import furthest_point_sample as jax_fps
    from iou3dmatch_tpu.train import make_ssl_step as jax_make_ssl_step

    jm, cfg = build_jax("scannet", tiny=True, compute_dtype="bfloat16", f32_gridconv=f32_gridconv)
    jstep = jax_make_ssl_step(jm, cfg, 1, adam_eps=C.ADAM_EPS, dataset="scannet", **setup.thr,
                              **C.knobs("reference_exact"))
    new, jmetrics = jstep(C.jax_state(setup), {k: jnp.asarray(v) for k, v in setup.batch.items()},
                          setup.key, C.LR, C.MOMENTUM)
    want = state_dict_from_jax({"params": C.jax_gradient(setup.variables["params"], new)})

    pm, _ = build_votenet("scannet", tiny=True, device="cpu", compute_dtype="bfloat16",
                          f32_gridconv=f32_gridconv)
    pm.load_state_dict(state_dict_from_jax(setup.variables), strict=True)
    state = create_train_state(pm, adam_eps=C.ADAM_EPS, with_ema=True)
    state.ema_model.load_state_dict(state_dict_from_jax(setup.ema), strict=True)
    assert state.ema_model.compute_dtype == torch.bfloat16
    seen, hooks = C.sa1_inds_of(state)
    try:
        metrics = C.port_ssl_step(setup, "reference_exact")(
            state, C.torch_batch(setup.batch), C.LR, C.MOMENTUM,
            noise=C.port_noise(setup.key, "reference_exact"))
    finally:
        for h in hooks:
            h.remove()

    xyz = np.concatenate([setup.batch["ema_point_clouds"][..., 0:3],
                          setup.batch["point_clouds"][..., 0:3]])
    np.testing.assert_array_equal(
        np.concatenate([seen["teacher"].numpy(), seen["student"].numpy()]),
        np.asarray(jax_fps(jnp.asarray(xyz), 128)))
    assert set(metrics) == set(C.np_tree(jmetrics))
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=2e-2)
    keys = sorted(want)
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    cos, _ = C.cosine_and_rel_l2(C.flat(grads, keys), C.flat(want, keys))
    assert cos > 0.4, cos
    for model in (state.model, state.ema_model):
        for k, v in model.state_dict().items():
            assert v.dtype == torch.float32 or not v.is_floating_point(), k
