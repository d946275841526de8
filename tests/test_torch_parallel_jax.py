"""The port's SSL step over a 2-rank ``gloo`` group held to JAX's
``shard_train_step`` on a 2-device mesh, on the CPU.

JAX: ``shard_train_step(make_ssl_step(...), make_mesh(2))`` on the state
``replicate`` puts on the mesh and the global batch ``shard_batch`` cuts
into contiguous rows (tests/conftest.py's virtual CPU devices). The port:
two ranks (tests/torch_parallel_ranks.py, spawned once for the module),
rank r on ``[L_r; U_r]`` under the port's ``shard_train_step``. Both take
tests/torch_parallel_cases.py's 2 + 2 scenes, weights and the JAX step's
jitter keys (``torch_ssl_cases.port_noise`` at the global shape);
``reference_exact`` with view-stats, one step.

The error scale is tests/test_torch_ssl_step.py's, for the same reason:
JAX's float32 train-mode BatchNorm is the less exact side (ROADMAP.md
Queue 3). The port's 2-rank float32 step is held to its 2-rank float64 step
at the tight bounds (every metric rtol 1e-4, gradient cosine > 0.99999
and relative L2 < 1e-3, teacher statistics rtol 1e-4 and atol 1e-5), and
to JAX at the scale of JAX's own error: every metric rtol 1e-3 (atol 1e-7),
the gradient (JAX's, read from its Adam state) with cosine > 0.999 and
relative L2 < 0.05, the teacher's BN statistics rtol 1e-3 and atol 1e-3;
the EMA after Adam is exactly 0.5 teacher + 0.5 student on each rank.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests import torch_parallel_cases as P  # noqa: E402
from tests import torch_ssl_cases as C  # noqa: E402
from torch_parallel_ranks import start  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def held(tmp_path_factory):
    from iou3dmatch_tpu.parallel import make_mesh, replicate, shard_batch, shard_train_step
    from iou3dmatch_tpu.train import make_ssl_step as jax_make_ssl_step

    setup = P.make_setup()
    cases = {name: P.step_case(setup, dtype=dtype, steps=1)
             for name, dtype in (("f32", torch.float32), ("f64", torch.float64))}
    d = tmp_path_factory.mktemp("jax")
    torch.save({"cases": cases}, d / "steps.pt")
    ranks = start("steps", d)
    try:
        mesh = make_mesh(2)
        step = shard_train_step(jax_make_ssl_step(
            setup.jm, setup.cfg, P.BL, adam_eps=C.ADAM_EPS, dataset="scannet", **setup.thr,
            **C.knobs("reference_exact")), mesh)
        state = replicate(C.jax_state(setup), mesh)
        batch = shard_batch({k: jnp.asarray(v) for k, v in setup.batch.items()}, mesh)
        new, metrics = step(state, batch, setup.key, C.LR, C.MOMENTUM)
        jax_out = (C.np_tree(new), C.np_tree(metrics))
    finally:
        got = ranks.join()
    return setup, jax_out, got


def test_two_ranks_hold_to_jax_on_a_two_device_mesh(held):
    from iou3dmatch_tpu_torch.train.torch_import import state_dict_from_jax

    setup, (new, jmetrics), ranks = held
    for r, out in enumerate(ranks):
        got, got64 = out["f32"][0], out["f64"][0]
        assert set(got["metrics"]) == set(jmetrics), r
        assert float(got["metrics"]["pseudo_gt_ratio"]) > 0
        for k, v in jmetrics.items():
            C.close(got["metrics"][k], got64["metrics"][k], rtol=1e-4, atol=1e-7,
                    what=f"rank {r} {k} against float64")
            C.close(got["metrics"][k], v, rtol=1e-3, atol=1e-7, what=f"rank {r} {k}")
        want = state_dict_from_jax({"params": C.jax_gradient(setup.variables["params"], new)})
        keys = sorted(want)
        assert set(got["grads"]) == set(want)
        cos, rel = C.cosine_and_rel_l2(C.flat(got["grads"], keys), C.flat(want, keys))
        assert cos > 0.999 and rel < 0.05, (r, cos, rel)
        cos, rel = C.cosine_and_rel_l2(C.flat(got["grads"], keys), C.flat(got64["grads"], keys))
        assert cos > 0.99999 and rel < 1e-3, (r, cos, rel)
        ema_want = state_dict_from_jax({"params": new.ema_params,
                                        "batch_stats": new.ema_batch_stats})
        for k in ema_want:
            if "running" in k:
                C.close(got["ema"][k], got64["ema"][k], rtol=1e-4, atol=1e-5,
                        what=f"rank {r} {k} against float64")
                C.close(got["ema"][k], ema_want[k], rtol=1e-3, atol=1e-3, what=f"rank {r} {k}")
        ema0 = state_dict_from_jax({"params": setup.ema["params"]})
        for k in want:
            assert torch.equal(got["ema"][k], ema0[k] * 0.5 + got["model"][k] * 0.5), (r, k)
