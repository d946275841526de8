"""The port's bf16 pretrain and SSL steps under ``shard_train_step`` over a
2-rank ``gloo`` group on the CPU, against its one-process bf16 step on the
concatenated batch.

The inputs are tests/torch_parallel_cases.py's (2 labeled + 2 unlabeled
scenes, rank r holding ``[L_r; U_r]``), with the model built with
``compute_dtype="bfloat16"``; one step each, the JAX step's jitter draws.
The group's BatchNorm takes the global rows' statistics in f32 from the
ranks' bf16 activations (``global_two_pass`` on the CPU), as one process
takes them over the whole batch; the sums split over the ranks round in
another order, so a few bf16 outputs flip and the tiny model's chaos
(tests/test_torch_bf16_steps.py) spreads them. Held:

- the two ranks' states equal bit for bit; parameters, gradients and BN
  statistics float32;
- the first SA1 layer's running statistics, taken over the same bf16
  products of the same rows, within rtol 1e-5 of one process's: the global
  rows, not a rank's (a rank's own half moves them by ~1e-2);
- the loss and the summed gradient within the one process's own chaos
  envelope, the same step from clouds moved by 1e-5 (FPS's picks move
  too): the loss within
  max(2e-3 |loss|, 2 x the move's change) and the gradient's cosine at
  least the move's less 0.1 (measured here: the move shifts the loss by
  2.9 % (pretrain) and 4.8 % (SSL) and the gradient to cosine 0.81 and
  0.85; the ranks stand 2.5 % and 2.5 % from one process, at cosine 0.86
  and 0.90. In f32 the ranks equal one process at rtol 1e-4,
  tests/test_torch_parallel_steps.py).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from tests import torch_parallel_cases as P  # noqa: E402
from torch_parallel_ranks import run_steps, start  # noqa: E402

torch.set_num_threads(1)
CASES = {"ssl_bf16": dict(steps=1, compute_dtype="bfloat16"),
         "pretrain_bf16": dict(steps=1, compute_dtype="bfloat16", ssl=False)}
FIRST_BN = "backbone_net.sa1.mlp_module.layer0.bn.bn."


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    setup = P.make_setup()
    cases = {name: P.step_case(setup, **kw) for name, kw in CASES.items()}
    d = tmp_path_factory.mktemp("bf16_steps")
    torch.save({"cases": cases}, d / "steps.pt")
    ranks = start("steps", d)
    try:
        one = {name: run_steps(case) for name, case in cases.items()}
        moved = {name: run_steps(moved_case(case)) for name, case in cases.items()}
    finally:
        got = ranks.join()
    return one, moved, got


def moved_case(case: dict) -> dict:
    out = dict(case, batch=dict(case["batch"]))
    gen = torch.Generator().manual_seed(1)
    for k in ("point_clouds", "ema_point_clouds"):
        if k in out["batch"]:
            x = out["batch"][k].clone()
            x[..., :3] += 1e-5 * torch.randn(x[..., :3].shape, generator=gen)
            out["batch"][k] = x
    return out


def cosine(a: dict, b: dict) -> float:
    g, w = P.flat(a), P.flat(b)
    return float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_step_over_two_ranks_is_one_process(runs, name):
    one, moved, ranks = runs
    want, env = one[name][0], moved[name][0]
    a, b = (r[name][0] for r in ranks)
    for part in ("model", "ema"):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
            assert v.dtype == torch.float32 or not v.is_floating_point(), k
    grads = {k: a["grads"][k] for k in want["grads"]}
    assert all(g.dtype == torch.float32 for g in grads.values())
    for stat in ("running_mean", "running_var"):
        np.testing.assert_allclose(a["model"][FIRST_BN + stat].numpy(),
                                   want["model"][FIRST_BN + stat].numpy(), rtol=1e-5, atol=1e-6)
    loss, one_loss = float(a["metrics"]["loss"]), float(want["metrics"]["loss"])
    env_loss = abs(float(env["metrics"]["loss"]) - one_loss)
    assert abs(loss - one_loss) <= max(2e-3 * abs(one_loss), 2 * env_loss), (loss, one_loss,
                                                                              env_loss)
    env_cos = cosine(env["grads"], want["grads"])
    assert cosine(grads, want["grads"]) >= env_cos - 0.1, (cosine(grads, want["grads"]), env_cos)
