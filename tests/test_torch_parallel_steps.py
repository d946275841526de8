"""The port's pretrain and SSL steps over a 2-rank ``gloo`` group on the CPU
against its one-process step on the concatenated batch.

The inputs are tests/torch_parallel_cases.py's: a tiny VoteNet and a global
batch of 2 labeled + 2 unlabeled scenes of 2,048 points; rank r holds
``[L_r; U_r]``, 1 + 1 scenes. The ranks (tests/torch_parallel_ranks.py,
spawned once for the module) run each case for 2 steps under
``shard_train_step``; the first step takes the JAX step's jitter draws at
the global shape, the second draws them from the state's generator (at the
global shape, each rank taking its rows). This process runs the same cases
on the whole batch without a group while the ranks run.

- float64 (the SSL step ``reference_exact`` with view-stats, and
  ``pruned``; the pretrain step; the SSL step with ``random`` proposal
  sampling, its indices drawn from the generator): every metric key, the
  gradient summed over the ranks, the parameters after Adam, the teacher
  after the EMA and both models' BN running statistics within rtol 1e-9.
  The gradient is also within atol 1e-9 x its largest element: where BN
  makes a bias's gradient 0, both sides hold rounding noise. The metrics
  the step computes in float32 even here (those of the float32 rotated-IoU
  labels, and the ratios of counts) are within rtol 1e-6: a float32 sum
  split between the ranks rounds differently.
- float32, ``reference_exact``, one step: the bounds of the SSL tests' float32 step
  against its float64 (tests/test_torch_ssl_step.py): metrics rtol 1e-4,
  the gradient's cosine > 0.99999 and relative L2 < 1e-3, running
  statistics rtol 1e-4 and atol 1e-5; the change of the parameters and of
  the teacher's by the step with cosine > 0.999 and relative L2 < 0.05
  (Adam's first step, lr x g / (|g| + eps), turns float32 noise in a
  near-zero gradient element into a step of up to 2 lr).
- Both ranks' states are equal bit for bit after each step, and pseudo
  labels pass on both ranks' unlabeled scenes.
"""
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from tests import torch_parallel_cases as P  # noqa: E402
from torch_parallel_ranks import run_steps, start  # noqa: E402

torch.set_num_threads(1)
CASES = {
    "ssl_f64": dict(dtype=torch.float64),
    "pruned_f64": dict(dtype=torch.float64, knobs="pruned"),
    "pretrain_f64": dict(dtype=torch.float64, ssl=False),
    "random_f64": dict(dtype=torch.float64, sampling="random", noise=False),
    "ssl_f32": dict(dtype=torch.float32, steps=1),  # after one Adam step float32 states part
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    setup = P.make_setup()
    cases = {name: P.step_case(setup, **kw) for name, kw in CASES.items()}
    d = tmp_path_factory.mktemp("steps")
    torch.save({"cases": cases}, d / "steps.pt")
    ranks = start("steps", d)
    try:
        one = {name: run_steps(case) for name, case in cases.items()}
    finally:
        got = ranks.join()
    return setup, one, got


@pytest.mark.parametrize("name", [n for n in CASES if n.endswith("f64")])
def test_float64_step_over_two_ranks_is_one_process(runs, name):
    _, one, ranks = runs
    P.check_against_one_process([r[name] for r in ranks], one[name], P.EXACT, name)


def test_float32_ssl_step_over_two_ranks_is_one_process(runs):
    setup, one, ranks = runs
    start = {"model": P.state_dict_from_jax(setup.variables),
             "ema": P.state_dict_from_jax(setup.ema)}
    P.check_against_one_process([r["ssl_f32"] for r in ranks], one["ssl_f32"], P.FLOAT32,
                                "ssl_f32", start)


def test_pseudo_labels_pass_on_both_ranks(runs):
    """The thresholds let boxes pass in each unlabeled scene, so both ranks'
    pseudo-label paths carry labels: each scene's share of the passing
    boxes, from the one-process teacher outputs the setup holds."""
    import numpy as np
    import scipy.special as sp

    setup, one, _ = runs
    ep = setup.teacher
    rows = slice(P.BL, None)
    pos = sp.softmax(ep["objectness_scores"][rows], -1)[..., 1]
    cls = sp.softmax(ep["sem_cls_scores"][rows], -1)
    iou = sp.expit(np.take_along_axis(ep["iou_scores"][rows], cls.argmax(-1)[..., None], 2))[..., 0]
    passing = ((pos > setup.thr["obj_threshold"]) & (cls.max(-1) > setup.thr["cls_threshold"])
               & (iou > setup.thr["iou_threshold"]))
    assert passing.any(axis=1).all(), passing.sum(axis=1)
    assert float(one["ssl_f64"][0]["metrics"]["pseudo_gt_ratio"]) > 0
