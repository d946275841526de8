"""A whole run of each cell, here on the CPU at a tiny size and without the
look for a card, with the timed path broken underneath: each fault the cell
can have turns ``correct`` false, by the number that should catch it. The
sound eval runs are correct (the program and the reference agree exactly
there); tiny training steps are chaotic after the first, so only their
faults are asserted."""
import types

import pytest
import torch

import run
from harness import faults, manifest

TINY = dict(tiny=True, num_point=1024, num_proposal=16, sa_npoints=[128, 64, 32, 16])
# the fault, and the check whose number must catch it
TRAIN = {"unchanged": "change1_gap", "half": "loss_gap.step1", "altered": "grad_gap",
         "beta1": "grad_gap", "beta2": "exp_avg_sq_gap", "fresh_moments": "exp_avg_update_gap.step2"}
EVAL = {"unchanged": "boxes_gap", "half": "heads_gap", "altered": "picks_off"}


# a cell kept as files (its mix and limits) that BENCHMARK.json does not
# name, run here as a later entry would name it
KEPT = {"sunrgbd-eval": "sunrgbd-votenet-iou"}


def tiny_run(workload, fault=None):
    torch.set_num_threads(2)
    bench = manifest.load()
    if workload in KEPT and all(w["name"] != workload for w in bench["workloads"]):
        bench["workloads"].append({"name": workload, "config": KEPT[workload],
                                   "traffic": workload, "chips": 1, "why": "kept as files"})
    args = types.SimpleNamespace(workload=workload, seed=2**31 + 3, seconds=0.2, trace=0)
    ctx = run.Context(args, bench, torch.device("cpu"))
    ctx.config.update(TINY)
    ctx.mix.update(pool=3, **({"labeled": 2, "unlabeled": 2} if ctx.mix.get("step") == "ssl"
                              else {"batch": 2}))
    ctx.peaks, ctx.kind = {"name": "cpu", "power_limit_w": 0.0}, "cpu"
    if fault is None:
        return run.measure(ctx, bench)
    with faults.plant(fault, ctx.mix):
        return run.measure(ctx, bench)


CASES = [("scannet-ssl", f) for f in TRAIN] + [("sunrgbd-pretrain", f) for f in TRAIN] \
    + [("scannet-eval-opt", f) for f in EVAL] + [("sunrgbd-eval", f) for f in ("half", "altered")]


@pytest.mark.parametrize("workload, fault", CASES)
def test_a_fault_turns_correct_false(workload, fault):
    out = tiny_run(workload, fault)
    assert out["correct"] is False
    c = out["checks"][(TRAIN if "eval" not in workload else EVAL)[fault]]
    assert not c["value"] <= c["limit"], c


@pytest.mark.parametrize("workload", ["scannet-eval-opt", "sunrgbd-eval"])
def test_a_sound_eval_run_is_correct(workload):
    out = tiny_run(workload)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
