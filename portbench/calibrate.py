"""Readings for the limits of a cell's correctness check, in one process:

    python3 portbench/calibrate.py --workload NAME --seeds 1,2,... \\
        --control-seeds 7,8,9 --fault-seeds 7,8,9 --out FILE.json

For each seed of ``--seeds`` the program's numbers at the cell's own size
(training: its first steps through the window's call; eval: the sampled
number of requests through the request path) against the plain reference;
for training also a second run of the reference against the first, which
shows the round-off between two runs of the same float32 code. For each
control seed the control: the reference in TF32, the next precision below
the configuration's float32 with TF32 off, put in the program's place. For
each fault seed each fault of ``harness/faults.py`` planted in the program.
Not run by the benchmark's runs; see PERF.md for the readings and limits.
"""
import argparse
import json
import sys
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import run  # noqa: E402


# the relative round-off the calibration puts into the reference's first
# gradient, elementwise, to see what the later steps make of it
PERTURB = 1e-6


def _ints(s: str) -> list:
    return [int(x) for x in s.split(",") if x]


def context(workload: str, seed: int, device):
    from harness import manifest

    args = types.SimpleNamespace(workload=workload, seed=seed, seconds=0.0, trace=0)
    ctx = run.Context(args, manifest.load(run.ROOT), device)
    return ctx


def train_readings(ctx, fault=None) -> dict:
    import torch

    from harness import compare, faults
    from harness.drivers import train

    ctx.mix = dict(ctx.mix, pool=ctx.mix["first_steps"])
    def first():
        su = train.Setup(ctx)
        got = train.first_steps(su.state, su.one_step, ctx.mix["first_steps"])
        su.feed.close()
        return su, got

    if fault is None:
        su, got = first()
    else:
        with faults.plant(fault, ctx.mix):
            su, got = first()
    host = su.host
    del su
    torch.cuda.empty_cache()
    t = time.perf_counter()
    want = train.reference_steps(ctx, host)
    out = {"program": compare.train_numbers(got, want), "reference_s": time.perf_counter() - t}
    if fault is None:
        out["reference_again"] = compare.train_numbers(train.reference_steps(ctx, host), want)
        out["reference_perturbed"] = compare.train_numbers(
            train.reference_steps(ctx, host, perturb=PERTURB), want)
    ctx.host, ctx.want = host, want
    return out


def train_control(ctx) -> dict:
    from harness import compare
    from harness.drivers import train

    return compare.train_numbers(train.reference_steps(ctx, ctx.host, tf32=True), ctx.want)


def eval_readings(ctx, fault=None) -> dict:
    import torch

    from harness import compare, faults
    from harness.drivers import eval as ev

    n = ctx.mix["check_requests"]
    ctx.mix = dict(ctx.mix, pool=n)

    def serve():
        su = ev.Setup(ctx)
        for _ in range(n):
            su.request()
        su.feed.close()
        return su

    if fault is None:
        su = serve()
    else:
        with faults.plant(fault, ctx.mix):
            su = serve()
    got = [ev.host_heads(k[1]) for k in su.kept]
    picks = [k[2] for k in su.kept]
    host = su.host
    del su
    torch.cuda.empty_cache()
    t = time.perf_counter()
    want = ev.reference_outputs(ctx, host, list(range(n)))
    out = {"program": compare.eval_numbers(got, want, picks, ev.reference_picks(ctx, got)),
           "reference_s": time.perf_counter() - t}
    ctx.host, ctx.want = host, want
    return out


def eval_control(ctx) -> dict:
    from harness import compare
    from harness.drivers import eval as ev

    n = ctx.mix["check_requests"]
    ctl = ev.reference_outputs(ctx, ctx.host, list(range(n)), tf32=True)
    picks = ev.reference_picks(ctx, ctl)
    return compare.eval_numbers(ctl, ctx.want, picks, picks)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, required=True)
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--fault-seeds", type=_ints, default=[])
    p.add_argument("--out", required=True)
    args = p.parse_args()
    import torch

    from iou3dmatch_tpu_torch.ops import _build

    _build.build()
    dev = torch.device("cuda", 0)
    ctx0 = context(args.workload, 0, dev)
    train = ctx0.mix["driver"] == "train"
    readings, control = (train_readings, train_control) if train else (eval_readings, eval_control)
    from harness import faults as planted

    faults = planted.TRAIN if train else \
        tuple(f for f in planted.EVAL if f != "unchanged" or ctx0.mix["opt_step"] > 0)
    rows = []

    def say(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in args.seeds:
        ctx = context(args.workload, seed, dev)
        row = {"seed": seed, **readings(ctx)}
        if seed in args.control_seeds:
            row["control"] = control(ctx)
        say(row)
    for seed in args.control_seeds:
        if seed not in args.seeds:
            ctx = context(args.workload, seed, dev)
            readings(ctx)
            say({"seed": seed, "control": control(ctx)})
    for seed in args.fault_seeds:
        for kind in faults:
            ctx = context(args.workload, seed, dev)
            say({"seed": seed, "fault": kind, **readings(ctx, kind)})
    Path(args.out).write_text(json.dumps({"workload": args.workload, "device":
                                          torch.cuda.get_device_name(dev), "rows": rows}, indent=1))
    bad = run.forbidden_modules()
    if bad:
        print(f"loaded: {bad}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
