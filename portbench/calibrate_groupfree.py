"""Readings for the limits of ``scannet-groupfree-pretrain``'s correctness
check, through its driver's functions
(``harness/drivers/train_groupfree.py``), in one process on the card:

    python3 portbench/calibrate_groupfree.py --seeds 1,2,... \\
        --control-seeds 7,8,9 --fault-seeds 7,8 --out FILE.json

For each seed of ``--seeds`` the program's first steps at the cell's own
size against the plain reference, and a second run of the reference
against the first (the round-off between two runs of the same float32
code). For each control seed the control: the reference in TF32, the next
precision below the configuration's float32. For each fault seed each
fault of ``harness/faults.py`` planted in the program, and ``decoder_lr``:
the decoder's lr equal to the backbone's. Not run by the benchmark's runs;
PERF.md gives the readings and the limits set from them.
"""
import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import calibrate  # noqa: E402
import run  # noqa: E402

WORKLOAD = "scannet-groupfree-pretrain"


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=calibrate._ints, required=True)
    p.add_argument("--control-seeds", type=calibrate._ints, default=[])
    p.add_argument("--fault-seeds", type=calibrate._ints, default=[])
    p.add_argument("--out", required=True)
    args = p.parse_args()
    import torch

    from harness import faults
    from harness.drivers import train_groupfree as driver
    from iou3dmatch_tpu_torch.ops import _build

    _build.build()
    dev = torch.device("cuda", 0)
    rows = []

    def say(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in args.seeds:
        ctx = calibrate.context(WORKLOAD, seed, dev)
        row = {"seed": seed, **driver.readings(ctx)}
        if seed in args.control_seeds:
            row["control"] = driver.control(ctx)
        say(row)
    for seed in args.control_seeds:
        if seed not in args.seeds:
            ctx = calibrate.context(WORKLOAD, seed, dev)
            driver.readings(ctx)
            say({"seed": seed, "control": driver.control(ctx)})
    for seed in args.fault_seeds:
        for kind in faults.TRAIN:
            say({"seed": seed, "fault": kind,
                 **driver.readings(calibrate.context(WORKLOAD, seed, dev), kind)})
        say({"seed": seed, "fault": "decoder_lr",
             **driver.readings(calibrate.context(WORKLOAD, seed, dev), decoder_lr_scale=1.0)})
    Path(args.out).write_text(json.dumps({"workload": WORKLOAD, "device":
                                          torch.cuda.get_device_name(dev), "rows": rows}, indent=1))
    bad = run.forbidden_modules()
    if bad:
        print(f"loaded: {bad}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
