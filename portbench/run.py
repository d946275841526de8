"""The benchmark of ``iou3dmatch_tpu_torch``, the PyTorch and CUDA port, on
NVIDIA GPUs. One run of one cell:

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. It reads ``BENCHMARK.json``, builds the
cell's configuration with weights and traffic drawn from ``--seed``, warms
up, measures for ``--seconds``, checks what the timed path produced
against the plain reference (``plainref/``), and prints one JSON line last
on standard output: the end-to-end metrics with ``--trace 0``, the
per-layer ones with ``--trace 1``. It exits non-zero, printing no result,
without CUDA or with fewer cards than the cell asks for, or when JAX or
the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "iou3dmatch_tpu")
# the build and kernel caches: fixed directories inside the checkout
CACHES = {"TRITON_CACHE_DIR": ROOT / "build" / "triton",
          "TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch_extensions"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's, jaxlib's,
    flax's or the JAX package's (``iou3dmatch_tpu_torch`` is not)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Context:
    """One run's cell, configuration, mix, limits, seed and device, and the
    process's start on the host clock (``t0``), from which ``setup_s``
    counts."""

    def __init__(self, args, bench: dict, device):
        from harness import manifest

        self.workload = args.workload
        self.cell = manifest.cell(bench, args.workload)
        self.config = manifest.config(bench, self.cell["config"])
        self.mix = manifest.mix(self.cell["traffic"])
        self.limits = manifest.limits(args.workload)
        self.seed, self.seconds, self.trace = args.seed, float(args.seconds), bool(args.trace)
        self.device, self.t0 = device, T0
        self.kernel_modules = manifest.kernel_modules()

    def sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)


def measure(ctx, bench: dict) -> dict:
    """Runs the cell's driver and assembles the result line."""
    import importlib

    from harness import compare, manifest
    from harness.reading import Reading

    driver = importlib.import_module(f"harness.drivers.{ctx.mix['driver']}")
    res = driver.run(ctx)
    correct, checks = compare.verdict(res["numbers"], ctx.limits)
    if ctx.trace:
        reading = Reading(ctx.config, ctx.mix, res["spans"], res["profile"], res["traced_units"],
                          res["window_units"], res["window_s"], ctx.peaks, ctx.kernel_modules)
        metrics = {}
        for name in manifest.reports(bench, ctx.workload, "per_layer"):
            m = next(x for x in bench["per_layer"] if x["name"] == name)
            v = manifest.module("metrics", name).read(reading)
            if v is not None:
                metrics[name] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {name: {"value": res["e2e"][name],
                          "unit": next(m["unit"] for m in bench["end_to_end"] if m["name"] == name)}
                   for name in manifest.reports(bench, ctx.workload, "end_to_end")}
    device = {"platform": "gpu", "kind": ctx.kind, "count": 1,
              "memory_peak_bytes": res["memory_peak_bytes"],
              "power_limit_w": ctx.peaks["power_limit_w"]}
    out = {"correct": correct and res["failed"] == 0, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": device}
    if ctx.trace and res["profile"]:
        device["busy_s"] = res["profile"]["busy_s"]
        device["window_s"] = res["profile"]["window_s"]
        out["breakdown"] = {"device_ops": res["profile"]["device_ops"],
                            "idle_gaps": res["profile"]["idle_gaps"]}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    if not (ROOT / "iou3dmatch_tpu_torch").is_dir():
        print("the program, iou3dmatch_tpu_torch, is not in this checkout", file=sys.stderr)
        return 2
    for k, v in CACHES.items():
        os.environ[k] = str(v)
    sys.path[:0] = [str(HERE), str(ROOT)]
    from harness import manifest, peaks

    bench = manifest.load(ROOT)
    cell = manifest.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from iou3dmatch_tpu_torch.ops import _build

    _build.build()  # every kernel source, in parallel; a warm checkout finds them built
    dev = torch.device("cuda", 0)
    ctx = Context(args, bench, dev)
    ctx.peaks = peaks.card(dev)
    ctx.kind = torch.cuda.get_device_name(dev)
    out = measure(ctx, bench)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(_clean(out)))
    return 0


def _clean(x):
    """JSON-ready: NumPy scalars as numbers, a number that is not finite as
    its name ("inf", "nan")."""
    if isinstance(x, dict):
        return {k: _clean(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_clean(v) for v in x]
    if hasattr(x, "item") and not isinstance(x, (str, bytes)):
        x = x.item()
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


if __name__ == "__main__":
    sys.exit(main())
