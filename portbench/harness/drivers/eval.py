"""The eval driver: requests of ``batch`` scenes served one at a time, in
a closed loop, as the body of ``cli/common.py::evaluate`` serves a batch:
the host batch staged onto the card a batch ahead in a thread
(``harness/window.py::Feed``, the drivers' ``staged``),
``train/steps.py::make_eval_loss`` (the forward and the eval loss), with
``opt_step`` > 0 ``eval/iou_opt.py::iou_optimize``, ``fetch_metrics``,
``eval/ap_helper.py::parse_predictions`` (NMS on the card),
``parse_groundtruths`` and ``APCalculator.step`` at each AP threshold. A
request's latency runs from taking its staged batch to its AP step.
``APCalculator.compute_metrics`` stays out of the window: the calculators
start afresh every ``pass_requests`` requests, an eval pass over the
dataset's validation split (ScanNet 312 scans, SUN RGB-D 5,050 frames), so
that they hold what a pass holds.

The check samples ``check_requests`` of the window's requests from the
seed, and the plain reference serves their scenes again.
"""
import gc
import time
import types

import numpy as np
import torch

from .. import compare, program, traffic, weights
from ..tracing import Spans, read_profile
from ..window import Feed, Window

KEEP = compare.HEADS + compare.BOX_HEADS


def _port():
    from iou3dmatch_tpu_torch.cli.common import fetch_metrics, make_config_dict
    from iou3dmatch_tpu_torch.data.staging import stage_batch
    from iou3dmatch_tpu_torch.eval.ap_helper import (APCalculator, parse_groundtruths,
                                                      parse_predictions)
    from iou3dmatch_tpu_torch.eval.iou_opt import iou_optimize
    from iou3dmatch_tpu_torch.train.steps import make_eval_loss
    return types.SimpleNamespace(**locals())


def config_dict(cfg, mix: dict) -> dict:
    """The eval settings the drivers pass (``cli/common.py::make_config_dict``):
    3D class-aware NMS at ``nms_iou``, per-class proposals, no empty-box
    removal, IoU-guided NMS as the mix says."""
    return {"dataset_config": cfg, "remove_empty_box": False, "use_3d_nms": True,
            "nms_iou": mix["nms_iou"], "use_old_type_nms": False, "cls_nms": True,
            "use_iou_for_nms": mix["use_iou_for_nms"], "per_class_proposal": True,
            "conf_thresh": mix["conf_thresh"]}


def host_heads(out: dict) -> dict:
    return {k: out[k].detach().float().cpu().numpy() for k in KEEP}


def reference_outputs(ctx, host: list, rows: list, tf32: bool = False) -> list:
    """The plain reference's heads for the host batches ``rows``: its
    forward, and ``iou_optimize`` where the mix runs it; with ``tf32`` its
    products run in TF32 (the control)."""
    from plainref.eval.iou_opt import iou_optimize
    from plainref.models.factory import build_votenet
    from plainref.train.steps import make_eval_loss

    c, mix, dev = ctx.config, ctx.mix, ctx.device
    model, cfg = build_votenet(c["dataset"], num_proposal=c["num_proposal"],
                               input_feature_dim=c["input_feature_dim"],
                               tiny=c.get("tiny", False), device=dev)
    weights.load(model, weights.make(weights.shapes_of(model), ctx.seed, dev))
    eval_loss = make_eval_loss(model, cfg)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        out = []
        for r in rows:
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in host[r].items()}
            labels = {k: v for k, v in batch.items() if k != "point_clouds"}
            ep, _ = eval_loss(batch["point_clouds"], labels)
            if mix["opt_step"] > 0:
                ep = iou_optimize(model, ep, mix["opt_rate"], mix["opt_step"])
            out.append(host_heads(ep))
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def reference_picks(ctx, heads: list) -> list:
    """The plain NumPy parse of the program's own outputs."""
    from plainref.data.config import get_config
    from plainref.eval.ap_helper import parse_predictions_np

    cd = config_dict(get_config(ctx.config["dataset"]), ctx.mix)
    return [parse_predictions_np(h, cd) for h in heads]


def sample(seed: int, done: int, k: int) -> list:
    """``k`` of the ``done`` requests, drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    return sorted(rng.choice(done, size=min(k, done), replace=False).tolist())


class Setup:
    """The program's model, eval loss and AP calculators for the cell, the
    host batches, the feed that stages them a batch ahead, and
    ``request()``: the window's request on the next batch, which appends
    (pool row, the outputs the check reads, the parse's lists) to ``kept``
    and returns its latency, from taking the staged batch to the AP step."""

    def __init__(self, ctx):
        p = _port()
        c, mix, dev = ctx.config, ctx.mix, ctx.device
        self.host = host = traffic.batches(ctx.seed, c, mix)
        model, cfg = program.build(c, ctx.seed, dev)
        eval_loss = p.make_eval_loss(model, cfg)
        cd = p.make_config_dict(cfg, types.SimpleNamespace(
            use_iou_for_nms=mix["use_iou_for_nms"], conf_thresh=mix["conf_thresh"]))
        if cd["nms_iou"] != mix["nms_iou"]:
            raise ValueError(f"the drivers' NMS IoU is {cd['nms_iou']}, the mix's {mix['nms_iou']}")
        calcs = [p.APCalculator(t, cfg.class2type) for t in mix["ap_iou_thresholds"]]
        self.spans = spans = Spans()
        self.timed = timed = dev.type == "cuda"
        self.kept = kept = []
        self.feed = Feed(host, p.stage_batch, spans, dev)

        def request():
            t = time.perf_counter()
            batch = self.feed.next()
            labels = {k: v for k, v in batch.items() if k != "point_clouds"}
            with spans.device("forward", timed):
                out, metrics = eval_loss(batch["point_clouds"], labels)
            if mix["opt_step"] > 0:
                with spans.device("iou_opt", timed):
                    out = p.iou_optimize(model, out, mix["opt_rate"], mix["opt_step"])
            with spans.host("fetch"):
                p.fetch_metrics(metrics)
            with spans.host("parse"):
                out = dict(out)
                out.setdefault("point_clouds", batch["point_clouds"])
                try:
                    pred = p.parse_predictions(out, cd)
                except AssertionError:  # a scene without a box: the parse refuses it
                    kept.append(None)
                    return None
                gt = p.parse_groundtruths(batch, cd)
                for calc in calcs:
                    calc.step(pred, gt)
                    if calc.scan_cnt >= mix["pass_requests"] * mix["batch"]:
                        calc.reset()  # a pass's end: its AP is computed outside the window
            kept.append((len(kept) % len(host), {k: out[k].detach() for k in KEEP}, pred))
            return time.perf_counter() - t

        self.request = request


def run(ctx) -> dict:
    su = Setup(ctx)
    mix, dev = ctx.mix, ctx.device
    for _ in range(mix["warmup_requests"]):
        su.request()
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t0

    su.spans.times.clear()
    su.spans.pending.clear()
    warm = len(su.kept)
    window = Window(su.spans, ctx.seconds, ctx.trace, mix["trace_after"], mix["trace_requests"])
    window_s = window.run(su.request)
    su.feed.close()
    if su.timed:
        su.spans.resolve()
    peak = torch.cuda.max_memory_allocated(dev) if su.timed else 0
    profile = None
    if window.prof is not None:
        profile = read_profile(window.prof, ctx.kernel_modules, su.spans.names())
    kept = su.kept[warm:]
    latencies = [x for x in window.results if x is not None]
    attempted, failed = len(window.results), len(window.results) - len(latencies)
    traced = mix["trace_requests"] if ctx.trace else 0
    untraced_s = window_s - window.traced_s
    rows = [i for i in sample(ctx.seed, attempted, mix["check_requests"]) if kept[i] is not None]
    got = [host_heads(kept[i][1]) for i in rows]
    picks = [kept[i][2] for i in rows]
    pool_rows = [kept[i][0] for i in rows]
    host, spans = su.host, su.spans
    del su, kept, window
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_outputs(ctx, host, pool_rows)
    numbers = compare.eval_numbers(got, want, picks, reference_picks(ctx, got))
    if failed:
        numbers["picks_off"] = float("inf")
    return {
        "attempted": attempted, "failed": failed, "memory_peak_bytes": peak,
        "e2e": {"eval_scenes_per_s": len(latencies) * mix["batch"] / window_s,
                "setup_s": setup_s},
        "numbers": numbers, "spans": spans, "profile": profile,
        "traced_units": traced, "window_units": len(latencies) - traced, "window_s": untraced_s,
    }
