"""The Group-Free-3D pretrain driver: the port's pretrain step on
Group-Free-3D with the IoU branch, in a closed loop as ``drivers/train.py``
runs VoteNet's, whose helpers it shares (the feed, the window, the first
steps' readings, Adam's moments).

Set-up builds the model through the port's factory
(``models/factory.py::build_groupfree``) at the configuration's widths,
draws its weights from ``--seed`` (``weights``: the harness's kinds for
convolutions and norms, and below for the decoder's 2-D leaves), makes
the train state (AdamW, the decoder's group at the configuration's
decoder lr over its lr) and the step with the model's loss
(``train/steps.py::make_pretrain_step``), drives the first
``first_steps`` steps with the window's own call, warms up, and hands the
same state to the window. After the window the plain reference
(``plainref/groupfree.py``, a copy of ``reference/groupfree.py``, written
from the release apart from the port) repeats the first steps from the
same weights, batches and generator draws (the dropout masks, then the
jitter, step by step), and ``compare.train_numbers`` reads the gaps.

``readings`` and ``control`` are the calibration's (``calibrate_groupfree.py``).
"""
import bisect
import gc
import math
import time
import types

import numpy as np
import torch

from .. import compare, program, traffic, weights
from ..tracing import Spans, _interval, _is_cuda, _user_annotation, read_profile
from ..window import Feed, Window
from .train import MomentWatch, _changes, _snapshot, first_steps, reference_betas, state_seed

DECODER = "model.decoder"  # the program's span around the decoder and its heads
# the configuration's constants the port's modules fix, checked at set-up
FIXED = {"d_model": 288, "seed_feat_dim": 288, "nhead": 8, "dim_feedforward": 2048,
         "dropout": 0.1, "activation": "relu", "sampling": "kps", "kps_topk": 4,
         "self_position_embedding": "loc_learned", "cross_position_embedding": "xyz_learned",
         "center_delta": 0.04, "size_delta": 0.111111111111, "heading_delta": 1.0,
         "query_points_generator_loss_coef": 0.8, "obj_loss_coef": 0.1, "box_loss_coef": 1.0,
         "sem_cls_loss_coef": 0.1, "size_cls_agnostic": False, "normalize_xyz": True,
         "precision": "float32", "tf32": False}


def check(config: dict, mix: dict) -> None:
    """Raises where the configuration or the mix asks for what neither side
    runs."""
    for key, value in FIXED.items():
        if config[key] != value:
            raise ValueError(f"{key}: the port runs {value!r}, the file asks for {config[key]!r}")
    ratio = config["decoder_learning_rate"] / config["learning_rate"]
    if not math.isclose(ratio, 0.1) or not math.isclose(mix["decoder_lr"] / mix["lr"], 0.1):
        raise ValueError("the port trains the decoder at a tenth of the lr")
    w = config["width"]
    widths = {"sa_mlps": [[64 * w, 64 * w, 128 * w]] + [[128 * w, 128 * w, 256 * w]] * 3,
              "fp_mlps": [[256 * w, 256 * w], [256 * w, config["seed_feat_dim"]]]}
    for key, value in widths.items():
        if config[key] != value:
            raise ValueError(f"{key}: width {w} builds {value}, the file asks for {config[key]}")


def check_built(config: dict, model) -> None:
    """Raises unless the built backbone has the configuration's centers,
    radii, neighbours and widths, from which ``shapes_groupfree`` counts
    the FLOPs and the kernels' calls."""
    bb = model.backbone_net
    sa = [getattr(bb, f"sa{i}") for i in range(1, 5)]
    built = {"sa_npoints": [m.npoint for m in sa], "sa_radii": [m.radius for m in sa],
             "sa_nsamples": [m.nsample for m in sa],
             "sa_mlps": [[layer.conv.weight.shape[0] for layer in m.mlp_module] for m in sa],
             "fp_mlps": [[layer.conv.weight.shape[0] for layer in m.mlp] for m in (bb.fp1, bb.fp2)]}
    for key, value in built.items():
        if list(config[key]) != value:
            raise ValueError(f"{key}: the port built {value}, the file asks for {config[key]}")


def kinds(shapes: dict) -> dict:
    """``weights.kinds`` for the leaves it knows; for the decoder's: a 2-D
    weight xavier-uniform in +-sqrt(6 / (in + out)), the bias of one
    uniform in +-1/sqrt(in), the attention's in-projection and
    out-projection biases 0."""
    out, rest = {}, {}
    for name, shape in shapes.items():
        stem = name.rsplit(".", 1)[0]
        weight = shapes.get(stem + ".weight")
        if len(shape) == 2:
            out[name] = ("uniform", (6.0 / (shape[0] + shape[1])) ** 0.5)
        elif name.endswith("in_proj_bias") or name.endswith("out_proj.bias"):
            out[name] = ("const", 0.0)
        elif name.endswith(".bias") and weight is not None and len(weight) == 2:
            out[name] = ("uniform", weight[1] ** -0.5)
        else:
            rest[name] = shape
    out.update(weights.kinds(rest))
    return out


def make_weights(shapes: dict, seed: int, device) -> dict:
    """``weights.make`` with ``kinds`` above: one standard-normal and one
    uniform draw on the card, leaf by leaf in name order."""
    kind = kinds(shapes)
    names = sorted(shapes)
    numel = {n: int(torch.Size(shapes[n]).numel()) for n in names}
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(sum(numel[n] for n in names if kind[n][0] == "normal"), generator=gen,
                         device=device)
    uniform = torch.rand(sum(numel[n] for n in names if kind[n][0] == "uniform"), generator=gen,
                         device=device) * 2.0 - 1.0
    out, at = {}, {"normal": 0, "uniform": 0}
    for n in names:
        k, v = kind[n]
        if k == "const":
            out[n] = torch.full(shapes[n], v, device=device)
            continue
        src = normal if k == "normal" else uniform
        out[n] = src[at[k]:at[k] + numel[n]].view(shapes[n]) * v
        at[k] += numel[n]
    return out


def build(config: dict, seed: int, device):
    """(model, dataset config) of the port with the benchmark's weights."""
    from iou3dmatch_tpu_torch.models.factory import build_groupfree

    model, cfg = build_groupfree(config["dataset"], num_proposal=config["num_target"],
                                 num_decoder_layers=config["num_decoder_layers"],
                                 width=config["width"],
                                 input_feature_dim=config["input_feature_dim"],
                                 sa_npoints=tuple(config["sa_npoints"]), device=device)
    program.check_config(config, cfg)
    check_built(config, model)
    weights.load(model, make_weights(weights.shapes_of(model), seed, device))
    return model, cfg


def reference_steps(ctx, host: list, tf32: bool = False) -> dict:
    """The plain reference's first ``first_steps`` steps on the same weights,
    batches and generator draws; with ``tf32`` its products run in TF32
    (the control)."""
    from plainref import groupfree as ref
    from plainref.data.config import get_config

    c, mix, dev = ctx.config, ctx.mix, ctx.device
    cfg = get_config(c["dataset"])
    model = ref.GroupFree(cfg.mean_size_arr, num_class=cfg.num_class,
                          num_proposal=c["num_target"], num_decoder_layers=c["num_decoder_layers"],
                          width=c["width"], sa_npoints=tuple(c["sa_npoints"])).to(dev)
    weights.load(model, make_weights(weights.shapes_of(model), ctx.seed, dev))
    opt = ref.make_optimizer(model, mix["weight_decay"])
    gen = torch.Generator(device=dev).manual_seed(state_seed(ctx.seed))
    state = types.SimpleNamespace(model=model, optimizer=opt, ema_model=None)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        start = _snapshot(state)
        watch = MomentWatch(state, reference_betas())
        losses, out = [], {}
        for i in range(mix["first_steps"]):
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in host[i].items()}
            losses.append(ref.pretrain_step(model, opt, batch, mix["lr"], mix["bn_momentum"], gen))
            if i == 0:
                out["grad"] = compare.norms({n: p.grad for n, p in model.named_parameters()
                                             if p.grad is not None})
                out["first"] = _changes(state, start)
            watch.after(i, out)
        out["losses"] = losses
        out["beta1"] = opt.param_groups[0]["betas"][0]
        out.update(_changes(state, start))
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def range_device_s(prof, name: str):
    """Device seconds of the kernels launched inside the program's range
    ``name`` (a span's ``record_function``) in the traced section: each
    kernel is tied to its launch on the host by its correlation id, and
    counted where the launch lies inside one of the range's intervals on
    the host. None where the trace holds no such range or no launch."""
    events = list(prof.profiler.kineto_results.events())
    spans, launches, kernels = [], {}, []
    for e in events:
        cuda = _is_cuda(e)
        if not cuda and e.name() == name:
            spans.append(_interval(e))
        elif not cuda and e.name().startswith(("cudaLaunch", "cuLaunch")):
            launches[e.correlation_id()] = _interval(e)[0]
        elif cuda and not _user_annotation(e) and not e.name().startswith(("Memcpy", "Memset")):
            kernels.append(e)
    if not spans or not launches:
        return None
    spans.sort()
    starts = [s for s, _ in spans]
    total = 0.0
    for e in kernels:
        at = launches.get(e.correlation_id())
        i = bisect.bisect_right(starts, at) - 1 if at is not None else -1
        if i >= 0 and at <= spans[i][1]:
            s, t = _interval(e)
            total += (t - s) / 1e9
    return total


class Setup:
    """The program's train state and step for the cell, the host batches,
    the feed that stages them a batch ahead, and ``one_step()``: the
    window's call on the next batch."""

    def __init__(self, ctx):
        from iou3dmatch_tpu_torch.cli.common import fetch_metrics
        from iou3dmatch_tpu_torch.data.staging import stage_batch
        from iou3dmatch_tpu_torch.losses import get_groupfree_loss
        from iou3dmatch_tpu_torch.train.state import create_train_state
        from iou3dmatch_tpu_torch.train.steps import make_pretrain_step

        c, dev = ctx.config, ctx.device
        ctx.mix = mix = dict(ctx.mix, dataset=c["dataset"])
        check(c, mix)
        self.host = traffic.batches(ctx.seed, c, mix)
        model, cfg = build(c, ctx.seed, dev)
        self.state = create_train_state(model, seed=state_seed(ctx.seed),
                                        weight_decay=mix["weight_decay"])
        self.step = make_pretrain_step(cfg, loss=get_groupfree_loss)
        self.spans = spans = Spans()
        self.feed = Feed(self.host, stage_batch, spans, dev)

        def one_step() -> dict:
            batch = self.feed.next()
            with spans.host("dispatch"):
                out = self.step(self.state, batch, mix["lr"], mix["bn_momentum"])
            with spans.host("fetch"):
                return fetch_metrics(out)

        self.one_step = one_step


def run(ctx) -> dict:
    su = Setup(ctx)
    mix, dev = ctx.mix, ctx.device
    got = first_steps(su.state, su.one_step, mix["first_steps"])
    for _ in range(mix["warmup_steps"]):
        su.one_step()
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t0

    su.spans.times.clear()
    window = Window(su.spans, ctx.seconds, ctx.trace, mix["trace_after"], mix["trace_steps"])
    window_s = window.run(lambda: math.isfinite(su.one_step()["loss"]))
    su.feed.close()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    profile = None
    if window.prof is not None:
        profile = read_profile(window.prof, ctx.kernel_modules, su.spans.names())
        profile["decoder_device_s"] = range_device_s(window.prof, DECODER)
    attempted = len(window.results)
    failed = attempted - sum(window.results)
    traced = mix["trace_steps"] if ctx.trace else 0
    untraced_s = window_s - window.traced_s
    host, spans = su.host, su.spans
    del su, window
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_steps(ctx, host)
    return {
        "attempted": attempted, "failed": failed, "memory_peak_bytes": peak,
        "e2e": {"train_scenes_per_s": attempted * traffic.scenes_of(mix) / window_s,
                "setup_s": setup_s},
        "numbers": compare.train_numbers(got, want), "spans": spans, "profile": profile,
        "traced_units": traced, "window_units": attempted - traced, "window_s": untraced_s,
    }


def readings(ctx, fault=None, decoder_lr_scale=None) -> dict:
    """The calibration's numbers for one seed at the cell's own size: the
    program's first steps against the reference, with ``fault`` (of
    ``harness/faults.py``) planted in the program, or with the decoder's
    lr scale set to ``decoder_lr_scale`` (a fault: 1.0, the backbone's
    lr); without either, also a second run of the reference against the
    first. Keeps the batches and the reference's numbers on ``ctx`` for
    ``control``."""
    from .. import faults

    ctx.mix = dict(ctx.mix, pool=ctx.mix["first_steps"])

    def first():
        su = Setup(ctx)
        if decoder_lr_scale is not None:
            su.state.optimizer.param_groups[1]["lr_scale"] = decoder_lr_scale
        got = first_steps(su.state, su.one_step, ctx.mix["first_steps"])
        su.feed.close()
        return su.host, got

    if fault is None:
        host, got = first()
    else:  # faults.plant tells a training mix by its driver's name
        with faults.plant(fault, dict(ctx.mix, driver="train")):
            host, got = first()
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    want = reference_steps(ctx, host)
    out = {"program": compare.train_numbers(got, want), "reference_s": time.perf_counter() - t}
    if fault is None and decoder_lr_scale is None:
        out["reference_again"] = compare.train_numbers(reference_steps(ctx, host), want)
    ctx.host, ctx.want = host, want
    return out


def control(ctx) -> dict:
    """The reference in TF32 against the reference in float32, on the
    batches of the last ``readings``."""
    return compare.train_numbers(reference_steps(ctx, ctx.host, tf32=True), ctx.want)
