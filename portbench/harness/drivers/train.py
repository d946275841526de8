"""The training driver: the pretrain or the mean-teacher SSL step of the
port in a closed loop, one step after another, as the drivers' loop
``cli/common.py::train_epochs`` runs it: the next host batch, staged onto
the card a batch ahead in a thread (``harness/window.py::Feed``, the
drivers' ``staged``), the step, its metrics read by
``cli/common.py::fetch_metrics`` (one copy, one wait).

Set-up builds the model and its train state once, drives them through the
first ``first_steps`` steps with the window's own call on distinct
batches, keeps what the check needs (the losses, Adam's moments, each
leaf's change), warms up, and hands the same state to
the window. After the window the plain reference repeats the first steps
from the same weights, batches and jitter draws.
"""
import gc
import math
import time

import numpy as np
import torch

from .. import compare, program, traffic, weights
from ..tracing import Spans, read_profile
from ..window import Feed, Window


def _port():
    from iou3dmatch_tpu_torch.cli.common import fetch_metrics
    from iou3dmatch_tpu_torch.data.staging import stage_batch
    from iou3dmatch_tpu_torch.train.state import create_train_state
    from iou3dmatch_tpu_torch.train.steps import make_pretrain_step, make_ssl_step
    return fetch_metrics, stage_batch, create_train_state, make_pretrain_step, make_ssl_step


def state_seed(seed: int) -> int:
    """The seed of the train state's generator (the jitter draws)."""
    return seed + 1


def _make_step(mod_steps, cfg, mix):
    make_pretrain_step, make_ssl_step = mod_steps
    if mix["step"] == "ssl":
        return make_ssl_step(cfg, num_labeled=mix["labeled"], dataset=mix["dataset"],
                             **mix["ssl"])
    return make_pretrain_step(cfg)


def _snapshot(state) -> dict:
    out = {"student": {n: p.detach().clone() for n, p in state.model.named_parameters()}}
    if state.ema_model is not None:
        out["teacher"] = {n: p.detach().clone() for n, p in state.ema_model.named_parameters()}
    return out


def _changes(state, start: dict) -> dict:
    out = {"change": compare.norms({n: p.detach() - start["student"][n]
                                    for n, p in state.model.named_parameters()})}
    if state.ema_model is not None:
        out["teacher_change"] = compare.norms({n: p.detach() - start["teacher"][n]
                                               for n, p in state.ema_model.named_parameters()})
    return out


def adam_moments(state) -> dict:
    """The norms of Adam's moments, leaf by leaf: ``exp_avg`` and
    ``exp_avg_sq``, as the optimizer holds them."""
    opt = state.optimizer
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {k: compare.norms({names[id(p)]: s[k] for p, s in opt.state.items()})
            for k in ("exp_avg", "exp_avg_sq")}


def reference_betas() -> tuple:
    """Adam's (beta1, beta2) as the plain reference sets them."""
    from plainref.train.state import make_optimizer

    return tuple(make_optimizer([torch.zeros(1)]).param_groups[0]["betas"])


class MomentWatch:
    """Adam's moments over the first two steps of a train state: after the
    first, their norms (``moments``); after the second, their norms beside
    the update that Adam's rule, with the reference's betas, makes from the
    state's own moments before that step and the gradient it took, which
    ``.grad`` holds until the next step clears it (``update2``). The
    second step's gradient is the state's own: the check follows the state
    from its first step on, which ``moments`` and the losses check apart."""

    def __init__(self, state, betas: tuple):
        self.state, self.betas, self.before = state, betas, {}

    def after(self, i: int, out: dict) -> None:
        opt = self.state.optimizer
        names = {id(p): n for n, p in self.state.model.named_parameters()}
        if i == 0:
            out["moments"] = adam_moments(self.state)
            self.before = {names[id(p)]: (s["exp_avg"].clone(), s["exp_avg_sq"].clone())
                           for p, s in opt.state.items()}
        elif i == 1:
            b1, b2 = self.betas
            got, want = {"exp_avg": {}, "exp_avg_sq": {}}, {"exp_avg": {}, "exp_avg_sq": {}}
            for p, st in opt.state.items():
                n = names[id(p)]
                m, v = (x.double() for x in self.before[n])
                g = p.grad.double() if p.grad is not None else None
                got["exp_avg"][n], got["exp_avg_sq"][n] = st["exp_avg"], st["exp_avg_sq"]
                want["exp_avg"][n] = m if g is None else b1 * m + (1 - b1) * g
                want["exp_avg_sq"][n] = v if g is None else b2 * v + (1 - b2) * g * g
            out["update2"] = {"got": {k: compare.norms(x) for k, x in got.items()},
                              "want": {k: compare.norms(x) for k, x in want.items()}}
            self.before = {}


def first_steps(state, one_step, n: int) -> dict:
    """Drives ``state`` through its first ``n`` steps with ``one_step()``
    (which returns the fetched metrics) and reads what the check compares:
    each step's loss, Adam's moments over the first two steps
    (``MomentWatch``), and each leaf's change after the first step
    (``first``) and after the ``n``."""
    start = _snapshot(state)
    watch = MomentWatch(state, reference_betas())
    losses, out = [], {}
    for i in range(n):
        losses.append(one_step()["loss"])
        watch.after(i, out)
        if i == 0:
            out["first"] = _changes(state, start)
    out["losses"] = losses
    out.update(_changes(state, start))
    return out


def reference_steps(ctx, host: list, tf32: bool = False, perturb: float = 0.0) -> dict:
    """The plain reference's first ``first_steps`` steps on the same
    weights, batches and jitter draws; with ``tf32`` its products run in
    TF32 (the control); with ``perturb`` each element of its first gradient
    is scaled by 1 + perturb x U(-1, 1) before Adam (the calibration's look
    at how the later steps carry round-off)."""
    from plainref.models.factory import build_votenet
    from plainref.train.state import create_train_state
    from plainref.train.steps import make_pretrain_step, make_ssl_step

    c, mix, dev = ctx.config, ctx.mix, ctx.device
    model, cfg = build_votenet(c["dataset"], num_proposal=c["num_proposal"],
                               input_feature_dim=c["input_feature_dim"],
                               tiny=c.get("tiny", False), device=dev)
    weights.load(model, weights.make(weights.shapes_of(model), ctx.seed, dev))
    state = create_train_state(model, seed=state_seed(ctx.seed), with_ema=mix["step"] == "ssl")
    step = _make_step((make_pretrain_step, make_ssl_step), cfg, mix)
    if perturb:
        opt, real = state.optimizer, state.optimizer.step
        gen = torch.Generator(device=dev).manual_seed(ctx.seed)

        def perturbed(*a, **k):
            with torch.no_grad():
                for q in model.parameters():
                    if q.grad is not None:
                        u = torch.rand(q.grad.shape, generator=gen, device=dev) * 2 - 1
                        q.grad.mul_(1 + perturb * u)
            opt.step = real
            return real(*a, **k)

        opt.step = perturbed
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        start = _snapshot(state)
        watch = MomentWatch(state, reference_betas())
        losses, out = [], {}
        for i in range(mix["first_steps"]):
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in host[i].items()}
            losses.append(float(step(state, batch, mix["lr"], mix["bn_momentum"])["loss"]))
            if i == 0:
                out["grad"] = compare.norms({n: p.grad for n, p in model.named_parameters()
                                             if p.grad is not None})
                out["first"] = _changes(state, start)
            watch.after(i, out)
        out["losses"] = losses
        out["beta1"] = state.optimizer.param_groups[0]["betas"][0]
        out.update(_changes(state, start))
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


class Setup:
    """The program's train state and step for the cell, the host batches,
    the feed that stages them a batch ahead, and ``one_step()``: the
    window's call on the next batch."""

    def __init__(self, ctx):
        fetch_metrics, stage_batch, create_train_state, *steps = _port()
        c, dev = ctx.config, ctx.device
        ctx.mix = mix = dict(ctx.mix, dataset=c["dataset"])
        self.host = traffic.batches(ctx.seed, c, mix)
        model, cfg = program.build(c, ctx.seed, dev)
        self.state = create_train_state(model, seed=state_seed(ctx.seed),
                                        with_ema=mix["step"] == "ssl")
        self.step = _make_step(steps, cfg, mix)
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
