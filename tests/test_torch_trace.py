"""The program's spans and counters (``utils/trace.py``) on the CPU.

- Off (no profiler recording): a span opens no ``record_function`` range
  and makes no CUDA call, its ring keeps the last ``RING`` calls, and a
  counter counts nothing; the ring's appends hold under many threads.
- On: under a CPU ``torch.profiler`` a tiny SSL step and a tiny pretrain
  step show ``train.step`` enclosing their phases in order (teacher,
  student, loss, backward, update; pretrain without the teacher), and
  their outputs and updated state are bit for bit those of the same steps
  with no profiler.
- ``tally`` adds host numbers only while a profiler records, beside the
  tensor counters.
- ``pseudo.passed`` and ``pseudo.kept`` equal the masks' sums computed
  apart, on teacher heads that pass boxes.
- No span or counter of the program has the name of one of the
  benchmark's own spans (``portbench/harness/``), so the benchmark's idle
  gaps keep their names.

The ``gpu`` cases run on the card (``python -m pytest --noconftest -m gpu
tests/test_torch_trace.py``; this file imports no JAX): a planted
``.item()`` inside a sync-counting span counts one sync, and a ``device``
span's device ms is positive once the card has finished.
"""
import re
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from iou3dmatch_tpu_torch.data.config import get_config
from iou3dmatch_tpu_torch.data.loader import collate
from iou3dmatch_tpu_torch.data.staging import stage_batch
from iou3dmatch_tpu_torch.data.synthetic import SyntheticDataset
from iou3dmatch_tpu_torch.eval.ap_helper import (APCalculator, eval_config_dict,
                                                  parse_groundtruths, parse_predictions)
from iou3dmatch_tpu_torch.eval.iou_opt import iou_optimize
from iou3dmatch_tpu_torch.losses.unlabeled import get_pseudo_labels
from iou3dmatch_tpu_torch.models.factory import build_votenet
from iou3dmatch_tpu_torch.train.state import create_train_state
from iou3dmatch_tpu_torch.train.steps import make_eval_loss, make_pretrain_step, make_ssl_step
from iou3dmatch_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
PHASES = {"ssl": ["train.teacher", "train.student", "train.loss", "train.backward",
                  "train.update"],
          "pretrain": ["train.student", "train.loss", "train.backward", "train.update"]}
SPANS = {"data.stage", "train.step", "train.teacher", "train.student", "train.loss",
         "train.backward", "train.update", "eval.forward", "eval.iou_opt",
         "eval.parse_predictions", "eval.parse_groundtruths", "eval.ap_step"}


@pytest.fixture(autouse=True)
def fresh():
    trace.reset()
    yield
    trace.reset()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


class FakeClock:
    """``trace._clock``: each span reads it at entry and exit; the spans'
    durations come from ``durations_ms``, one a span."""

    def __init__(self, durations_ms):
        self.durations = iter(durations_ms)
        self.now, self.entered = 0, False

    def __call__(self):
        if self.entered:
            self.now += int(next(self.durations) * 1e6)
        self.entered = not self.entered
        return self.now


# ----------------------------------------------------------------------- off
def test_off_opens_no_range_makes_no_cuda_call_and_counts_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called while no profiler records")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    for name in ("Event", "set_sync_debug_mode", "get_sync_debug_mode", "synchronize",
                 "current_stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)  # as on the card
    for _ in range(3):
        with trace.span("t.step", sync_count=True):
            trace.count("t.boxes", torch.ones(4, dtype=torch.bool))
    snap = trace.snapshot()
    assert snap["counters"] == {}
    assert snap["spans"]["t.step"]["calls"] == 3
    assert snap["spans"]["t.step"]["host_ms"] >= 0
    assert snap["spans"]["t.step"]["device_ms"] is None


def test_a_device_span_makes_no_cuda_call_where_cuda_is_not_in_use(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", None)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    with trace.span("t.dev", device=True):
        pass
    assert trace.snapshot()["spans"]["t.dev"]["device_ms"] is None


def test_the_ring_keeps_the_last_calls(monkeypatch):
    monkeypatch.setattr(trace, "_clock", FakeClock([1.0] * 100 + [3.0] * trace.RING))
    for _ in range(100 + trace.RING):
        with trace.span("t.a"):
            pass
    s = trace.snapshot()["spans"]["t.a"]
    assert s == {"calls": 100 + trace.RING, "host_ms": 3.0, "device_ms": None}


def test_a_traced_call_takes_a_place_in_the_ring_without_its_host_time(monkeypatch):
    monkeypatch.setattr(trace, "_clock", FakeClock([1.0, 1.0, 50.0, 3.0]))
    for traced in (False, False, True, False):
        if traced:
            with cpu_profile():
                with trace.span("t.a"):
                    pass
        else:
            with trace.span("t.a"):
                pass
    s = trace.snapshot()["spans"]["t.a"]
    assert s["calls"] == 4 and s["host_ms"] == pytest.approx(5.0 / 3)


def test_a_decorated_function_is_a_new_span_each_call():
    @trace.span("t.fn")
    def fn(x, k=1):
        """doc"""
        return x + k

    assert fn(1, k=2) == 3 and fn(2) == 3
    assert fn.__name__ == "fn" and fn.__doc__ == "doc"
    assert trace.snapshot()["spans"]["t.fn"]["calls"] == 2


def test_the_ring_holds_under_many_threads():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads, per = 16, 400
    try:
        def work(i):
            for _ in range(per):
                with trace.span("t.shared"):
                    pass
                with trace.span(f"t.own.{i}"):
                    pass

        ts = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    spans = trace.snapshot()["spans"]
    assert spans["t.shared"]["calls"] == threads * per
    own = [s for k, s in spans.items() if k.startswith("t.own.")]
    assert len(own) == threads and all(s["calls"] == per for s in own)


# ------------------------------------------------------------------------ on
def counted(name, value):
    with cpu_profile():
        trace.count(name, value)


def test_on_a_counter_sums_its_tensors():
    counted("t.mask", torch.tensor([[True, False, True], [True, True, False]]))
    counted("t.mask", torch.tensor([True, False]))
    counted("t.int", torch.tensor([3, 4]))
    assert trace.snapshot()["counters"] == {"t.mask": 5, "t.int": 7}


def test_a_tally_adds_host_numbers_only_while_a_profiler_records():
    trace.tally("t.host")
    trace.tally("t.host", 5)
    trace.count("t.mask", torch.tensor([True, True]))
    assert trace.snapshot()["counters"] == {}
    with cpu_profile():
        trace.tally("t.host")
        trace.tally("t.host", 2)
        trace.count("t.mask", torch.tensor([True, False, True]))
    assert trace.snapshot()["counters"] == {"t.host": 3, "t.mask": 2}


def ssl_batch(points=512):
    """Two labeled and two unlabeled synthetic scenes (the unlabeled with
    their GT, for view-stats), merged as ``data/loader.py::SSLBatcher``
    merges them."""
    lab = collate([SyntheticDataset("scannet", 4, points, ssl=True, labeled=True, seed=1)[i]
                   for i in range(2)])
    unl = collate([SyntheticDataset("scannet", 4, points, ssl=True, labeled=False, seed=3,
                                    load_labels=True)[i] for i in range(2)])
    batch = dict(lab)
    for k in unl:
        batch[k] = np.concatenate([lab[k], unl[k]]) if k in lab else unl[k]
    return batch


def pretrain_batch(points=512):
    return collate([SyntheticDataset("scannet", 4, points, seed=2)[i] for i in range(2)])


def tiny_state(kind):
    model, cfg = build_votenet("scannet", tiny=True, device="cpu")
    state = create_train_state(model, with_ema=kind == "ssl")
    if kind == "ssl":
        return state, make_ssl_step(cfg, 2, reference_exact=True, view_stats=True)
    return state, make_pretrain_step(cfg)


def state_tensors(state) -> dict:
    out = {}
    for who, m in (("student", state.model), ("teacher", state.ema_model)):
        if m is not None:
            out.update({f"{who}.{k}": v for k, v in m.state_dict().items()})
    for i, s in enumerate(state.optimizer.state.values()):
        out.update({f"adam.{i}.{k}": v for k, v in s.items()})
    out["generator"] = state.generator.get_state()
    return out


@pytest.fixture(scope="module", params=["ssl", "pretrain"])
def two_runs(request):
    """The same two steps on two fresh tiny states: with no profiler, and
    with the second under a CPU profiler. Returns (kind, (metrics, state
    tensors) of each, the profiled step's events)."""
    torch.set_num_threads(1)
    kind = request.param
    host = ssl_batch() if kind == "ssl" else pretrain_batch()
    runs, events = [], None
    for traced in (False, True):
        state, step = tiny_state(kind)
        batch = stage_batch(host, device="cpu")
        step(state, batch, 2e-3, 0.5)
        if traced:
            with cpu_profile() as prof:
                metrics = step(state, batch, 2e-3, 0.5)
            events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                      if e.name.startswith("train.")]
        else:
            metrics = step(state, batch, 2e-3, 0.5)
        runs.append((metrics, state_tensors(state)))
    return kind, runs, events


def test_the_step_encloses_its_phases_in_order(two_runs):
    kind, _, events = two_runs
    steps = [e for e in events if e[0] == "train.step"]
    assert len(steps) == 1
    _, s0, s1 = steps[0]
    phases = sorted((e for e in events if e[0] != "train.step"), key=lambda e: e[1])
    assert [p[0] for p in phases] == PHASES[kind]
    assert all(s0 <= a <= b <= s1 for _, a, b in phases)
    assert all(p[2] <= q[1] for p, q in zip(phases, phases[1:]))  # one after another


def test_the_step_is_bit_identical_with_a_profiler(two_runs):
    _, ((m_off, s_off), (m_on, s_on)), _ = two_runs
    assert m_off.keys() == m_on.keys() and s_off.keys() == s_on.keys()
    for k in m_off:
        assert torch.equal(m_off[k], m_on[k]), k
    for k in s_off:
        assert torch.equal(s_off[k], s_on[k]), k


def teacher_heads(seed: int, b: int = 2, k: int = 256):
    """Teacher outputs (ScanNet's heads) whose logits let a share of boxes
    pass 0.9 / 0.9 / 0.25 (more than 64 in the first scene), their centers
    packed so that LHS suppresses some of them."""
    cfg = get_config("scannet")
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    nc, nh, ns = cfg.num_class, cfg.num_heading_bin, cfg.num_size_cluster
    sem = randn(b, k, nc, scale=4.0)
    sem[:, :, 0] += 3.0  # one class for many boxes, so that LHS has same-class pairs
    obj = randn(b, k, 2, scale=4.0)
    iou = randn(b, k, nc, scale=2.0)
    sem[0, : k // 2, 0] += 14.0  # scene 0: more than 64 pass
    obj[0, : k // 2, 1] += 8.0
    iou[0, : k // 2, 0] += 2.0
    return {"center": torch.rand(b, k, 3, generator=g) * 1.5,
            "sem_cls_scores": sem, "objectness_scores": obj,
            "heading_scores": randn(b, k, nh), "heading_residuals": randn(b, k, nh, scale=0.1),
            "size_scores": randn(b, k, ns), "size_residuals": randn(b, k, ns, 3, scale=0.05),
            "aggregated_vote_xyz": randn(b, k, 3), "iou_scores": iou}, cfg


def passing(t) -> np.ndarray:
    """The thresholds' mask in float64 NumPy, apart from the program's
    code; every value is held to lie clear of its threshold."""
    def softmax(x):
        e = np.exp(x - x.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    sem = softmax(t["sem_cls_scores"].double().numpy())
    obj = softmax(t["objectness_scores"].double().numpy())[..., 1]
    cls = sem.argmax(-1)
    iou = 1 / (1 + np.exp(-np.take_along_axis(t["iou_scores"].double().numpy(),
                                              cls[..., None], -1)[..., 0]))
    for v, th in ((sem.max(-1), 0.9), (obj, 0.9), (iou, 0.25)):
        assert np.abs(v - th).min() > 1e-5
    return (sem.max(-1) > 0.9) & (obj > 0.9) & (iou > 0.25)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pseudo_counters_equal_the_masks(seed):
    teacher, cfg = teacher_heads(seed)
    want = passing(teacher)
    per_scene = want.sum(1)
    assert per_scene[0] > 64 and want.sum() > 0
    args = dict(obj_threshold=0.9, cls_threshold=0.9, iou_threshold=0.25, nms_iou=0.25)
    get_pseudo_labels(teacher, cfg, use_lhs=False, **args)  # off: nothing counted
    assert trace.snapshot()["counters"] == {}
    with cpu_profile():
        plain, _ = get_pseudo_labels(teacher, cfg, use_lhs=False, **args)
    c = trace.snapshot()["counters"]
    assert c["pseudo.passed"] == want.sum()
    assert c["pseudo.kept"] == np.minimum(per_scene, 64).sum()  # the top 64 a scene
    assert int(plain["unlabeled_box_label_mask"].sum()) == c["pseudo.kept"]
    trace.reset()
    with cpu_profile():
        lhs, _ = get_pseudo_labels(teacher, cfg, use_lhs=True, **args)
    c = trace.snapshot()["counters"]
    assert c["pseudo.passed"] == want.sum()
    assert c["pseudo.kept"] == int(lhs["unlabeled_box_label_mask"].sum())
    assert 0 < c["pseudo.kept"] < np.minimum(per_scene, 64).sum()  # LHS dropped some


# --------------------------------------------------------------------- names
def harness_span_names() -> set:
    """The benchmark's own span names, read from its files, and the forms
    it gives them in a trace (``.host`` of a device span, ``bg:`` off the
    main thread)."""
    names = set()
    for path in (ROOT / "portbench" / "harness").rglob("*.py"):
        for kind, name in re.findall(r'spans\.(host|device)\(\s*"([^"]+)"', path.read_text()):
            names |= {name, name + ".host"} if kind == "device" else {name}
    return names | {"bg:" + n for n in names}


def test_no_program_span_has_a_benchmark_span_name():
    harness = harness_span_names()
    assert {"stage", "dispatch", "fetch", "forward", "forward.host", "iou_opt",
            "iou_opt.host", "parse"} <= harness
    torch.set_num_threads(1)
    with cpu_profile():
        for kind in ("ssl", "pretrain"):
            state, step = tiny_state(kind)
            host = ssl_batch() if kind == "ssl" else pretrain_batch()
            step(state, stage_batch(host, device="cpu"), 2e-3, 0.5)
        model, cfg = build_votenet("scannet", tiny=True, device="cpu")
        batch = stage_batch(pretrain_batch(), device="cpu")
        labels = {k: v for k, v in batch.items() if k != "point_clouds"}
        out, _ = make_eval_loss(model, cfg)(batch["point_clouds"], labels)
        out = dict(iou_optimize(model, out, 5e-4, 1), point_clouds=batch["point_clouds"])
        cd = eval_config_dict(cfg)
        APCalculator(0.25, cfg.class2type).step(parse_predictions(out, cd),
                                                parse_groundtruths(batch, cd))
    snap = trace.snapshot()
    assert set(snap["spans"]) == SPANS
    assert set(snap["counters"]) == {"pseudo.passed", "pseudo.kept"}  # syncs: CUDA only
    assert not (set(snap["spans"]) | set(snap["counters"])) & harness
    assert "iou_opt.graph_replays" not in harness  # counted on the card only


# ---------------------------------------------------------------------- card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def card_profile():
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


PLANTED = {"item": lambda x: (x * 2).sum().item(), "cpu": lambda x: x.cpu(),
           "nonzero": lambda x: torch.nonzero(x > 512)}


@pytest.mark.gpu
@pytest.mark.parametrize("planted", sorted(PLANTED))
def test_a_planted_sync_counts_one(cuda, planted):
    x = torch.arange(1024.0, device=cuda)
    torch.cuda.synchronize()
    with card_profile():
        with trace.span("t.synced", sync_count=True):
            PLANTED[planted](x)
        with trace.span("t.free", sync_count=True):
            x.mul_(1.0)
    c = trace.snapshot()["counters"]
    assert c == {"sync.t.synced": 1, "sync.t.free": 0}
    assert torch.cuda.get_sync_debug_mode() == 0  # restored


@pytest.mark.gpu
def test_a_device_span_resolves_after_a_sync(cuda):
    a = torch.randn(4096, 4096, device=cuda)
    for _ in range(2):
        with trace.span("t.dev", device=True):
            for _ in range(8):
                a = a @ a
                a = a / a.norm()
    torch.cuda.synchronize()
    s = trace.snapshot()["spans"]["t.dev"]
    assert s["calls"] == 2 and s["device_ms"] > 0 and s["host_ms"] > 0
