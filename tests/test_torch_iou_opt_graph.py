"""``iou_optimize``'s captured CUDA graphs (``eval/iou_opt.py``).

On the CPU:

- CPU tensors take the eager loop, ``ascend``, and never the graphs.
- ``Graphs`` (with a stand-in for the capture) captures once a key and
  replays after: a new batch size, origin count, ``opt_rate`` or
  ``opt_step``, or a re-created GridConv parameter captures again; it keeps
  ``MAX_GRAPHS`` a model, the least recently used dropped, and lets a model
  go; each replay adds one to ``iou_opt.graph_replays`` while a profiler
  records.

The ``gpu`` cases run on the card (``python -m pytest --noconftest -m gpu
tests/test_torch_iou_opt_graph.py``; this file imports no JAX), on the
eval cell's shapes (8 scenes of 128 proposals over 1,024 seeds from
40,000 points) and on a partial batch of 3: the graph's outputs equal the
eager loop's on the card bit for bit, a replay leaves the last call's
outputs alone, a new shape captures a new graph, each replay counts its
kernels' launches, and all of it holds while another thread stages pinned
batches onto the card.
"""
import gc
import threading

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from iou3dmatch_tpu_torch.data.staging import stage_batch
from iou3dmatch_tpu_torch.eval import iou_opt
from iou3dmatch_tpu_torch.eval.iou_opt import iou_optimize
from iou3dmatch_tpu_torch.models.factory import build_votenet
from iou3dmatch_tpu_torch.ops import group_points, three_nn
from iou3dmatch_tpu_torch.utils import trace

RATE, STEPS = 5e-4, 10
KEYS = ("center", "size", "size_residuals", "iou_scores")


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    trace.reset()
    monkeypatch.setattr(iou_opt, "_GRAPHS", iou_opt.Graphs())
    yield
    trace.reset()


def clouds(seed: int, b: int, n: int) -> np.ndarray:
    """Points in a 6 x 6 x 2.5 m room, the fourth channel their height."""
    rng = np.random.default_rng(seed)
    pc = np.zeros((b, n, 4), np.float32)
    pc[..., :3] = rng.uniform((-3, -3, 0), (3, 3, 2.5), (b, n, 3))
    pc[..., 3] = pc[..., 2]
    return pc


def eval_outputs(model, pc) -> dict:
    model.eval()
    with torch.no_grad():
        return model(pc)


class EagerGraphs:
    """``Graphs.run``'s contract by the eager loop."""

    def run(self, model, keys, inputs, opt_rate, opt_step):
        xyz, features, *rest = inputs
        return iou_opt.ascend(model, dict(zip(keys, (xyz, features))), *rest, opt_rate,
                              opt_step)


# ----------------------------------------------------------------------- CPU
@pytest.fixture(scope="module")
def tiny():
    torch.set_num_threads(1)
    model, _ = build_votenet("scannet", tiny=True, device="cpu")
    return model, eval_outputs(model, torch.from_numpy(clouds(0, 2, 2048)))


def test_cpu_tensors_take_the_eager_loop(tiny, monkeypatch):
    model, ep = tiny

    class Refuse:
        def run(self, *args):
            raise AssertionError("the graphs ran on CPU tensors")

    monkeypatch.setattr(iou_opt, "_GRAPHS", Refuse())
    got = iou_optimize(model, ep, 5e-2, 3)
    center, size, iou = iou_opt.ascend(model, ep, ep["sem_cls_scores"].argmax(-1), ep["heading"],
                                       ep["center"], ep["size"], 5e-2, 3)
    assert not torch.equal(center, ep["center"])  # the ascent moved the boxes
    for key, want in (("center", center), ("size", size), ("iou_scores", iou)):
        assert torch.equal(got[key], want), key
    assert trace.snapshot()["counters"] == {}


class FakeGraph:
    """Stands in for a capture: counts the captures and replays."""
    made = []

    def __init__(self, model, keys, inputs, opt_rate, opt_step):
        self.replays = 0
        FakeGraph.made.append(self)

    def __call__(self, inputs):
        self.replays += 1
        return inputs[-2:] + (inputs[-1],)


@pytest.fixture
def fake(monkeypatch):
    FakeGraph.made = []
    monkeypatch.setattr(iou_opt, "_Graph", FakeGraph)
    return FakeGraph.made


def inputs(b=2, k=16, s=64, c=8):
    return (torch.zeros(b, s, 3), torch.zeros(b, s, c), torch.zeros(b, k, dtype=torch.long),
            torch.zeros(b, k), torch.zeros(b, k, 3), torch.ones(b, k, 3))


def run(graphs, model, x, rate=RATE, steps=STEPS):
    return graphs.run(model, iou_opt.ORIGINS["seed"], x, rate, steps)


def test_one_capture_a_key_then_replays(tiny, fake):
    model, _ = tiny
    graphs = iou_opt.Graphs()
    for _ in range(3):
        run(graphs, model, inputs())
    assert len(fake) == 1 and fake[0].replays == 3


@pytest.mark.parametrize("change", ["batch", "proposals", "seeds", "width", "rate", "steps",
                                    "parameter"])
def test_what_the_graph_depends_on_captures_again(tiny, fake, change):
    model, _ = tiny
    graphs = iou_opt.Graphs()
    run(graphs, model, inputs())
    args = {"batch": dict(b=3), "proposals": dict(k=8), "seeds": dict(s=32),
            "width": dict(c=4)}.get(change, {})
    rate = RATE * 2 if change == "rate" else RATE
    steps = STEPS - 1 if change == "steps" else STEPS
    if change == "parameter":  # a re-created parameter: another address
        conv = model.grid_conv.conv3_iou
        old = conv.weight
        conv.weight = nn.Parameter(old.detach().clone())
    try:
        run(graphs, model, inputs(**args), rate, steps)
    finally:
        if change == "parameter":
            conv.weight = old
    assert len(fake) == 2


def test_a_model_keeps_its_two_latest_graphs(tiny, fake):
    model, _ = tiny
    graphs = iou_opt.Graphs()
    for b in (2, 3, 2, 4, 2, 3):
        run(graphs, model, inputs(b=b))
    # 2 and 3 captured; 4 drops 3, the least recently used; 3 again drops 4
    assert [g.replays for g in fake] == [3, 1, 1, 1]
    assert len(graphs.models[model]) == iou_opt.MAX_GRAPHS == 2


def test_the_graphs_let_their_model_go(fake):
    model, _ = build_votenet("scannet", tiny=True, device="cpu")
    graphs = iou_opt.Graphs()
    run(graphs, model, inputs())
    assert len(graphs.models) == 1
    del model
    gc.collect()
    assert len(graphs.models) == 0


def test_each_replay_counts_while_a_profiler_records(tiny, fake):
    model, _ = tiny
    graphs = iou_opt.Graphs()
    run(graphs, model, inputs())
    assert trace.snapshot()["counters"] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        run(graphs, model, inputs())
        run(graphs, model, inputs(b=3))
    assert trace.snapshot()["counters"] == {"iou_opt.graph_replays": 2}


# ---------------------------------------------------------------------- card
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    model, _ = build_votenet("scannet", device=dev)
    eps = [eval_outputs(model, torch.from_numpy(clouds(seed, 8, 40000)).to(dev))
           for seed in (1, 2)]
    assert eps[0]["center"].shape == (8, 128, 3) and eps[0]["seed_xyz"].shape == (8, 1024, 3)
    return model, eps


def partial(ep: dict, b: int = 3) -> dict:
    return {k: v[:b] for k, v in ep.items()}


def eager(model, ep, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(iou_opt, "_GRAPHS", EagerGraphs())
        return iou_optimize(model, ep, RATE, STEPS)


def assert_same(got: dict, want: dict, what: str):
    for key in KEYS:
        assert got[key].shape == want[key].shape, (what, key)
        assert torch.equal(got[key], want[key]), (what, key)


@pytest.mark.gpu
@pytest.mark.parametrize("scenes", [8, 3])
def test_the_graph_equals_the_eager_loop(card, monkeypatch, scenes):
    model, eps = card
    ep = partial(eps[0], scenes)
    want = eager(model, ep, monkeypatch)
    assert not torch.equal(want["center"], ep["center"])  # the ascent moved the boxes
    first = iou_optimize(model, ep, RATE, STEPS)  # captures, then replays
    again = iou_optimize(model, ep, RATE, STEPS)
    assert_same(first, want, "first call")
    assert_same(again, want, "replay")


@pytest.mark.gpu
def test_a_replay_leaves_the_last_outputs_alone(card, monkeypatch):
    model, eps = card
    first = iou_optimize(model, eps[0], RATE, STEPS)
    kept = {k: first[k].clone() for k in KEYS}
    second = iou_optimize(model, eps[1], RATE, STEPS)
    torch.cuda.synchronize()
    assert_same(first, kept, "first call after a replay")
    assert_same(second, eager(model, eps[1], monkeypatch), "second call")
    assert not torch.equal(second["center"], first["center"])


@pytest.mark.gpu
def test_a_new_shape_captures_a_new_graph_and_replays_count(card):
    model, eps = card
    iou_optimize(model, eps[0], RATE, STEPS)
    graphs = iou_opt._GRAPHS.models[model]
    assert len(graphs) == 1
    full = next(iter(graphs.values()))
    iou_optimize(model, partial(eps[0]), RATE, STEPS)
    assert len(graphs) == 2
    launches = (three_nn.launches, group_points.launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        iou_optimize(model, eps[1], RATE, STEPS)
        iou_optimize(model, partial(eps[1]), RATE, STEPS)
    assert len(graphs) == 2 and full in graphs.values()
    assert trace.snapshot()["counters"].get("iou_opt.graph_replays") == 2
    assert trace.snapshot()["counters"].get("sync.eval.iou_opt") == 0
    # 11 ascent steps and one last forward, a three_nn and a gather each
    assert (three_nn.launches - launches[0], group_points.launches - launches[1]) == (24, 24)


@pytest.mark.gpu
def test_capture_and_replay_beside_a_staging_thread(card, monkeypatch):
    model, eps = card
    want = [eager(model, ep, monkeypatch) for ep in (eps[0], partial(eps[1]))]
    host = {"point_clouds": clouds(3, 8, 40000), "labels": np.arange(8 * 64).reshape(8, 64)}
    stop, staged, errors = threading.Event(), [], []

    def stage():
        try:
            while not stop.is_set():
                staged.append(stage_batch(host, device=eps[0]["center"].device))
                del staged[:-2]
        except Exception as e:  # noqa: BLE001 - raised in the test below
            errors.append(e)

    t = threading.Thread(target=stage, daemon=True)
    t.start()
    try:
        got = []
        for _ in range(3):
            got = [iou_optimize(model, ep, RATE, STEPS) for ep in (eps[0], partial(eps[1]))]
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    assert staged
    for k, v in host.items():
        assert np.array_equal(staged[-1][k].cpu().numpy(), v), k
    for g, w in zip(got, want):
        assert_same(g, w, "beside the staging thread")
