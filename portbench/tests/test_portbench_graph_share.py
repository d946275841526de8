"""The reader of ``iou_opt_graph_share.eval``: the counter
``iou_opt.graph_replays`` over the traced requests; 0 where the program
counts replays and none was counted; None on a program without the
counter's ``tally`` or without ``utils/trace.py``, and without traced
requests."""
import sys
import types

import pytest

from harness import manifest

NAME = "iou_opt_graph_share.eval"


def read(traced_units: int = 6):
    return manifest.module("metrics", NAME).read(types.SimpleNamespace(traced_units=traced_units))


@pytest.fixture
def counters(monkeypatch):
    from iou3dmatch_tpu_torch.utils import trace

    return lambda c: monkeypatch.setattr(trace, "snapshot", lambda: {"spans": {}, "counters": c})


def test_it_is_in_the_manifest_for_the_eval_cell():
    entry = next(m for m in manifest.load()["per_layer"] if m["name"] == NAME)
    assert entry["source"] == "program_counter" and entry["unit"] == "share"
    assert entry["workloads"] == ["scannet-eval-opt"] and entry["moves"] == "eval_scenes_per_s"


@pytest.mark.parametrize("replays, want", [(6, 1.0), (3, 0.5), (None, 0.0)])
def test_replays_over_traced_requests(counters, replays, want):
    counters({} if replays is None else {"iou_opt.graph_replays": replays})
    assert read() == pytest.approx(want)


def test_nothing_without_traced_requests(counters):
    counters({"iou_opt.graph_replays": 6})
    assert read(traced_units=0) is None


def test_nothing_on_a_program_without_tally(monkeypatch, counters):
    from iou3dmatch_tpu_torch.utils import trace

    counters({"iou_opt.graph_replays": 6})
    monkeypatch.delattr(trace, "tally")
    assert read() is None


def test_nothing_on_a_program_without_the_trace_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "iou3dmatch_tpu_torch.utils.trace", None)
    assert read() is None
