"""The readers of the program's own spans and counters
(``iou3dmatch_tpu_torch/utils/trace.py``): None on an empty snapshot and on
a program without the module, and the right value a step or a request on a
made-up snapshot."""
import sys
import types

import pytest

from harness import manifest

SPANS = {"span_stage_ms.train", "span_step_ms.train", "span_teacher_ms.train",
         "span_student_ms.train", "span_loss_ms.train", "span_backward_ms.train",
         "span_update_ms.train", "span_forward_ms.eval", "span_iou_opt_ms.eval",
         "span_parse_ms.eval"}
COUNTERS = {"pseudo_labels.train", "host_syncs.train", "host_syncs.eval"}

SNAPSHOT = {
    "spans": {
        "data.stage": {"calls": 600, "host_ms": 14.5, "device_ms": None},
        "train.step": {"calls": 600, "host_ms": 77.0, "device_ms": None},
        "train.teacher": {"calls": 600, "host_ms": 20.0, "device_ms": None},
        "train.student": {"calls": 600, "host_ms": 21.0, "device_ms": None},
        "train.loss": {"calls": 600, "host_ms": 12.0, "device_ms": None},
        "train.backward": {"calls": 600, "host_ms": 15.0, "device_ms": None},
        "train.update": {"calls": 600, "host_ms": 6.0, "device_ms": None},
        "eval.forward": {"calls": 500, "host_ms": 9.0, "device_ms": 23.0},
        "eval.iou_opt": {"calls": 500, "host_ms": 60.0, "device_ms": 69.0},
        "eval.parse_predictions": {"calls": 500, "host_ms": 10.0, "device_ms": None},
        "eval.parse_groundtruths": {"calls": 500, "host_ms": 1.0, "device_ms": None},
        "eval.ap_step": {"calls": 1000, "host_ms": 0.25, "device_ms": None},
    },
    "counters": {"pseudo.passed": 300, "pseudo.kept": 96, "sync.train.step": 18,
                 "sync.eval.forward": 12, "sync.eval.iou_opt": 6},
}
CELL = {"train": "scannet-ssl", "eval": "scannet-eval-opt"}
# (metric, value): the mixes' 8 unlabeled scenes a step and 2 AP thresholds
WANT = {"span_stage_ms.train": 14.5, "span_step_ms.train": 77.0, "span_teacher_ms.train": 20.0,
        "span_student_ms.train": 21.0, "span_loss_ms.train": 12.0,
        "span_backward_ms.train": 15.0, "span_update_ms.train": 6.0,
        "span_forward_ms.eval": 23.0, "span_iou_opt_ms.eval": 69.0,
        "span_parse_ms.eval": 10.0 + 1.0 + 2 * 0.25, "pseudo_labels.train": 96 / (6 * 8),
        "host_syncs.train": 18 / 6, "host_syncs.eval": (12 + 6) / 6}


def reading(metric: str, traced_units: int = 6):
    mix = manifest.mix(CELL[metric.rsplit(".", 1)[1]])
    return types.SimpleNamespace(mix=mix, traced_units=traced_units)


@pytest.fixture
def trace_module(monkeypatch):
    from iou3dmatch_tpu_torch.utils import trace

    return lambda snap: monkeypatch.setattr(trace, "snapshot", lambda: snap)


def test_each_reader_is_in_the_manifest_with_its_source():
    entries = {m["name"]: m for m in manifest.load()["per_layer"]}
    for name in SPANS | COUNTERS:
        want = "program_span" if name in SPANS else "program_counter"
        assert entries[name]["source"] == want, name
    assert set(WANT) == SPANS | COUNTERS


@pytest.mark.parametrize("name", sorted(SPANS | COUNTERS))
def test_a_reader_finds_nothing_in_an_empty_snapshot(name, trace_module):
    trace_module({"spans": {}, "counters": {}})
    assert manifest.module("metrics", name).read(reading(name)) is None


@pytest.mark.parametrize("name", sorted(SPANS | COUNTERS))
def test_a_reader_finds_nothing_in_a_program_without_the_module(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "iou3dmatch_tpu_torch.utils.trace", None)
    assert manifest.module("metrics", name).read(reading(name)) is None


@pytest.mark.parametrize("name", sorted(SPANS | COUNTERS))
def test_a_reader_gives_its_value_a_unit(name, trace_module):
    trace_module(SNAPSHOT)
    assert manifest.module("metrics", name).read(reading(name)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(COUNTERS))
def test_a_counter_needs_traced_units(name, trace_module):
    trace_module(SNAPSHOT)
    assert manifest.module("metrics", name).read(reading(name, traced_units=0)) is None


def test_the_spans_of_a_step_without_a_teacher_or_an_optimisation(trace_module):
    spans = {k: v for k, v in SNAPSHOT["spans"].items()
             if k not in ("train.teacher", "eval.iou_opt")}
    counters = {k: v for k, v in SNAPSHOT["counters"].items() if k != "sync.eval.iou_opt"}
    trace_module({"spans": spans, "counters": counters})
    read = {n: manifest.module("metrics", n).read for n in SPANS | COUNTERS}
    assert read["span_teacher_ms.train"](reading("x.train")) is None
    assert read["span_iou_opt_ms.eval"](reading("x.eval")) is None
    assert read["host_syncs.eval"](reading("x.eval")) == pytest.approx(12 / 6)
    assert read["span_step_ms.train"](reading("x.train")) == 77.0
