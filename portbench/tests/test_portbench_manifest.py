"""BENCHMARK.json against the contract's rules that need no run, and a cell
added as files only."""
import copy
import json
import shutil

import pytest

from harness import manifest, program


@pytest.fixture
def bench():
    return manifest.load()


def test_committed_manifest_is_valid(bench):
    assert manifest.validate(bench) == []


def test_every_per_layer_metric_is_reported_with_what_it_moves(bench):
    for m in bench["per_layer"]:
        for w in m["workloads"]:
            assert m["name"] in manifest.reports(bench, w, "per_layer")
            assert m["moves"] in manifest.reports(bench, w, "end_to_end")


def test_every_cell_names_files_that_exist(bench):
    for w in bench["workloads"]:
        mix = manifest.mix(w["traffic"])
        assert (manifest.HERE / "harness" / "drivers" / f"{mix['driver']}.py").is_file()
        assert manifest.limits(w["name"])
        for name in manifest.reports(bench, w["name"], "per_layer"):
            assert callable(manifest.module("metrics", name).read)


@pytest.mark.parametrize("change, problem", [
    (lambda b: b["end_to_end"][0].update(name="rate per s"), "name"),
    (lambda b: b["end_to_end"][0].update(unit="scenes per s"), "unit"),
    (lambda b: b["per_layer"][0].update(workloads=["scannet-eval-opt"]), "does not report"),
    (lambda b: b["per_layer"][0].update(moves="setup_s"), "moves no end-to-end"),
    (lambda b: b["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda b: b["workloads"][0].update(chips=2), "chips"),
    (lambda b: b["per_layer"][0].update(why="a reason"), "extra"),
    (lambda b: b["workloads"].append(dict(b["workloads"][0], name="again")), "appear twice"),
    (lambda b: b.update(run_seconds=60), "run_seconds"),
])
def test_invalid_manifests_are_caught(bench, change, problem):
    bad = copy.deepcopy(bench)
    change(bad)
    assert any(problem in p for p in manifest.validate(bad))


def test_a_cell_added_as_files_is_found_without_an_edit(bench, tmp_path):
    """A new configuration, mix, limits file and metric reader, and their
    entries in BENCHMARK.json: the harness finds each by name."""
    base = tmp_path / "portbench"
    shutil.copytree(manifest.HERE, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((base / "configs" / "scannet-votenet-iou.json").read_text())
    (base / "configs" / "scannet-votenet-iou-p256.json").write_text(
        json.dumps(dict(cfg, num_proposal=256)))
    (base / "mixes" / "scannet-pretrain.json").write_text(
        json.dumps(dict(manifest.mix("sunrgbd-pretrain"), scene=manifest.mix("scannet-ssl")["scene"])))
    (base / "limits" / "scannet-pretrain.json").write_text(json.dumps({"loss_gap.step1": 1e-5}))
    (base / "metrics" / "loss_ms.train.py").write_text("def read(r):\n    return r.span_ms('loss')\n")
    new = copy.deepcopy(bench)
    new["configs"].append(dict(new["configs"][0], name="scannet-votenet-iou-p256",
                               file="portbench/configs/scannet-votenet-iou-p256.json",
                               reduced=["num_proposal"]))
    new["workloads"].append({"name": "scannet-pretrain", "config": "scannet-votenet-iou-p256",
                             "traffic": "scannet-pretrain", "chips": 1, "why": "a new cell"})
    new["per_layer"].append({"name": "loss_ms.train", "unit": "ms", "better": "lower",
                             "source": "host_clock", "layer": "Losses", "moves":
                             "train_scenes_per_s", "workloads": ["scannet-pretrain"]})
    next(m for m in new["end_to_end"] if m["name"] == "train_scenes_per_s")["workloads"].append(
        "scannet-pretrain")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    loaded = manifest.load(tmp_path)
    assert manifest.validate(loaded, tmp_path) == []
    cell = manifest.cell(loaded, "scannet-pretrain")
    assert manifest.config(loaded, cell["config"], tmp_path)["num_proposal"] == 256
    assert manifest.mix(cell["traffic"], base)["driver"] == "train"
    assert manifest.limits("scannet-pretrain", base) == {"loss_gap.step1": 1e-5}
    assert "loss_ms.train" in manifest.reports(loaded, "scannet-pretrain", "per_layer")
    assert manifest.module("metrics", "loss_ms.train", base).read is not None


@pytest.mark.parametrize("key, value", [("cluster_sampling", "vote_fps"), ("vote_factor", 2),
                                        ("precision", "bfloat16"), ("tf32", True)])
def test_a_setting_that_neither_side_runs_is_refused(bench, key, value):
    """Both sides run the port's defaults: a configuration that asks for
    another value is refused before anything is built."""
    cfg = manifest.config(bench, "scannet-votenet-iou")
    program.check_run_as(cfg)
    with pytest.raises(ValueError, match=key):
        program.check_run_as(dict(cfg, **{key: value}))
