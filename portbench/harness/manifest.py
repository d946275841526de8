"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration (``configs/<file>``), a
traffic mix (``mixes/<traffic>.json``, which names its driver) and, through
its own name, the limits of its correctness check
(``limits/<workload>.json``). A per-layer metric's reader is
``metrics/<name>.py`` and a kernel's bound ``kernels/<name>.py``. Adding a
cell, a metric or a kernel is adding files and entries; nothing here lists
them.
"""
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]  # portbench/
ROOT = HERE.parent  # the checkout
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = ("command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}
OPTIONAL = {"workloads"}


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _line(text, what: str, problems: list) -> None:
    if not isinstance(text, str) or not 1 <= len(text) <= 200 or "\n" in text or "\t" in text:
        problems.append(f"{what}: 1 to 200 characters on one line, no tab")


def validate(bench: dict, root: Path = ROOT) -> list:
    """The contract's rules that a file can be held to without a run: keys,
    names, units, limits of counts and lengths, the files named, and every
    per-layer metric's cells reporting the end-to-end metric it moves.
    Returns the problems found (none: an empty list)."""
    problems = []
    if tuple(sorted(bench)) != tuple(sorted(TOP_KEYS)):
        problems.append(f"top-level keys {sorted(bench)}, expected {sorted(TOP_KEYS)}")
        return problems
    cmd, paths = bench["command"], bench["paths"]
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32):
        problems.append("command: a list of 1 to 32 strings")
    for word in cmd:
        _line(word, "command word", problems)
        if isinstance(word, str) and (word.startswith("/") or ".." in word.split("/")):
            problems.append(f"command word {word!r} leads outside the checkout")
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16):
        problems.append("paths: 1 to 16 directories")
    for p in paths:
        if not PATH.match(p) or p.startswith("/") or ".." in p.split("/"):
            problems.append(f"path {p!r}")
    rs = bench["run_seconds"]
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        problems.append("run_seconds: a whole number from 1 to 51")
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        entries = bench[group]
        if not isinstance(entries, list) or not entries:
            problems.append(f"{group}: a non-empty list")
            continue
        for e in entries:
            extra = set(e) - KEYS[group]
            missing = KEYS[group] - OPTIONAL - set(e)
            if group == "configs" or group == "workloads":
                missing = KEYS[group] - set(e)
            if extra or missing:
                problems.append(f"{group} {e.get('name')}: extra {sorted(extra)}, missing {sorted(missing)}")
            name = e.get("name", "")
            if not NAME.match(str(name)):
                problems.append(f"{group} name {name!r}")
            if (group, name) in names or (group in ("end_to_end", "per_layer")
                                          and ("metric", name) in names):
                problems.append(f"{group} name {name!r} twice")
            names.add(("metric", name) if group in ("end_to_end", "per_layer") else (group, name))
    if len(bench["configs"]) > 24 or len(bench["workloads"]) > 24:
        problems.append("at most 24 configurations and 24 cells")
    if len(bench["end_to_end"]) > 16 or len(bench["per_layer"]) > 128:
        problems.append("at most 16 end-to-end and 128 per-layer metrics")
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        _line(c.get("source"), f"config {c['name']} source", problems)
        _line(c.get("why"), f"config {c['name']} why", problems)
        f = c.get("file", "")
        if not any(f.startswith(p.rstrip("/") + "/") for p in paths) or not (root / f).is_file():
            problems.append(f"config {c['name']} file {f!r} is not a file under paths")
        if not isinstance(c.get("reduced"), list) or len(c["reduced"]) > 16 \
                or not all(NAME.match(k) for k in c["reduced"]):
            problems.append(f"config {c['name']} reduced")
    if len({c.get("file") for c in bench["configs"]}) != len(bench["configs"]):
        problems.append("two configurations share a file")
    cells = {w["name"]: w for w in bench["workloads"]}
    pairs = set()
    for w in bench["workloads"]:
        _line(w.get("why"), f"workload {w['name']} why", problems)
        if w.get("config") not in configs:
            problems.append(f"workload {w['name']} names no configuration")
        if not NAME.match(str(w.get("traffic", ""))):
            problems.append(f"workload {w['name']} traffic name")
        if w.get("chips") not in (1, 4):
            problems.append(f"workload {w['name']} chips: 1 or 4")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            problems.append(f"workload {w['name']}: configuration and traffic appear twice")
        pairs.add(pair)
    used = {w.get("config") for w in bench["workloads"]}
    for c in configs:
        if c not in used:
            problems.append(f"configuration {c} is used by no cell")
    if sum(w.get("chips") == 4 for w in bench["workloads"]) > max(1, len(cells) // 4):
        problems.append("too many four-chip cells")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    if "setup_s" not in e2e:
        problems.append("no setup_s")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not UNIT.match(str(m.get("unit", ""))):
            problems.append(f"metric {m['name']} unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            problems.append(f"metric {m['name']} better")
        for w in m.get("workloads", ()):
            if w not in cells:
                problems.append(f"metric {m['name']} lists unknown cell {w}")
    for m in bench["end_to_end"]:
        if m.get("source") not in SOURCES_E2E:
            problems.append(f"end-to-end metric {m['name']} source")
        b = m.get("bound")
        if not isinstance(b, (int, float)) or not 0.01 <= b <= 0.25:
            problems.append(f"end-to-end metric {m['name']} bound from 0.01 to 0.25")
    for m in bench["per_layer"]:
        if m.get("source") not in SOURCES:
            problems.append(f"per-layer metric {m['name']} source")
        _line(m.get("layer"), f"per-layer metric {m['name']} layer", problems)
        moves = e2e.get(m.get("moves"))
        if moves is None or moves["name"] == "setup_s":
            problems.append(f"per-layer metric {m['name']} moves no end-to-end metric")
            continue
        listed = m.get("workloads") or [w for w in cells
                                        if moves["name"] in reports(bench, w, "end_to_end")]
        for w in listed:
            if w in cells and moves["name"] not in reports(bench, w, "end_to_end"):
                problems.append(f"per-layer metric {m['name']}: cell {w} does not report "
                                f"{moves['name']}")
    for w in cells:
        e = reports(bench, w, "end_to_end")
        if "setup_s" not in e or len(e) < 2:
            problems.append(f"cell {w} reports setup_s and at least one other end-to-end metric")
        if not reports(bench, w, "per_layer"):
            problems.append(f"cell {w} reports no per-layer metric")
    if len(json.dumps(bench).encode()) > 64 * 1024:
        problems.append("BENCHMARK.json over 64 KiB")
    return problems


def reports(bench: dict, workload: str, group: str) -> list:
    """Names of the ``group`` metrics cell ``workload`` reports: those that
    list it, and those that list no cells. A per-layer metric without a
    list goes where its ``moves`` is reported."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if group == "end_to_end":
        return e2e
    return [m["name"] for m in bench["per_layer"]
            if workload in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in e2e)]


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix(traffic: str, base: Path = HERE) -> dict:
    return json.loads((base / "mixes" / f"{traffic}.json").read_text())


def limits(workload: str, base: Path = HERE) -> dict:
    return json.loads((base / "limits" / f"{workload}.json").read_text())


def module(kind: str, name: str, base: Path = HERE):
    """``<kind>/<name>.py`` under ``base`` (portbench), imported on its own."""
    path = base / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_modules(base: Path = HERE) -> dict:
    """Every kernel file, by name: its name pattern and its bound."""
    return {p.stem: module("kernels", p.stem, base)
            for p in sorted((base / "kernels").glob("*.py"))}
