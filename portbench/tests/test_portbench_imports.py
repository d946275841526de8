"""No module of the benchmark imports JAX or the JAX package, judged by the
whole top-level name, and the reference imports nothing of the port."""
import ast
import subprocess
import sys
import types
from pathlib import Path

import pytest

import run

HERE = Path(run.__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "iou3dmatch_tpu"}


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not imported_tops(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    for path in (HERE / "plainref").rglob("*.py"):
        assert "iou3dmatch_tpu_torch" not in imported_tops(path), path
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import plainref.train.steps, plainref.eval.iou_opt, plainref.eval.ap_helper, "
            "plainref.models.factory\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'iou3dmatch_tpu_torch', 'iou3dmatch_tpu', 'jax', 'flax'}))" % str(HERE))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=HERE.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("name, flagged", [
    ("iou3dmatch_tpu_torch", False), ("iou3dmatch_tpu_torch.ops", False),
    ("iou3dmatch_tpu", True), ("iou3dmatch_tpu.models", True), ("jax", True),
    ("jaxlib.xla_client", True), ("flax.linen", True), ("jaxtyping", False),
    ("flaxen", False),
])
def test_forbidden_modules_compares_whole_top_level_names(monkeypatch, name, flagged):
    for m in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name.split(".")[0] in run.forbidden_modules()) == flagged
