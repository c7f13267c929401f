"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port; names compared by their whole
top-level part (``pfrl_tpu_torch`` begins with ``pfrl_tpu``)."""

import ast
import sys
from pathlib import Path

from portbench import harness, main

FORBIDDEN = {"jax", "jaxlib", "flax", "pfrl_tpu"}


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                tops.add(arg.value.split(".")[0])
    return tops


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(harness.HERE.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not imported_tops(f) & FORBIDDEN, f


def test_builders_name_the_port():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for c in bench["configs"]:
        builder = harness.load_json(harness.ROOT / c["file"])["builder"]
        assert builder.split(".")[0] == "pfrl_tpu_torch", builder


def test_reference_imports_nothing_of_the_port():
    for f in sorted((harness.HERE / "reference").rglob("*.py")):
        assert "pfrl_tpu_torch" not in imported_tops(f), f


def test_forbidden_modules_are_caught_by_whole_top_level_name(monkeypatch):
    assert "pfrl_tpu" not in main.loaded_forbidden()  # pfrl_tpu_torch is not pfrl_tpu
    monkeypatch.setitem(sys.modules, "pfrl_tpu.fake_for_test", object())
    assert main.loaded_forbidden() == ["pfrl_tpu"]
