"""The import guard: nothing the benchmark imports, on either path, has
the top-level name ``jax``, ``jaxlib``, ``flax`` or ``cmdiad_tpu``
(compared whole: ``cmdiad_tpu_torch`` is the port), and nothing under
``perfbench/reference`` imports the port."""

import ast
import subprocess
import sys

from perfbench.core import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "cmdiad_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted(spec.BENCH_DIR.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & FORBIDDEN, f
        if f.parent.name == "reference":
            assert "cmdiad_tpu_torch" not in tops, f


def _fresh(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_whole_run_loads_no_jax_and_the_reference_no_port():
    tops = _fresh(
        "import sys; sys.path.insert(0, 'perfbench/tests'); import torch; "
        "torch.set_num_threads(2); from conftest import tiny_cell; "
        "from perfbench.core import cell; "
        "cell.run(tiny_cell('tiny_ftof'), 5, 0.2, False, 'cpu'); "
        "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert not set(eval(tops)) & FORBIDDEN
    assert "cmdiad_tpu_torch" in eval(tops)
    ref = _fresh(
        "import sys, importlib, pkgutil, perfbench.reference as r; "
        "[importlib.import_module('perfbench.reference.' + m.name) "
        " for m in pkgutil.iter_modules(r.__path__)]; "
        "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert not set(eval(ref)) & (FORBIDDEN | {"cmdiad_tpu_torch"})


def test_run_refuses_without_a_card_and_prints_no_result():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "dino_pointmae.b8",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
