"""What the benchmark loads: never JAX, flax or the JAX package (names
compared whole: the port's own name begins with the JAX package's), and
its references nothing of the program under test."""

import ast
import os
import subprocess
import sys
import types

import pytest

from portbench import run

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(PKG)
FORBIDDEN = {"jax", "jaxlib", "flax", "dlwpbench_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _sources(folder):
    for root, _, files in os.walk(folder):
        if "tests" in root.split(os.sep):
            continue
        yield from (os.path.join(root, f) for f in files if f.endswith(".py"))


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for path in _sources(PKG):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(PKG, "reference")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "dlwpbench_tpu_torch" not in tops and not tops & FORBIDDEN, path


def test_a_whole_run_loads_no_jax():
    code = (
        "import sys, torch\n"
        "from portbench import run, calibrate, cells\n"
        "from portbench.tests._tiny import tiny\n"
        "cells.metric_readers()\n"
        "for name in ('swin.train.b32', 'pangu.rollout.b32x16'):\n"
        "    run.run_cell(tiny(name), 3, 0.0, True, torch.device('cpu'))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print('FOUND', run.forbidden_modules())\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "dlwpbench_tpu_torch" in proc.stdout  # the program ran
    assert proc.stdout.strip().splitlines()[-1] == "FOUND []"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dlwpbench_tpu_torch_extra", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("y"))
    assert run.forbidden_modules() == sorted(FORBIDDEN & {m.split(".")[0] for m in sys.modules})
    monkeypatch.setitem(sys.modules, "dlwpbench_tpu.models", types.ModuleType("z"))
    assert "dlwpbench_tpu" in run.forbidden_modules()


@pytest.mark.parametrize("only_the_benchmark", [False, True])
def test_a_run_without_a_card_or_without_the_program_prints_no_result(tmp_path,
                                                                      only_the_benchmark):
    cwd = CHECKOUT
    if only_the_benchmark:  # a directory holding BENCHMARK.json and the benchmark alone
        import shutil

        shutil.copytree(PKG, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(CHECKOUT, "BENCHMARK.json"), tmp_path)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "swin.train.b32",
                           "--seed", "7", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    if only_the_benchmark:
        assert "dlwpbench_tpu_torch" in proc.stderr
