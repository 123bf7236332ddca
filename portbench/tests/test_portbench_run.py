"""Runs of the harness: no JAX, no fallback to the CPU, and on a card each
cell correct."""

import ast
import json
import os
import subprocess
import sys

import pytest

from portbench import harness

from .conftest import REPO, TINY_CELL, run_python

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ray_tpu"}


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (REPO / "portbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)
                if "reference" in path.parts:
                    assert n.split(".")[0] in ("torch", "numpy", "math",
                                               "contextlib", "typing",
                                               "__future__"), (path, n)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ray_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxlike", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ray_tpu.core", object())
    assert harness.forbidden_modules() == ["ray_tpu.core"]


def test_a_run_loads_no_jax(tree):
    out = run_python(tree, (
        "import json\n"
        "from portbench import harness\n"
        f"r = harness.run_cell(harness.load_cell({TINY_CELL!r}), 5, 0.2, "
        "False, 'cpu')\n"
        "print(json.dumps([r['correct'], harness.forbidden_modules()]))\n"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1]) == [True, []]


def _run(root, *args, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "gpt2-1.5b.s1024-b16", "--seed", "1", "--seconds", "1", *args],
        cwd=root, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {})))


def test_run_refuses_without_a_card_and_prints_no_result():
    out = _run(REPO, "--trace", "0")
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no CUDA device" in out.stderr


def test_run_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench")
    out = _run(tmp_path, "--trace", "1", env={"PYTHONPATH": ""})
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gpt2-1.5b.s1024-b16",
                                  "gpt2-355m.s16384-b4"])
def test_each_cell_is_correct_on_the_card(cuda, cell):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "2", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"]
