"""A copy of the benchmark in a temporary checkout, with a tiny GPT-2 cell
(``tiny``) that runs on the CPU in seconds: the program's attention runs
its plain version there. The tiny cell holds its comparison to the limits
of ``gpt2-1.5b.s1024-b16``."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
TINY_CELL = "tiny"
LIMITS_OF = "gpt2-1.5b.s1024-b16"
TINY_SIZES = dict(name="gpt2-tiny", n_embd=64, n_layer=2, n_head=2,
                  n_positions=64, n_ctx=64, vocab_size=500)
TINY_MIX = {"kind": "train", "batch": 4, "seq": 32, "pool": 4,
            "check_steps": 3, "busy_steps": 1, "profile_steps": 1}


def tiny_config(param_dtype: str = "bfloat16"):
    """gpt2-1.5b's configuration file at tiny sizes."""
    conf = json.loads((REPO / "portbench" / "configs" /
                       "gpt2-1.5b.json").read_text())
    conf.update(TINY_SIZES)
    conf["recipe"].update(padded_vocab_size=512, param_dtype=param_dtype)
    return conf


def limits(cell: str = LIMITS_OF):
    return json.loads((REPO / "portbench" / "workloads" /
                       f"{cell}.json").read_text())


def make_tree(root: Path) -> Path:
    """A checkout at ``root``: ``BENCHMARK.json`` and ``portbench/`` copied,
    the program linked, and the tiny cell added as files and entries."""
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(REPO / "ray_tpu_torch", root / "ray_tpu_torch")
    pb = root / "portbench"
    (pb / "configs" / "gpt2-tiny.json").write_text(json.dumps(tiny_config()))
    (pb / "traffic" / "train.tiny.json").write_text(json.dumps(TINY_MIX))
    (pb / "workloads" / f"{TINY_CELL}.json").write_text(json.dumps(limits()))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": TINY_CELL, "config": "gpt2-tiny",
                               "traffic": "train.tiny", "chips": 1,
                               "why": "tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_python(root: Path, code: str, timeout: float = 240):
    """``code`` in a fresh interpreter whose first import root is ``root``."""
    env = dict(os.environ, PYTHONPATH=str(root))
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture
def tree(tmp_path):
    return make_tree(tmp_path)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def tiny_cell(param_dtype: str = "bfloat16"):
    """The tiny cell in this process, on the repo's own package."""
    from portbench import harness
    from portbench.families import gpt2 as fam
    from portbench.traffic import train

    return harness.Cell(name=TINY_CELL, chips=1,
                        config=tiny_config(param_dtype), mix=dict(TINY_MIX),
                        limits=limits()["limits"], family=fam, driver=train,
                        end_to_end=[], per_layer=[])
