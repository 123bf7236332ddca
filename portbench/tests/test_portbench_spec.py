"""BENCHMARK.json against the benchmark's contract, and every piece found
by its name."""

import json
import re

from portbench import harness

from .conftest import REPO, TINY_CELL, run_python

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_keys_and_names():
    b = bench()
    assert set(b) == TOP
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in b[k]]
    assert all(NAME.match(n) for n in names)
    assert len({e["name"] for e in b["end_to_end"] + b["per_layer"]}) == \
        len(b["end_to_end"]) + len(b["per_layer"])
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}


def test_every_cell_config_and_metric_loads_by_name():
    b = bench()
    for w in b["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.chips == w["chips"]
        assert set(cell.limits) == {"loss_gap", "grad_norm_gap",
                                    "change_norm_gap"}
        assert {m["name"] for m in cell.per_layer} == {
            m["name"] for m in b["per_layer"]}
    for c in b["configs"]:
        conf = json.loads((REPO / c["file"]).read_text())
        assert conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"]
    for m in b["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_a_new_cell_and_metric_are_found_without_an_edit(tree):
    (tree / "portbench" / "metrics" / "extra_ms.train.py").write_text(
        "def read(ctx):\n    return 1.5\n")
    b = json.loads((tree / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "extra_ms.train", "unit": "ms",
                           "better": "lower", "source": "device_trace",
                           "layer": "device",
                           "moves": "train_tokens_per_s",
                           "workloads": [TINY_CELL]})
    (tree / "BENCHMARK.json").write_text(json.dumps(b))
    out = run_python(tree, (
        "from portbench import harness\n"
        f"c = harness.load_cell({TINY_CELL!r})\n"
        "print(c.config['name'], c.mix['batch'], c.driver.__name__, "
        "c.family.__name__, [m['name'] for m in c.per_layer], "
        "harness.reader('extra_ms.train')(None))\n"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["gpt2-tiny", "4", "portbench.traffic.train",
                                  "portbench.families.gpt2",
                                  "['extra_ms.train']", "1.5"]
