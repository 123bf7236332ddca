"""Finds a cell's pieces by name and runs it.

Everything is found by the names in ``BENCHMARK.json``:

- the cell (``workloads``): its configuration, traffic and chips;
- ``configs/<config>.json``: the configuration, whose ``family`` names
  ``families/<family>.py`` (the model's build, weights and reference);
- ``traffic/<traffic>.json``: the traffic mix, whose ``kind`` names the
  driver ``traffic/<kind>.py``;
- ``workloads/<cell>.json``: the limits of the cell's comparison;
- ``metrics/<metric>.py``: the reader of each per-layer metric the cell
  reports (``read(ctx)``, a number, or None when it finds nothing).

So a later change adds a configuration, a traffic mix, a cell or a metric
as new files and new entries, and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

from . import compare

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# Top-level modules no run may hold: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    mix: Dict
    limits: Dict[str, float]
    family: object
    driver: object
    end_to_end: List[Dict]
    per_layer: List[Dict]


@dataclass
class Context:
    """What a per-layer reader reads: the cell, the card, the run's
    end-to-end numbers, the trace's summary and the driver's extras."""
    cell: Cell
    device_kind: str
    e2e: Dict[str, float]
    summary: object
    extra: Dict = field(default_factory=dict)


def _json(path: Path) -> Dict:
    if not path.is_file():
        raise LookupError(f"{path.relative_to(ROOT)} does not exist")
    with open(path) as f:
        return json.load(f)


def _applies(entry: Dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = _json(ROOT / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise LookupError(f"no cell {name!r} in BENCHMARK.json")
    entry = entries[0]
    config = _json(PKG / "configs" / f"{entry['config']}.json")
    mix = _json(PKG / "traffic" / f"{entry['traffic']}.json")
    limits = _json(PKG / "workloads" / f"{name}.json")["limits"]
    return Cell(
        name=name, chips=entry["chips"], config=config, mix=mix,
        limits=limits,
        family=importlib.import_module(f"portbench.families."
                                       f"{config['family']}"),
        driver=importlib.import_module(f"portbench.traffic.{mix['kind']}"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str) -> Callable:
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = PKG / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise LookupError(f"no reader metrics/{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def process_age_s() -> float:
    """Seconds since this process started (its start time in
    ``/proc/self/stat`` against the boot clock)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - started


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (the name before the first dot, compared whole)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device) -> Dict:
    """One run of ``cell`` on ``device``: the result line's object, with
    the numbers compared under ``checks``, last."""
    import torch

    out = cell.driver.run(cell, seed, seconds, trace, device, process_age_s)
    dev = torch.device(device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    values = compare.readings(out["readings"]["program"],
                              out["readings"]["reference"])
    ok, checks = compare.judge(values, cell.limits)
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = Context(cell, kind, out["e2e"], out["summary"], out["extra"])
        for m in cell.per_layer:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": out["memory_peak_bytes"]}
    if dev.type == "cuda":
        device_info["power_limit"] = power_limit()
    result = {"correct": ok and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info}
    summary = out["summary"]
    if summary is not None:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    return result


def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def check_lines(checks: Dict) -> List[str]:
    return [f"check {n}: {c['value']!r} (limit {c['limit']!r})"
            for n, c in checks.items()]


def finite_or_none(x: float) -> Optional[float]:
    return x if math.isfinite(x) else None
