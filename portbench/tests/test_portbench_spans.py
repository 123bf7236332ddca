"""The readers of the program's own spans (``spans.py`` and the six metrics
that use it) on spans put into the program's tracer by hand, and on a card
a traced run of the tiny cell that reports all six."""

import json
import subprocess
import sys

import pytest

from portbench import harness, spans
from ray_tpu_torch.observability import tracing

from .conftest import TINY_CELL, tiny_cell

READERS = ("fwd_ms.train", "bwd_ms.train", "optim_in_step_ms.train",
           "attn_span_ms.train", "host_step_ms.train", "reserved_gib.train")


@pytest.fixture
def tracer():
    t = tracing.get_tracer()
    t.clear()
    dropped, t.dropped = t.dropped, 0
    yield t
    t.clear()
    t.dropped = dropped


def _ctx(busy_steps):
    cell = tiny_cell()
    cell.mix["busy_steps"] = busy_steps
    return harness.Context(cell, "cpu", {}, None, {})


def _step(tracer, i, fwd, bwd, opt, attn, host_ms=None, reserved=None,
          device=True):
    """One step's spans in record order (children first), with the given
    device milliseconds (attention: one (forward, backward) pair a
    layer)."""
    trace = f"t{i}"
    ms = (lambda v: v) if device else (lambda v: None)

    def span(name, parent, dev_ms, **attrs):
        s = tracing.Span(name=name, span_id=f"{trace}.{name}.{len(attrs)}"
                         f".{id(attrs)}", parent_id=parent, trace_id=trace,
                         start_s=10.0 * i, end_s=10.0 * i + 1.0,
                         attributes=attrs, _device_ms=ms(dev_ms))
        return s

    root = span("train.step", None, fwd + bwd + opt)
    root.end_s = root.start_s + (host_ms or 1000.0) / 1e3
    if reserved is not None:
        root.attributes["reserved_bytes"] = reserved
    for f, b in attn:
        tracer.record(span("attn.forward", "f", f))
    tracer.record(span("train.forward", root.span_id, fwd))
    for f, b in attn:
        tracer.record(span("attn.backward", "b", b))
    tracer.record(span("train.backward", root.span_id, bwd))
    tracer.record(span("train.optimizer", root.span_id, opt))
    tracer.record(root)


def _read(ctx):
    return {m: harness.reader(m)(ctx) for m in READERS}


def test_each_reader_takes_the_median_of_the_first_window(tracer):
    steps = [(100, 200, 30, [(1, 2), (3, 4)], 900, 5 * 2 ** 30),
             (110, 190, 50, [(2, 2), (2, 2)], 800, 6 * 2 ** 30),
             (90, 230, 40, [(1, 1), (1, 1)], 700, 4 * 2 ** 30)]
    for i, (f, b, o, a, h, r) in enumerate(steps):
        _step(tracer, i, f, b, o, a, h, r)
    # Later steps (the host-traced windows) are not read.
    _step(tracer, 9, 1e4, 1e4, 1e4, [(1e4, 1e4)], 1e5, 99 * 2 ** 30)
    got = _read(_ctx(3))
    assert got == pytest.approx({
        "fwd_ms.train": 100, "bwd_ms.train": 200,
        "optim_in_step_ms.train": 40, "attn_span_ms.train": 8,
        "host_step_ms.train": 800, "reserved_gib.train": 6})


def test_the_steps_are_grouped_by_their_trace(tracer):
    _step(tracer, 0, 1, 2, 3, [(1, 1)], reserved=1)
    _step(tracer, 1, 4, 5, 6, [(2, 2), (2, 2)], reserved=1)
    taken = spans.steps(_ctx(2))
    assert [len(t["attn.forward"]) for t in taken] == [1, 2]
    assert all(len(t["train.step"]) == 1 for t in taken)


@pytest.mark.parametrize("case", ["empty", "too_few", "dropped", "no_card",
                                  "no_attention", "no_reserved",
                                  "no_device_ms_attribute"])
def test_nothing_to_read_is_none(tracer, case):
    n = 2
    if case == "too_few":
        _step(tracer, 0, 1, 2, 3, [(1, 1)], reserved=1)
    elif case in ("dropped", "no_card", "no_attention", "no_reserved"):
        for i in range(n):
            _step(tracer, i, 1, 2, 3, [] if case == "no_attention"
                  else [(1, 1)], reserved=None if case == "no_reserved"
                  else 1, device=case != "no_card")
        if case == "dropped":
            tracer.dropped = 1
    elif case == "no_device_ms_attribute":
        # A program whose Span has no device_ms (one without device spans).
        class Old:
            def __init__(self, name, trace, parent):
                self.name, self.trace_id, self.parent_id = name, trace, parent
                self.attributes, self.duration_ms = {}, 5.0

        for i in range(n):
            for name in ("train.forward", "attn.forward", "train.step"):
                tracer.record(Old(name, f"o{i}",
                                  None if name == "train.step" else "x"))
    got = _read(_ctx(n))
    if case == "no_attention":
        assert got.pop("attn_span_ms.train") is None
        assert None not in got.values()
    elif case == "no_reserved":
        assert got.pop("reserved_gib.train") is None
        assert None not in got.values()
    elif case == "no_card":
        assert got.pop("host_step_ms.train") == pytest.approx(1000.0)
        assert got.pop("reserved_gib.train") is not None
        assert set(got.values()) == {None}
    elif case == "no_device_ms_attribute":
        assert got.pop("host_step_ms.train") == pytest.approx(5.0)
        assert set(got.values()) == {None}
    else:
        assert set(got.values()) == {None}


@pytest.mark.cuda
def test_a_traced_run_of_the_tiny_cell_reports_all_six(cuda, tree):
    b = json.loads((tree / "BENCHMARK.json").read_text())
    for m in b["per_layer"]:
        if m["name"] in READERS:
            m["workloads"].append(TINY_CELL)
    (tree / "BENCHMARK.json").write_text(json.dumps(b))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", TINY_CELL,
         "--seed", "2147483999", "--seconds", "2", "--trace", "1"],
        cwd=tree, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    metrics = json.loads(out.stdout.splitlines()[-1])["metrics"]
    assert all(metrics[m]["value"] > 0 for m in READERS), metrics
