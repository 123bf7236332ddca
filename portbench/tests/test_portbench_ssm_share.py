"""The reader of ``ssm_kernel_pct.train`` on ``ssm.*`` spans put into the
program's tracer by hand: the median share of kernel calls over the first
``busy_steps`` steps, and None where the program's spans do not say which
path ran."""

import pytest

from portbench import harness
from ray_tpu_torch.observability import tracing

from .conftest import tiny_cell

METRIC = "ssm_kernel_pct.train"


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


def _step(tracer, i, impls):
    tracer.record(tracing.Span(name="train.step", span_id=f"s{i}",
                               parent_id=None, trace_id=f"t{i}",
                               start_s=float(i), end_s=i + 0.5))
    for j, (name, impl) in enumerate(impls):
        attrs = {} if impl is None else {"impl": impl}
        tracer.record(tracing.Span(name=name, span_id=f"s{i}.{j}",
                                   parent_id=f"s{i}", trace_id=f"t{i}",
                                   start_s=float(i), end_s=i + 0.1,
                                   attributes=attrs))


def test_the_median_share_of_the_first_window(tracer):
    kernel = [("ssm.forward", "kernel"), ("ssm.forward", "kernel"),
              ("ssm.backward", "kernel")]
    _step(tracer, 0, kernel)
    _step(tracer, 1, kernel[:2] + [("ssm.backward", "plain")])
    _step(tracer, 2, kernel)
    _step(tracer, 3, [("ssm.forward", "plain")])  # past the window
    assert harness.reader(METRIC)(_ctx(3)) == pytest.approx(100.0)
    assert harness.reader(METRIC)(_ctx(2)) == pytest.approx(250.0 / 3)


@pytest.mark.parametrize("impls", [[], [("ssm.forward", None)],
                                   [("ssm.forward", "kernel"),
                                    ("ssm.backward", None)]])
def test_no_path_said_is_none(tracer, impls):
    """A step without a scan, or spans that do not say their path (the
    program before the kernels)."""
    for i in range(2):
        _step(tracer, i, impls)
    assert harness.reader(METRIC)(_ctx(2)) is None
