"""The reader of ``rms_norm_kernel_pct.train`` on ``train.step`` spans put
into the program's tracer by hand: the median share over the first
``busy_steps`` steps, and None where the program did not count."""

import pytest

from portbench import harness
from ray_tpu_torch.observability import tracing

from .conftest import tiny_cell

METRIC = "rms_norm_kernel_pct.train"


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


def _step(tracer, i, **attrs):
    tracer.record(tracing.Span(name="train.step", span_id=f"s{i}",
                               parent_id=None, trace_id=f"t{i}",
                               start_s=float(i), end_s=i + 0.5,
                               attributes=attrs))


def test_kernel_calls_only_read_100(tracer):
    for i in range(3):
        _step(tracer, i, rms_norm_kernel_calls=89, rms_norm_plain_calls=0)
    assert harness.reader(METRIC)(_ctx(3)) == pytest.approx(100.0)


def test_the_median_share_of_the_first_window(tracer):
    for i, (k, p) in enumerate([(89, 0), (60, 20), (30, 10)]):
        _step(tracer, i, rms_norm_kernel_calls=k, rms_norm_plain_calls=p)
    _step(tracer, 3, rms_norm_kernel_calls=0, rms_norm_plain_calls=59)
    assert harness.reader(METRIC)(_ctx(3)) == pytest.approx(75.0)
    assert harness.reader(METRIC)(_ctx(2)) == pytest.approx(87.5)


@pytest.mark.parametrize("attrs", [{}, {"rms_norm_kernel_calls": 4},
                                   {"rms_norm_kernel_calls": 0,
                                    "rms_norm_plain_calls": 0},
                                   {"norm_kernel_calls": 9,
                                    "norm_plain_calls": 0}])
def test_nothing_counted_is_none(tracer, attrs):
    """A program without the counts (the parent of the kernels), a
    partial count, a step without RMSNorm, or LayerNorm's counts alone."""
    for i in range(2):
        _step(tracer, i, **attrs)
    assert harness.reader(METRIC)(_ctx(2)) is None
