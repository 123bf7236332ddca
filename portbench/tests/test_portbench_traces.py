"""The reduction of a trace: the window, busy time, marker pairs, idle
gaps by host operation."""

import pytest

from portbench import traces


def ev(device, host):
    return traces.Events(device=device,
                         host=[(traces.WINDOW, 0.0, 100.0)] + host)


def test_busy_idle_and_markers():
    s = traces.summarize(ev(
        [("k", 0, 10), (traces.MARKER + "(long)", 12, 13), ("a", 14, 20),
         ("b", 18, 30), (traces.MARKER + "(long)", 31, 32), ("c", 40, 50),
         ("late", 95, 120)],
        [("aten::mm", 35, 45), ("outer", 30, 60)]))
    assert s.window_s == pytest.approx(100e-6)
    # 0-10, 12-13, 14-30, 31-32, 40-50, 95-100 (clipped to the window)
    assert s.busy_s == pytest.approx(43e-6)
    assert s.brackets == 1 and s.bracketed_s == pytest.approx(16e-6)
    gaps = dict(s.idle_gaps)
    # Gaps 10-12 and 13-14 with no host operation; 30-31, 32-40 and 50-95
    # inside "outer" (aten::mm, inside it, ran 35-45 only).
    assert gaps == pytest.approx({"(no host operation)": 3e-6,
                                  "outer": 54e-6})
    assert s.device_ops[0][0] in ("b", "k", "c")


def test_an_odd_number_of_markers_reads_nothing():
    s = traces.summarize(ev([(traces.MARKER, 1, 2), ("a", 3, 4)], []))
    assert s.brackets == -1 and s.bracketed_s == 0.0


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(ValueError):
        traces.summarize(traces.Events(device=[], host=[]))


def test_a_device_window_lies_between_its_two_markers():
    s = traces.device_window(traces.Events(device=[
        ("before", 0, 5), (traces.MARKER, 10, 12), ("a", 11, 20),
        ("b", 15, 25), ("c", 30, 40), (traces.MARKER, 50, 51),
        ("after", 52, 60)], host=[]))
    assert s.window_s == pytest.approx(38e-6)
    # 12-25 and 30-40 busy; the markers are not work.
    assert s.busy_s == pytest.approx(23e-6)
    assert dict(s.device_ops) == pytest.approx(
        {"a": 8e-6, "b": 10e-6, "c": 10e-6})
    assert s.idle_gaps == [] and s.brackets == 0


@pytest.mark.parametrize("markers", [0, 1, 3])
def test_a_device_window_needs_two_markers(markers):
    device = [(traces.MARKER, 10 * i, 10 * i + 1) for i in range(markers)]
    with pytest.raises(ValueError):
        traces.device_window(traces.Events(device=device, host=[]))
