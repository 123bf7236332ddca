"""From a torch.profiler trace to what the per-layer readers take.

The traced steps run inside one host range, ``WINDOW``. Around each call
of a program entry point it measures, the harness launches a marker kernel
(``torch.cuda._sleep(0)``, named ``MARKER``) before and after the call,
on the stream the call runs on: the device activity between the two
markers of a pair is what that call launched, whatever its kernels are
named and however they were launched. ``from_profiler`` flattens the
profiler's events into plain tuples and ``summarize`` reduces them: the
window's length, the union of device activity inside it, the device time
between marker pairs, the device operations that took most time, and the
idle gaps named by the innermost host operation that was running when
each gap began.

The device's busy share comes from another window, traced with device
activity only (recording host operations slows the host, and with it the
card it feeds): a marker kernel before the first profiled step and one
after the last bound it on the device's clock, and ``device_window``
reduces it.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

WINDOW = "portbench.window"
MARKER = "spin_kernel"
TOP = 10
NAME_CHARS = 120


@dataclass
class Events:
    """Times in microseconds on the profiler's clock."""
    device: List[Tuple[str, float, float]]           # name, start, end
    host: List[Tuple[str, float, float]]             # name, start, end


@dataclass
class Summary:
    window_s: float
    busy_s: float
    bracketed_s: float       # device time between marker pairs
    brackets: int            # marker pairs
    device_ops: List[List]   # [name, seconds], most time first
    idle_gaps: List[List]    # [host operation, seconds], most time first


def from_profiler(prof) -> Events:
    """The events of a finished ``torch.profiler.profile``: device
    activity (kernels, copies, sets; not user annotations mirrored onto
    the device) and host operations."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        item = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                device.append(item)
        elif e.device_type == DeviceType.CPU:
            host.append(item)
    return Events(device, host)


def _union(intervals: Sequence[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(ev: Events) -> Summary:
    """Reduce one traced window (the host range ``WINDOW``, which ends after
    a synchronize); raises if the trace holds no such range."""
    spans = [(a, b) for n, a, b in ev.host if n == WINDOW]
    if len(spans) != 1:
        raise ValueError(f"expected one {WINDOW!r} range, found {len(spans)}")
    w0, w1 = spans[0]
    clipped = [(n, max(a, w0), min(b, w1)) for n, a, b in ev.device
               if b > w0 and a < w1]
    busy = _union([(a, b) for _, a, b in clipped])
    busy_us = sum(b - a for a, b in busy)
    device_ops = _top_ops(clipped)

    gaps, last = [], w0
    for a, b in busy:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if w1 > last:
        gaps.append((last, w1))
    idle_gaps = _name_gaps(gaps, [h for h in ev.host if h[0] != WINDOW])
    bracketed_us, brackets = _bracketed(ev.device)
    return Summary(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
                   bracketed_s=bracketed_us / 1e6, brackets=brackets,
                   device_ops=device_ops, idle_gaps=idle_gaps)


def device_window(ev: Events) -> Summary:
    """Reduce a window bounded by two marker kernels, its first and its
    last: from the end of the first to the start of the last, the union of
    the other device activity and the operations that took most time
    (no idle gaps: the trace holds no host operations to name them by);
    raises if the trace holds another number of markers."""
    marks = sorted((a, b) for n, a, b in ev.device if MARKER in n)
    if len(marks) != 2:
        raise ValueError(f"expected two {MARKER!r} kernels, found "
                         f"{len(marks)}")
    w0, w1 = marks[0][1], marks[1][0]
    inside = [(n, max(a, w0), min(b, w1)) for n, a, b in ev.device
              if MARKER not in n and b > w0 and a < w1]
    busy_us = sum(b - a for a, b in _union([(a, b) for _, a, b in inside]))
    return Summary(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
                   bracketed_s=0.0, brackets=0, device_ops=_top_ops(inside),
                   idle_gaps=[])


def _top_ops(events) -> List[List]:
    """[name, seconds] of the device operations that took most time."""
    by_op: Dict[str, float] = defaultdict(float)
    for name, a, b in events:
        by_op[name[:NAME_CHARS]] += (b - a) / 1e6
    return sorted(([n, s] for n, s in by_op.items()),
                  key=lambda x: -x[1])[:TOP]


def _bracketed(device) -> Tuple[float, int]:
    """Device microseconds busy between the markers of each pair (first
    and second, third and fourth, ...) and the number of pairs; (0, -1)
    for an odd number of markers."""
    ordered = sorted(device, key=lambda e: e[1])
    marks = [i for i, e in enumerate(ordered) if MARKER in e[0]]
    if len(marks) % 2:
        return 0.0, -1
    total = 0.0
    for i, j in zip(marks[0::2], marks[1::2]):
        a, b = ordered[i][2], ordered[j][1]
        total += sum(y - x for x, y in _union(
            [(max(s, a), min(e, b)) for _, s, e in ordered[i + 1:j]
             if min(e, b) > max(s, a)]))
    return total, len(marks) // 2


def _name_gaps(gaps, host) -> List[List]:
    """Seconds of idle device time by the innermost host operation (latest
    start) running when each gap began; "(no host operation)" where none
    was."""
    host = sorted(host, key=lambda h: h[1])
    by_name: Dict[str, float] = defaultdict(float)
    active: List[Tuple[str, float, float]] = []
    i = 0
    for a, b in sorted(gaps):
        while i < len(host) and host[i][1] <= a:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[2] > a]
        name = max(active, key=lambda h: h[1])[0] if active else \
            "(no host operation)"
        by_name[name[:NAME_CHARS]] += (b - a) / 1e6
    return sorted(([n, s] for n, s in by_name.items()),
                  key=lambda x: -x[1])[:TOP]


def attention_s_per_step(summary, extra) -> "float | None":
    """Device seconds a step between marker pairs, where the traced run
    bracketed every call it counted (``extra["attn_calls"]``) and found
    device time between them; None otherwise."""
    calls = extra.get("attn_calls")
    if summary is None or not calls or summary.brackets != calls \
            or summary.bracketed_s <= 0:
        return None
    return summary.bracketed_s / extra["profile_steps"]
