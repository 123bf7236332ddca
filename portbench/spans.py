"""The program's own spans of the traced steps, read from its tracer's ring.

The program's training step and attention op open device spans
(``ray_tpu_torch.observability.tracing.device_span``) whenever a torch
profiler records, so the traced run leaves them in the tracer's ring with
no range of the benchmark's own: ``train.step`` (its ``reserved_bytes``
attribute at its end) over ``train.forward``, ``train.backward`` and
``train.optimizer``, and ``attn.forward`` and ``attn.backward`` in the
step's trace. Each span's ``device_ms`` is the card's time between two
CUDA events the program recorded on its stream.

The first ``busy_steps`` ``train.step`` traces in record order are the
steps of the window traced with device activity only, the first steps any
profiler saw. Each reader takes the median over them, or None where there
is nothing to read: a program without the spans, no card (no
``device_ms``), fewer such steps, or a ring that dropped spans.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence

STEP = "train.step"


def steps(ctx) -> Optional[List[Dict[str, List]]]:
    """The spans of each of the first ``busy_steps`` steps, by name (the
    root under ``STEP``), or None."""
    from ray_tpu_torch.observability.tracing import get_tracer

    tracer = get_tracer()
    if tracer.dropped:
        return None
    spans = tracer.spans()
    n = ctx.cell.mix["busy_steps"]
    roots = [s for s in spans if s.name == STEP and s.parent_id is None][:n]
    if len(roots) < n:
        return None
    by_trace: Dict[str, Dict[str, List]] = {r.trace_id: {} for r in roots}
    for s in spans:
        named = by_trace.get(s.trace_id)
        if named is not None:
            named.setdefault(s.name, []).append(s)
    return [by_trace[r.trace_id] for r in roots]


def _median(values: Sequence[Optional[float]]) -> Optional[float]:
    if not values or any(v is None for v in values):
        return None
    return statistics.median(values)


def device_ms(ctx, names: Sequence[str]) -> Optional[float]:
    """The median over the steps of the summed ``device_ms`` of the spans
    named ``names`` in each step; None where a step has none of them or a
    span has no device time."""
    taken = steps(ctx)
    if taken is None:
        return None
    per_step = []
    for named in taken:
        found = [s for n in names for s in named.get(n, ())]
        times = [getattr(s, "device_ms", None) for s in found]
        per_step.append(sum(times) if found and None not in times
                        else None)
    return _median(per_step)


def host_ms(ctx) -> Optional[float]:
    """The median of the steps' host durations (the ``train.step`` span's
    wall clock, entry to exit)."""
    taken = steps(ctx)
    if taken is None:
        return None
    return _median([named[STEP][0].duration_ms for named in taken])


def largest_attribute(ctx, key: str) -> Optional[float]:
    """The largest ``key`` attribute of the steps' ``train.step`` spans;
    None where a step lacks it."""
    taken = steps(ctx)
    if taken is None:
        return None
    values = [named[STEP][0].attributes.get(key) for named in taken]
    return None if not values or None in values else max(values)
