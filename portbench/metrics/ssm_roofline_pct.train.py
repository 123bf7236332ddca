"""ssm_roofline_pct.train: the state-space scan's share of its roofline
over a training step: for each ``ssm.forward`` and ``ssm.backward`` span of
the step, the call's bound (the larger of its operations over the card's
bf16 peak and its bytes over its bandwidth, ``roofline_ssd.ssd_call`` at
the span's ``shape`` and ``chunk``), summed, over the spans' summed
``device_ms``; the median over the ``busy_steps`` steps traced with device
activity only (``spans.py``). None where a step has no such span, a span
no shape or no device time, or the card has no peaks."""

import statistics

from portbench import roofline, roofline_ssd, spans

KINDS = {"ssm.forward": "fwd", "ssm.backward": "bwd"}


def read(ctx):
    peaks = roofline.PEAKS.get(ctx.device_kind)
    taken = spans.steps(ctx)
    if peaks is None or taken is None:
        return None
    shares = []
    for named in taken:
        bound = ms = 0.0
        found = [(KINDS[n], s) for n in KINDS for s in named.get(n, ())]
        for kind, s in found:
            shape, chunk = s.attributes.get("shape"), s.attributes.get("chunk")
            took = getattr(s, "device_ms", None)
            if shape is None or chunk is None or took is None:
                return None
            work = roofline_ssd.ssd_call(*shape, chunk)[kind]
            bound += roofline.bound_s(work["flops"], work["bytes"],
                                      peaks["bf16_flops"], peaks["bytes"])
            ms += took
        if not found or ms <= 0:
            return None
        shares.append(100.0 * bound / (ms / 1e3))
    return statistics.median(shares)
