"""ssm_kernel_pct.train: the share of a training step's state-space scan
calls that ran the program's scan kernels: of the step's ``ssm.forward``
and ``ssm.backward`` spans, those whose ``impl`` attribute is "kernel", in
percent; the median over the ``busy_steps`` steps traced with device
activity only (``spans.py``). None where a step has no such span or a span
no ``impl`` (a program whose spans do not say which path ran)."""

import statistics

from portbench import spans

NAMES = ("ssm.forward", "ssm.backward")


def read(ctx):
    taken = spans.steps(ctx)
    if taken is None:
        return None
    shares = []
    for named in taken:
        impls = [s.attributes.get("impl") for n in NAMES
                 for s in named.get(n, ())]
        if not impls or None in impls:
            return None
        shares.append(100.0 * impls.count("kernel") / len(impls))
    return statistics.median(shares)
