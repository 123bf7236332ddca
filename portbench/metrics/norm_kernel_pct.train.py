"""norm_kernel_pct.train: the share of the training step's LayerNorm calls
that went through the program's norm kernels, as the program's
``train.step`` span counts them on a card: ``norm_kernel_calls`` (forward
and backward) over those plus ``norm_plain_calls`` (the plain composite),
in percent; the median over the ``busy_steps`` steps traced with device
activity only (``spans.py``). None where a step lacks the counts or made
no LayerNorm call."""

import statistics

from portbench import spans


def read(ctx):
    taken = spans.steps(ctx)
    if taken is None:
        return None
    shares = []
    for named in taken:
        attrs = named[spans.STEP][0].attributes
        kernel = attrs.get("norm_kernel_calls")
        plain = attrs.get("norm_plain_calls")
        if kernel is None or plain is None or kernel + plain == 0:
            return None
        shares.append(100.0 * kernel / (kernel + plain))
    return statistics.median(shares)
