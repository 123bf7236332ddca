"""rms_norm_kernel_pct.train: the share of the training step's RMSNorm
calls, the plain and the gated form, that went through the program's
RMSNorm kernels, as the program's ``train.step`` span counts them on a
card: ``rms_norm_kernel_calls`` (forward and backward, the recompute's
forwards too) over those plus ``rms_norm_plain_calls`` (the plain
composites), in percent; the median over the ``busy_steps`` steps traced
with device activity only (``spans.py``). None where a step lacks the
counts or made no RMSNorm call."""

import statistics

from portbench import spans


def read(ctx):
    taken = spans.steps(ctx)
    if taken is None:
        return None
    shares = []
    for named in taken:
        attrs = named[spans.STEP][0].attributes
        kernel = attrs.get("rms_norm_kernel_calls")
        plain = attrs.get("rms_norm_plain_calls")
        if kernel is None or plain is None or kernel + plain == 0:
            return None
        shares.append(100.0 * kernel / (kernel + plain))
    return statistics.median(shares)
