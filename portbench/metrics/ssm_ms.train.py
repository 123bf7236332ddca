"""ssm_ms.train: the state-space scan a training step on the card's clock,
by the program's own spans: the summed ``device_ms`` of the step's
``ssm.forward`` spans (the forward and each layer's recompute in the
backward) and ``ssm.backward`` spans, the median over the ``busy_steps``
steps traced with device activity only (``spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, ("ssm.forward", "ssm.backward"))
