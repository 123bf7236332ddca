"""attn_span_ms.train: attention's forward and backward a training step on
the card's clock, by the program's own spans: the summed ``device_ms`` of
the step's ``attn.forward`` and ``attn.backward`` spans (one of each a
layer), the median over the ``busy_steps`` steps traced with device
activity only (``spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, ("attn.forward", "attn.backward"))
