"""moe_ms.train: the routed experts a training step on the card's clock,
by the program's own spans: the summed ``device_ms`` of the step's
``moe.forward`` spans (routing, sorting and the held experts' products, in
the forward and in each layer's recompute) and ``moe.backward`` spans (the
experts' gradients), the median over the ``busy_steps`` steps traced with
device activity only (``spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, ("moe.forward", "moe.backward"))
