"""fwd_ms.train: the training step's forward (the loss, attention
included) on the card's clock: the ``device_ms`` of the program's
``train.forward`` span, the median over the ``busy_steps`` steps traced
with device activity only (``spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, ("train.forward",))
