"""optim_in_step_ms.train: the optimizer inside the training step (the
global norm, the update and ``p + u``) on the card's clock: the
``device_ms`` of the program's ``train.optimizer`` span, the median over
the ``busy_steps`` steps traced with device activity only
(``spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, ("train.optimizer",))
