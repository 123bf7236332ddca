"""host_step_ms.train: the host's time in one training step call: the
program's ``train.step`` span from entry to exit on the host's clock, the
median over the ``busy_steps`` steps traced with device activity only
(``spans.py``). While the launch queue is full the host waits on it, so
this reads the device's pace; above the device's step, the host sets it."""

from portbench import spans


def read(ctx):
    return spans.host_ms(ctx)
