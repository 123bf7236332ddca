"""device_idle_pct.train: the share of a window of whole training steps
in which no kernel, copy or set ran on the card: the union of the device
intervals of a torch.profiler trace of device activity alone, between two
marker kernels (``traces.device_window``)."""


def read(ctx):
    s = ctx.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
