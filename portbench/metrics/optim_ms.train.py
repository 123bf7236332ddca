"""optim_ms.train: one optimizer update (``opt.update`` and its ``p + u``)
on the cell's own parameters and gradients, timed by CUDA events after the
window in the traced run; the median of three."""


def read(ctx):
    sec = ctx.extra.get("optim_s")
    return None if sec is None else 1e3 * sec
