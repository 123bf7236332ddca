"""attn_ms_per_step.train: device time of attention's forward and backward
a training step, attributed by the op that launched the kernels: the
traced run brackets each call of the program's attention op (forward and
backward) with marker kernels (``traces.MARKER``), and this is the device
time between the markers, over the profiled steps. Kernel names play no
part, so it reads the same work whatever kernel a later change puts
there."""

from portbench import traces


def read(ctx):
    sec = traces.attention_s_per_step(ctx.summary, ctx.extra)
    return None if sec is None else 1e3 * sec
