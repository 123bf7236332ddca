"""attn_roofline_pct.train: attention's share of its roofline over a
training step: the sum of each call's bound (the larger of its bytes over
the card's bandwidth and its operations over its dense peak; each input
read once, each output written once; ``roofline.attention_call``) over the
device time the calls took (``attn_ms_per_step.train``'s attribution)."""

from portbench import roofline, traces


def read(ctx):
    peaks = roofline.PEAKS.get(ctx.device_kind)
    sec = traces.attention_s_per_step(ctx.summary, ctx.extra)
    if peaks is None or sec is None:
        return None
    (b, h, s, d), calls = ctx.cell.family.attention_calls(ctx.cell.config,
                                                          ctx.cell.mix)
    work = roofline.attention_call(b, h, s, d)
    bound = calls * sum(roofline.bound_s(w["flops"], w["bytes"],
                                         peaks["bf16_flops"], peaks["bytes"])
                        for w in work.values())
    return 100.0 * bound / sec
