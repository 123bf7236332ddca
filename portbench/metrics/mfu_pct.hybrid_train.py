"""mfu_pct.hybrid_train: the whole training step's share of the card's bf16
peak in a hybrid (state-space, attention, experts) cell. Tokens/s (the
traced run's window, outside the profiled steps) times the operations a
token needs, counted by the family from the configuration's shapes (6 x
the parameters a token touches, the held experts weighted by the share of
choices they receive, plus the attention and scan terms; recompute not
counted), over the peak of the recipe's type (``roofline.PEAKS``)."""

from portbench import roofline

PEAK_KEY = {"bfloat16": "bf16_flops", "float16": "bf16_flops",
            "float32": "fp32_flops"}


def read(ctx):
    peaks = roofline.PEAKS.get(ctx.device_kind)
    rate = ctx.e2e.get("train_tokens_per_s")
    if peaks is None or not rate:
        return None
    cell = ctx.cell
    flops = cell.family.flops_per_token(cell.config, cell.mix["seq"])
    peak = peaks[PEAK_KEY[cell.config["recipe"]["param_dtype"]]]
    return 100.0 * rate * flops / peak
