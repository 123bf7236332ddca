"""mfu_pct.train: the whole training step's share of the card's dense
peak. Tokens/s (the traced run's window, outside the profiled steps) times
the operations a token needs (6N + 12 L d S, no recompute) over the peak of
the recipe's type (``roofline.PEAKS``)."""

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
