"""The yardstick's arithmetic against hand-worked values."""

import pytest

from portbench import roofline
from portbench.families import gpt2 as fam
from portbench.harness import load_cell

H100 = roofline.PEAKS["NVIDIA H100 80GB HBM3"]


def test_gpt2_1_5b_flops_per_token_and_mfu():
    cell = load_cell("gpt2-1.5b.s1024-b16")
    f = fam.flops_per_token(cell.config, 1024)
    # N = 50304*1600 + 1024*1600 + 48*30,740,800 + 3200 = 1,557,686,400;
    # 6N + 12*48*1600*1024 = 9,346,118,400 + 943,718,400.
    assert f == 10_289_836_800
    # PERF.md's gpt2-1.5b step: 4,096 tokens in 368.362 ms, 11.569% MFU.
    mfu = 100 * 4096 / 0.368362 * f / H100["bf16_flops"]
    assert mfu == pytest.approx(11.569, abs=5e-4)


def test_gpt2_355m_long_context_flops_per_token():
    cell = load_cell("gpt2-355m.s16384-b4")
    # N = 50304*1024 + 16384*1024 + 24*(4d^2 + 2*d*4d + 4d + 4d + 4d + d)
    n = 50304 * 1024 + 16384 * 1024 + 24 * (12 * 1024 ** 2 + 13 * 1024) \
        + 2 * 1024
    assert fam.flops_per_token(cell.config, 16384) == \
        6 * n + 12 * 24 * 1024 * 16384


def test_attention_call_at_1_16_16384_64():
    w = roofline.attention_call(1, 16, 16384, 64)
    pairs = 16 * 16384 * 16385 // 2          # 2,147,614,720
    assert pairs == 2_147_614_720
    assert w["fwd"]["flops"] == 549_789_368_320
    assert w["bwd"]["flops"] == 1_374_473_420_800
    elem, stat = 33_554_432, 1_048_576       # bf16 [1,16,16384,64]; fp32 lse
    assert w["fwd"]["bytes"] == 4 * elem + stat == 135_266_304
    assert w["bwd"]["bytes"] == 8 * elem + stat == 269_484_032
    fwd = roofline.bound_s(w["fwd"]["flops"], w["fwd"]["bytes"],
                           H100["bf16_flops"], H100["bytes"])
    bwd = roofline.bound_s(w["bwd"]["flops"], w["bwd"]["bytes"],
                           H100["bf16_flops"], H100["bytes"])
    assert fwd == pytest.approx(0.5559e-3, rel=1e-3)   # by operations
    assert bwd == pytest.approx(1.3898e-3, rel=1e-3)


@pytest.mark.parametrize("sq,sk", [(1, 1), (5, 5), (7, 3), (3, 7), (64, 64)])
def test_causal_pairs_counts_the_kept_pairs(sq, sk):
    assert roofline.causal_pairs(sq, sk, True) == sum(
        1 for i in range(sq) for j in range(sk) if j <= i)
    assert roofline.causal_pairs(sq, sk, False) == sq * sk


def test_unknown_card_has_no_peaks():
    assert roofline.PEAKS.get("cpu") is None
