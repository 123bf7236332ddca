"""The hybrid configuration's pieces: found by name, the scan's operations
and bytes and the operations a token needs against hand-worked values, the
readers of its spans on spans put in by hand, a tiny cell through the
harness on the CPU, and a checkout whose program lacks the model refused as
the cell loads."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import compare, harness, roofline, roofline_ssd
from portbench.families import granite_hybrid as fam
from portbench.traffic import train
from ray_tpu_torch.observability import tracing

from .conftest import REPO

CELL = "granite-4.0-h-small.s8192-b8"
METRICS = ("ssm_ms.train", "ssm_roofline_pct.train", "moe_ms.train",
           "mfu_pct.hybrid_train")
# The GPT-2 cells' metrics that read the Granite step too: all but
# norm_kernel_pct.train (no LayerNorm) and mfu_pct.train.
SHARED = ("device_idle_pct.train", "attn_ms_per_step.train",
          "attn_roofline_pct.train", "optim_ms.train", "fwd_ms.train",
          "bwd_ms.train", "optim_in_step_ms.train", "attn_span_ms.train",
          "host_step_ms.train", "reserved_gib.train")
H100 = "NVIDIA H100 80GB HBM3"
TINY = dict(vocab_size=512, hidden_size=64, num_hidden_layers=3,
            layer_types=["mamba", "attention", "mamba"],
            num_attention_heads=4, num_key_value_heads=2, mamba_n_heads=4,
            mamba_d_head=32, mamba_d_state=8, mamba_chunk_size=8,
            num_experts_per_tok=3, num_local_experts=3, intermediate_size=16,
            shared_intermediate_size=32)


def test_the_cell_and_its_pieces_are_found_by_name():
    cell = harness.load_cell(CELL)
    assert cell.family is fam and cell.driver is train and cell.chips == 1
    assert {m["name"] for m in cell.per_layer} == set(METRICS + SHARED)
    assert cell.mix["batch"] * cell.mix["seq"] == 65536
    conf = cell.config
    assert conf["reduced"] == ["num_hidden_layers", "layer_types",
                               "num_local_experts"]
    assert conf["num_hidden_layers"] == len(conf["layer_types"]) == 10
    assert conf["layer_types"].count("attention") == 1
    assert conf["layer_types"][5] == "attention"
    assert fam.held(conf) == (0, 8)
    assert conf["deployment"]["router_experts"] == 72
    for m in METRICS + SHARED:
        assert callable(harness.reader(m))
    # Attention's calls: the query heads of 128 at the cell's shape, one
    # forward and one backward for the one attention layer.
    assert fam.attention_calls(conf, cell.mix) == ((8, 32, 8192, 128), 1)


def test_scan_operations_and_bytes_by_hand():
    # b 1, S 4, h 1, p 1, n 1, chunk 2: two chunks of T = 3 pairs, each
    # 2T n + 2T p + 4 L p n + 2 p n = 6 + 6 + 8 + 2 operations.
    w = roofline_ssd.ssd_call(1, 4, 1, 1, 1, 2)
    assert w["fwd"]["flops"] == 44 and w["bwd"]["flops"] == 88
    # x 4*2, B and C 2*4*2, dt 4*4 + A 4, y 4*4.
    assert w["fwd"]["bytes"] == 8 + 16 + 20 + 16
    assert w["bwd"]["bytes"] == 2 * (8 + 16 + 20) + 16
    # A ragged last chunk of one position: 2 + 2 + 4 + 2 more.
    assert roofline_ssd.ssd_call(1, 5, 1, 1, 1, 2)["fwd"]["flops"] == 44 + 10


def test_scan_bound_at_the_cells_shape():
    w = roofline_ssd.ssd_call(8, 8192, 128, 64, 128, 256)
    t = 256 * 257 // 2
    per_chunk = (2 * 8 * t * 128 + 2 * 8 * 128 * t * 64
                 + 4 * 8 * 128 * 256 * 64 * 128 + 2 * 8 * 128 * 64 * 128)
    assert w["fwd"]["flops"] == 32 * per_chunk == 415_546_474_496
    x, y = 8 * 8192 * 128 * 64 * 2, 8 * 8192 * 128 * 64 * 4
    assert w["fwd"]["bytes"] == x + 2 * 8 * 8192 * 128 * 2 \
        + 8 * 8192 * 128 * 4 + 128 * 4 + y
    peaks = roofline.PEAKS[H100]
    fwd = roofline.bound_s(w["fwd"]["flops"], w["fwd"]["bytes"],
                           peaks["bf16_flops"], peaks["bytes"])
    assert fwd == pytest.approx(0.9816e-3, rel=1e-3)    # by bytes


def test_operations_a_token_by_hand():
    conf = harness.load_cell(CELL).config
    # embed 100352*4096; a Mamba layer: in_proj 4096*16768, conv 8448*5,
    # dt_bias, A_log, D 3*128, norm 8192, out_proj 8192*4096; attention
    # 2*4096^2 + 2*4096*1024; every layer: two norms, the router 4096*72,
    # the shared SwiGLU 3*4096*1536, and of the held experts 10*8/72 of
    # one expert 3*4096*768; the final norm.
    mamba = 4096 * 16768 + 8448 * 5 + 3 * 128 + 8192 + 8192 * 4096
    attn = 2 * 4096 ** 2 + 2 * 4096 * 1024
    every = 2 * 4096 + 4096 * 72 + 3 * 4096 * 1536 + 10 * 3 * 4096 * 768 \
        * 8 // 72
    touched = 100352 * 4096 + 9 * mamba + attn + 10 * every + 4096
    assert touched == 1_670_204_032
    assert fam.touched_params(conf) == touched
    scan = roofline_ssd.ssd_call(1, 8192, 128, 64, 128, 256)["fwd"]["flops"]
    assert fam.flops_per_token(conf, 8192) == pytest.approx(
        6 * touched + 12 * 4096 * 8192 + 9 * 3 * scan / 8192, rel=1e-12)


@pytest.fixture
def tracer():
    t = tracing.get_tracer()
    t.clear()
    dropped, t.dropped = t.dropped, 0
    yield t
    t.clear()
    t.dropped = dropped


def _steps(tracer, n, ssm_ms, moe_ms):
    """n steps' spans: two scan forwards (forward and recompute) and one
    backward, one expert layer's forward and backward, on the cell's
    shape, with the given device milliseconds each."""
    shape = (8, 8192, 128, 64, 128)
    for i in range(n):
        trace = f"t{i}"

        def span(name, parent, dev_ms, **attrs):
            return tracing.Span(name=name, span_id=f"{trace}.{name}.{id(attrs)}",
                                parent_id=parent, trace_id=trace,
                                start_s=10.0 * i, end_s=10.0 * i + 1,
                                attributes=attrs, _device_ms=dev_ms)

        root = span("train.step", None, 1000.0)
        for name, ms in (("ssm.forward", ssm_ms[0]), ("ssm.forward",
                                                      ssm_ms[0]),
                         ("ssm.backward", ssm_ms[1])):
            tracer.record(span(name, "x", ms, shape=shape, chunk=256))
        for name, ms in (("moe.forward", moe_ms[0]),
                         ("moe.backward", moe_ms[1])):
            tracer.record(span(name, "x", ms, pairs_held=9100 * 8,
                               max_expert_pairs=9400))
        tracer.record(root)


def _ctx(rate=None):
    cell = harness.load_cell(CELL)
    return harness.Context(cell, H100, {"train_tokens_per_s": rate}, None,
                           {})


def test_span_readers_on_spans_put_in_by_hand(tracer):
    _steps(tracer, 4, (30.0, 100.0), (20.0, 15.0))
    ctx = _ctx()
    assert harness.reader("ssm_ms.train")(ctx) == pytest.approx(160.0)
    assert harness.reader("moe_ms.train")(ctx) == pytest.approx(35.0)
    w = roofline_ssd.ssd_call(8, 8192, 128, 64, 128, 256)
    p = roofline.PEAKS[H100]
    bound = sum(k * roofline.bound_s(w[kind]["flops"], w[kind]["bytes"],
                                     p["bf16_flops"], p["bytes"])
                for kind, k in (("fwd", 2), ("bwd", 1)))
    share = harness.reader("ssm_roofline_pct.train")(ctx)
    assert share == pytest.approx(100 * bound / 0.160)
    assert 0 < share < 100


def test_readers_find_nothing_without_spans_or_a_rate(tracer):
    ctx = _ctx()
    for m in ("ssm_ms.train", "moe_ms.train", "ssm_roofline_pct.train",
              "mfu_pct.hybrid_train"):
        assert harness.reader(m)(ctx) is None
    conf = ctx.cell.config
    rate = 16384.0
    mfu = harness.reader("mfu_pct.hybrid_train")(_ctx(rate=rate))
    assert mfu == pytest.approx(100 * rate * fam.flops_per_token(conf, 8192)
                                / 989e12)


def _tiny_cell(dtype):
    conf = json.loads((REPO / "portbench" / "configs" /
                       "granite-4.0-h-small.json").read_text())
    conf.update(TINY)
    conf["deployment"] = dict(conf["deployment"], router_experts=6)
    conf["recipe"] = dict(conf["recipe"], param_dtype=dtype)
    mix = {"kind": "train", "batch": 4, "seq": 20, "pool": 4,
           "check_steps": 2, "busy_steps": 1, "profile_steps": 1}
    limits = json.loads((REPO / "portbench" / "workloads" /
                         f"{CELL}.json").read_text())["limits"]
    return harness.Cell(name="granite-tiny", chips=1, config=conf, mix=mix,
                        limits=limits, family=fam, driver=train,
                        end_to_end=[], per_layer=[])


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 17])
def test_a_tiny_cell_follows_the_reference_in_fp32(seed):
    """The harness's whole path at a tiny size: in fp32 on both sides only
    the order of sums differs (the chunked scan against the quadratic
    form, the experts' sums)."""
    cell = _tiny_cell("float32")
    out = cell.driver.run(cell, seed, 0.0, False, "cpu", lambda: 0.0)
    v = compare.readings(out["readings"]["program"],
                         out["readings"]["reference"])
    assert out["failed"] == 0
    assert v["loss_gap"] < 1e-6
    assert v["grad_norm_gap"] < 1e-5
    assert v["change_norm_gap"] < 1e-4


def test_a_checkout_without_the_model_fails_as_the_cell_loads(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(REPO / "ray_tpu_torch", tmp_path / "ray_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build",
                                                  "granite_hybrid.py"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         "2147500001", "--seconds", "45", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "granite_hybrid" in out.stderr
