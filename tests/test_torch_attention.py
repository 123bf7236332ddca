"""Attention of the port (ray_tpu_torch.ops.attention) against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

Inputs are made with numpy from a seed and handed to both packages. On
the CPU the port's kernel wrappers run their plain versions, so this
holds those plain versions (and the autograd wiring around them) to the
Pallas forward bodies and the fused backward body. Everything is fp32:
the tolerance, 2e-5 absolute on values of order one, only absorbs
summation order.

The CUDA kernels themselves are held to the same plain versions on the
card, by ``chip_smoke.py`` and by ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu_torch import device as tdevice
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as tattn

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _full_fp32():
    """fp32 products at full precision whatever the process was left with:
    the plain versions are the reference here (see ``device.full_fp32``)."""
    with tdevice.full_fp32():
        yield


def _inputs(b, h, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, sk, d)).astype(np.float32)
    do = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    return q, k, v, do


def _close(actual, desired, atol=ATOL):
    np.testing.assert_allclose(np.asarray(actual, np.float32),
                               np.asarray(desired, np.float32),
                               rtol=0, atol=atol,
                               err_msg=tdevice.fp32_settings())


# (b, h, sq, sk, d, causal, block): block is the Pallas tiling.
CASES = [
    (2, 2, 128, 128, 64, True, 64),
    (2, 2, 128, 128, 64, False, 64),
    (1, 3, 64, 128, 32, False, 32),
    (1, 2, 128, 64, 32, True, 32),
]


@pytest.mark.parametrize("b,h,sq,sk,d,causal,block", CASES)
def test_forward_matches_pallas(b, h, sq, sk, d, causal, block):
    q, k, v, _ = _inputs(b, h, sq, sk, d)
    scale = d ** -0.5
    o_j, lse_j = jattn._flash_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
        block, block, interpret=True)
    o_t, lse_t = tattn.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal, scale)
    _close(o_t, o_j)
    _close(lse_t, lse_j)
    assert lse_t.dtype == torch.float32 and lse_t.shape == (b, h, sq)


def test_online_forward_body_matches(monkeypatch):
    """Sk above _SINGLE_PASS_MAX_SK runs the online-softmax body
    (_flash_fwd_kernel): lower the threshold so a small Sk takes it."""
    monkeypatch.setattr(jattn, "_SINGLE_PASS_MAX_SK", 64)
    for causal in (True, False):
        q, k, v, _ = _inputs(1, 2, 128, 128, 32, seed=3)
        o_j, lse_j = jattn._flash_fwd_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
            32 ** -0.5, 32, 32, interpret=True)
        o_t, lse_t = tattn.attention_with_lse(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal)
        _close(o_t, o_j)
        _close(lse_t, lse_j)


@pytest.mark.parametrize("b,h,sq,sk,d,causal,block", CASES)
def test_backward_matches_pallas(b, h, sq, sk, d, causal, block):
    """dq, dk, dv through the port's autograd.Function against jax.grad
    of ray_tpu's custom-VJP flash attention (Pallas backward body)."""
    q, k, v, do = _inputs(b, h, sq, sk, d, seed=1)

    def f(q_, k_, v_):
        o = jattn.flash_attention(q_, k_, v_, causal=causal, block_q=block,
                                  block_k=block)
        return jnp.sum(o * jnp.asarray(do))

    grads_j = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = tattn.attention(*ts, causal=causal, impl="flash")
    (o * torch.from_numpy(do)).sum().backward()
    for t, gj in zip(ts, grads_j):
        _close(t.grad, gj)


def test_backward_plain_versions_match_pallas_body():
    """The plain versions of K2 and K3, called with the saved lse and
    delta, against _flash_bwd_pallas in interpret mode."""
    q, k, v, do = _inputs(1, 2, 128, 128, 64, seed=2)
    scale = 0.125
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = jattn._flash_fwd_pallas(jq, jk, jv, True, scale, 64, 64,
                                     interpret=True)
    dq_j, dk_j, dv_j = jattn._flash_bwd_pallas(
        jq, jk, jv, o, lse, jdo, True, scale, 64, 64, interpret=True)
    tq, tk, tv, tdo, to, tlse = (torch.from_numpy(np.array(x))
                                 for x in (q, k, v, do, o, lse))
    delta = (tdo * to).sum(-1)
    dk_t, dv_t = tattn.flash_bwd_dkdv(tq, tk, tv, tdo, tlse, delta, True,
                                      scale)
    dq_t = tattn.flash_bwd_dq(tq, tk, tv, tdo, tlse, delta, True, scale)
    _close(dq_t, dq_j)
    _close(dk_t, dk_j)
    _close(dv_t, dv_j)


def test_reference_q_offset_and_masked_rows():
    """q_offset shifts causal positions; rows that see no key keep a
    finite lse near -1e30, as in ray_tpu's reference."""
    q, k, v, _ = _inputs(1, 2, 16, 16, 8)
    for off in (-4, 0, 5):
        o_j, lse_j = jattn.mha_reference_with_lse(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            q_offset=off)
        o_t, lse_t = tattn.mha_reference_with_lse(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=True, q_offset=off)
        _close(o_t, o_j)
        assert torch.isfinite(lse_t).all()
        np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                                   rtol=1e-6, atol=ATOL)
        if off < 0:  # rows 0..-off-1 see no key
            assert float(lse_t[..., :-off].max()) < -1e29


def test_full_fp32_holds_the_plain_forward_exact():
    """A process left with oneDNN's fp32 products in bf16 (which moves
    this forward by ~1e-2 on CPUs with bf16 units) reads every fp32
    setting as IEEE inside ``full_fp32``, computes the plain forward to
    fp32 accuracy there, and gets its settings back afterwards."""
    q, k, v, _ = _inputs(2, 2, 128, 128, 64)
    ts = [torch.from_numpy(x) for x in (q, k, v)]
    exact, _ = tattn.mha_reference_with_lse(*(t.double() for t in ts))
    knobs = tdevice.fp32_knobs()
    assert "mkldnn.matmul" in knobs  # PyTorch >= 2.9
    prev = {name: obj.fp32_precision for name, obj in knobs.items()}
    knobs["mkldnn.matmul"].fp32_precision = "bf16"
    try:
        with tdevice.full_fp32():
            inside = {n: obj.fp32_precision for n, obj in knobs.items()}
            o, _ = tattn.mha_reference_with_lse(*ts)
        after = knobs["mkldnn.matmul"].fp32_precision
        settings = tdevice.fp32_settings()
    finally:
        for name, obj in knobs.items():
            obj.fp32_precision = prev[name]
    assert set(inside.values()) == {"ieee"}, inside
    assert after == "bf16"
    assert "mkldnn.matmul.fp32_precision=bf16" in settings
    _close(o.double(), exact, atol=2e-6)


@pytest.mark.parametrize("sq", [1000, 333])
def test_stats_rows_pad_to_16_bytes(sq):
    """lse/delta rows for K2's TMA loads: ``ld`` a multiple of 4 floats,
    the first Sq values of every row unchanged, no copy when Sq fits."""
    q = torch.zeros((2, 3, sq, 64))
    lse = torch.randn((2, 3, sq))
    rows, ld = tattn._stats_rows(lse, q)
    assert ld % 4 == 0 and sq <= ld < sq + 4
    assert rows.shape == (2, 3, ld) and rows.is_contiguous()
    assert torch.equal(rows[..., :sq], lse)
    assert (rows.data_ptr() == lse.data_ptr()) == (ld == sq)


def test_reference_impl_matches_flash_path():
    q, k, v, _ = _inputs(1, 2, 32, 32, 16)
    ts = [torch.from_numpy(x) for x in (q, k, v)]
    _close(tattn.attention(*ts, impl="reference"),
           tattn.attention(*ts, impl="auto"))
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.attention(*ts, impl="ring")


def test_cpu_path_counts_no_launches():
    _build.reset_launch_counts()
    q, k, v, _ = _inputs(1, 1, 8, 8, 64)
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    tattn.flash_attention(*ts).sum().backward()
    counts = _build.launch_counts()
    assert [counts[f.__name__] for f in tattn.KERNEL_WRAPPERS] == [0, 0, 0]


# ---------------------------------------------------------------------------
# The route: Hopper kernels or general kernels, by dtype and head_dim
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,head_dim,hopper", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
    (torch.float16, 64, True), (torch.float16, 128, True),
    (torch.float32, 64, False), (torch.float32, 128, False),
    (torch.bfloat16, 16, False), (torch.bfloat16, 32, False),
    (torch.float16, 32, False), (torch.float32, 16, False)])
def test_attention_route_by_dtype_and_head_dim(monkeypatch, dtype, head_dim,
                                               hopper):
    """The Hopper kernels for bf16/fp16 at head_dim 64 and 128, the general
    kernels for anything else; on the card each entry point goes to the
    chosen forward kernel and raises when it cannot be launched, never
    falling back to the plain attention. (A meta tensor, with
    ``_build.on_card`` taking it, stands in for the card.)"""
    want = tattn.KERNEL_WRAPPERS if hopper else tattn.GENERAL_WRAPPERS
    assert tattn.kernels_for(dtype, head_dim) is want
    assert tattn.hopper_takes(dtype, head_dim) is hopper

    def broken(table, entry, device, *args, name=None):
        raise RuntimeError(f"cannot launch {entry}")

    monkeypatch.setattr(_build, "on_card", lambda t: True)
    monkeypatch.setattr(_build, "launch", broken)
    _build.reset_launch_counts()
    q = torch.empty((1, 2, 8, head_dim), dtype=dtype, device="meta")
    fwd = "flash_fwd" if hopper else "flash_fwd_general"
    with pytest.raises(RuntimeError, match=f"cannot launch {fwd}$"):
        tattn.flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match=f"cannot launch {fwd}$"):
        tattn.attention_with_lse(q, q, q)
    assert _build.launch_counts() == {}


def test_cpu_inputs_launch_no_kernel():
    """fp32 at head_dim 16 on the CPU: the general route's plain versions,
    forward and backward, equal the plain attention; nothing launches."""
    _build.reset_launch_counts()
    q, k, v, _ = _inputs(1, 2, 8, 8, 16)
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    refs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = tattn.flash_attention(*ts)
    o.sum().backward()
    ro = tattn.mha_reference(*refs)
    ro.sum().backward()
    _close(o.detach(), ro.detach())
    for t, r in zip(ts, refs):
        _close(t.grad, r.grad)
    o2, lse = tattn.attention_with_lse(*(t.detach() for t in ts))
    _close(o2, ro.detach())
    assert lse.shape == (1, 2, 8)
    assert _build.launch_counts() == {}


# ---------------------------------------------------------------------------
# Device choice and the absence of a fallback
# ---------------------------------------------------------------------------

def test_default_device_is_cuda_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.default_device("cuda")
    assert tdevice.default_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tdevice.default_device() == torch.device("cuda")


def test_train_entry_point_refuses_missing_cuda(monkeypatch):
    from ray_tpu_torch.train.step import build_train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_train(lambda g: torch.nn.Linear(2, 2), lambda m, b: 0)


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_kernel_path_raises_when_build_fails(monkeypatch, tmp_path, which):
    """A tensor on the card goes to the kernel; when the kernel cannot be
    built the call raises and never falls back to the plain version. (A
    meta tensor, with ``_build.on_card`` taking it, stands in for the
    card.)"""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_entries", {})
    monkeypatch.setattr(_build, "on_card", lambda t: True)

    def no_nvcc():
        raise RuntimeError("nvcc not found (test)")

    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    _build.reset_launch_counts()
    q = torch.empty((1, 2, 8, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        if which == "fwd":
            tattn.flash_attention(q, q, q)
        else:
            lse = torch.empty((1, 2, 8), device="meta")
            tattn.flash_bwd_dq(q, q, q, q, lse, lse, True, 0.125)
    assert _build.launch_counts() == {}


def test_kernel_path_raises_when_loader_fails(monkeypatch, tmp_path):
    """A library that builds but cannot be loaded raises; nothing is bound
    or launched, and nothing falls back. (The build is skipped and the
    build directory left empty.)"""
    monkeypatch.setattr(_build, "build", lambda names: dict.fromkeys(names))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_entries", {})
    monkeypatch.setattr(_build, "on_card", lambda t: True)
    _build.reset_launch_counts()
    q = torch.empty((1, 2, 8, 64), dtype=torch.bfloat16, device="meta")
    lse = torch.empty((1, 2, 8), device="meta")
    with pytest.raises(OSError, match=r"flash_fwd-[0-9a-f]{16}\.so"):
        tattn.attention_with_lse(q, q, q)
    with pytest.raises(OSError, match=r"flash_\w+-[0-9a-f]{16}\.so"):
        tattn.flash_bwd_dkdv(q, q, q, q, lse, lse, True, 0.125)
    assert _build._entries == {} and _build.launch_counts() == {}


def test_build_keeps_nvcc_log_beside_library(monkeypatch, tmp_path):
    """ptxas's report of a library survives its build: a later process
    that finds the library built reads the same log."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = -o ] && '
                    'out="$2"; shift; done\necho "ptxas info: Used 42 '
                    'registers"\n: > "$out"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "build_logs", {})
    secs = _build.build(["flash_fwd"])
    assert secs["flash_fwd"] > 0
    assert "Used 42 registers" in _build.build_logs["flash_fwd"]
    monkeypatch.setattr(_build, "build_logs", {})
    assert _build.build(["flash_fwd"]) == {"flash_fwd": 0.0}
    assert "Used 42 registers" in _build.build_logs["flash_fwd"]


def test_every_kernel_is_built_on_the_hopper_header():
    """Each Hopper kernel source includes csrc/hopper.cuh and runs its
    products on wgmma; each general one (fp32 or head dims other than 64
    and 128) includes csrc/general.cuh; the LayerNorm source (its own
    group: no products) includes neither; the Mamba-2 scan's sources (their
    own group) include csrc/ssd.cuh, whose products are mma.sync; no other
    source has mma.sync, and those are the only headers. The RMSNorm
    source is in LayerNorm's group."""
    hopper = {f.__name__ for f in tattn.KERNEL_WRAPPERS}
    general = {f.__name__ for f in tattn.GENERAL_WRAPPERS}
    norm = {"layer_norm": ("layer_norm_fwd", "layer_norm_bwd"),
            "rms_norm": ("rms_norm_fwd", "rms_norm_bwd",
                         "gated_rms_norm_fwd", "gated_rms_norm_bwd")}
    scan = {"ssd_state", "ssd_scan", "ssd_grad"}
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == \
        hopper | general | set(norm) | scan
    for src in _build.CSRC.glob("*.cu"):
        text = src.read_text()
        assert "mma.sync" not in text, src.name
        if src.stem in hopper:
            assert '#include "hopper.cuh"' in text, src.name
            assert "wgmma_" in text, src.name
        elif src.stem in general:
            assert '#include "general.cuh"' in text, src.name
        elif src.stem in scan:
            assert '#include "ssd.cuh"' in text, src.name
            assert "hopper.cuh" not in text and "general.cuh" not in text
            assert f'extern "C" int {src.stem}_launch(' in text, src.name
        else:
            assert ".cuh" not in text and "wgmma" not in text, src.name
            for entry in norm[src.stem]:
                assert f'extern "C" int {entry}(' in text, entry
    for header in ("hopper.cuh", "general.cuh"):
        assert "mma.sync" not in (_build.CSRC / header).read_text(), header
    assert "mma.sync" in (_build.CSRC / "ssd.cuh").read_text()
    assert sorted(p.name for p in _build.CSRC.glob("*.cuh")) == [
        "general.cuh", "hopper.cuh", "ssd.cuh"]


def test_build_names_every_kernel_source():
    """``build()`` compiles every source, the attention kernels and the
    LayerNorm kernels alike, each into its own library."""
    assert set(_build.KERNELS) == {
        p.stem for p in _build.CSRC.glob("*.cu")}
    assert "layer_norm" in _build.KERNELS
    paths = {_build._library_path(n) for n in _build.KERNELS}
    assert len(paths) == len(_build.KERNELS)
    assert all(p.parent == _build.BUILD_DIR for p in paths)
