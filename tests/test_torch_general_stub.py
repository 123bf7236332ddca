"""The general kernels K4, K5 and K6 (csrc/*_general.cu) built for the CPU
and held against their plain versions, and K5 and K6 also against the
Pallas backward body in interpret mode.

g++ compiles each kernel's source, as it is, against the stub CUDA headers
in ``tests/torch_cuda_stub`` (one std::thread a CUDA thread; barriers for
``__syncthreads``, ``__syncwarp`` and the warp shuffles; the cp.async
helpers copy at once; shared memory starts as NaNs), after two textual
rewrites the stub's header describes. The libraries' C entry points then
run on CPU tensors: the kernels' tiling, masks, softmax, rounding of P and
dS and copy paths, at tiny shapes, with no card. Without g++ the tests
skip:

    python -m pytest tests/test_torch_general_stub.py -q
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu_torch import device as tdevice
from ray_tpu_torch.ops import attention as tattn
from torch_stub_build import host_library, host_source


@pytest.fixture(autouse=True)
def _full_fp32():
    with tdevice.full_fp32():
        yield


def _host_kernel(tmp_path_factory, name):
    """The host build of general kernel ``name``, bound as the port binds
    it."""
    return getattr(host_library(tmp_path_factory, name,
                                tattn._GENERAL[name]), name)


@pytest.fixture(scope="module")
def k4(tmp_path_factory):
    return _host_kernel(tmp_path_factory, "flash_fwd_general")


@pytest.fixture(scope="module")
def k5(tmp_path_factory):
    return _host_kernel(tmp_path_factory, "flash_bwd_dkdv_general")


@pytest.fixture(scope="module")
def k6(tmp_path_factory):
    return _host_kernel(tmp_path_factory, "flash_bwd_dq_general")


def _offset(x: torch.Tensor, elems: int) -> torch.Tensor:
    """``x`` copied into a buffer ``elems`` elements past its start: the
    same values at an address aligned to less than 16 bytes."""
    if not elems:
        return x
    buf = torch.empty(x.numel() + elems, dtype=x.dtype)
    out = buf[elems:].view(x.shape)
    out.copy_(x)
    return out


def run_k4(fn, q, k, v, causal, scale):
    b, h, sq, d = q.shape
    o = torch.full_like(q, float("nan"))
    lse = torch.full((b, h, sq), float("nan"))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), b, h, sq, k.shape[2], d, int(causal), scale,
             tattn._DTYPE_CODE[q.dtype], None)
    assert err == 0
    return o, lse


def run_k5(fn, q, k, v, do, lse, delta, causal, scale):
    b, h, sq, d = q.shape
    dk, dv = torch.full_like(k, float("nan")), torch.full_like(v, float("nan"))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             b, h, sq, k.shape[2], d, int(causal), scale,
             tattn._DTYPE_CODE[q.dtype], None)
    assert err == 0
    return dk, dv


def run_k6(fn, q, k, v, do, lse, delta, causal, scale):
    b, h, sq, d = q.shape
    dq = torch.full_like(q, float("nan"))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, sq,
             k.shape[2], d, int(causal), scale, tattn._DTYPE_CODE[q.dtype],
             None)
    assert err == 0
    return dq


def _rel(got, ref) -> float:
    """Largest |got - ref| over the largest |ref|."""
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


F32, BF16, FP16 = torch.float32, torch.bfloat16, torch.float16

# (sq, sk, d, causal, dtype, offset): offset elements of misalignment.
SHAPES = [
    (64, 64, 16, True, F32, 0),      # llama-tiny's head, DL 1
    (70, 130, 16, False, F32, 0),    # ragged, two key tiles
    (130, 70, 64, True, F32, 0),     # DL 2, causal Sq > Sk, three row tiles
    (100, 100, 64, False, BF16, 0),
    (70, 150, 80, True, FP16, 0),    # DL 4, D not a multiple of 32
    (65, 65, 128, False, FP16, 0),   # DL 4, key tiles of 32
    (50, 40, 256, True, F32, 0),     # DL 8, the largest head_dim
    (33, 33, 1, True, F32, 0),       # 4-byte copies
    (40, 70, 1, False, BF16, 0),     # 16-bit odd D: element copies
    (70, 90, 64, True, F32, 1),      # misaligned: 4-byte copies
    (70, 90, 64, True, F32, 2),      # 8-byte aligned: 4-byte copies
    (70, 90, 48, True, BF16, 1),     # 2-byte aligned: element copies
]


def _make(sq, sk, d, dtype, offset):
    """q, k, v and dO ([1, 2, s, d]) from a seed, each ``offset`` elements
    off alignment."""
    g = torch.Generator().manual_seed(sq * 1000 + sk + d)
    mk = lambda s: _offset(torch.randn((1, 2, s, d), generator=g)
                           .to(dtype), offset)
    return mk(sq), mk(sk), mk(sk), mk(sq)


@pytest.mark.parametrize("sq,sk,d,causal,dtype,offset", SHAPES)
def test_k4_host_build_matches_plain(k4, sq, sk, d, causal, dtype, offset):
    """fp32 within 1e-5 of the largest entry (sums in another order),
    16-bit within 2e-2, lse within 1e-4: the card's tolerances."""
    q, k, v, _ = _make(sq, sk, d, dtype, offset)
    scale = d ** -0.5
    o, lse = run_k4(k4, q, k, v, causal, scale)
    ro, rlse = tattn.mha_reference_with_lse(q, k, v, causal, scale)
    assert _rel(o, ro) < (1e-5 if dtype == F32 else 2e-2)
    assert (lse - rlse).abs().max() < 1e-4


@pytest.mark.parametrize("sq,sk,d,causal,dtype,offset", SHAPES)
@pytest.mark.parametrize("kernel", ["k6_dq", "k5_dkdv"])
def test_bwd_host_build_matches_plain(request, kernel, sq, sk, d, causal,
                                      dtype, offset):
    """K6 (dq) and K5 (dk, dv) on lse and delta from the plain forward,
    against flash_bwd_dq_reference / flash_bwd_dkdv_reference: fp32 within
    1e-5 of the largest entry (sums in another order), 16-bit within 2e-2
    (dS and P rounded to 8 or 11 bits, where a sum in another order can
    round them the other way): the card's tolerances. dO is misaligned
    like q, k and v, so the copy size must look at it too."""
    q, k, v, do = _make(sq, sk, d, dtype, offset)
    scale = d ** -0.5
    o, lse = tattn.mha_reference_with_lse(q, k, v, causal, scale)
    delta = (do.float() * o.float()).sum(-1)
    tol = 1e-5 if dtype == F32 else 2e-2
    args = (q, k, v, do, lse, delta, causal, scale)
    if kernel == "k6_dq":
        got = [run_k6(request.getfixturevalue("k6"), *args)]
        ref = [tattn.flash_bwd_dq_reference(*args)]
    else:
        got = run_k5(request.getfixturevalue("k5"), *args)
        ref = tattn.flash_bwd_dkdv_reference(*args)
    for a, r in zip(got, ref):
        assert _rel(a, r) < tol


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_bwd_host_build_copy_size_reads_dout(k5, k6, dtype):
    """q, k and v 16-byte aligned and dO one element off: K5 and K6 must
    take their copy size from dO's address too (the stub reads a
    misaligned copy as NaNs, as the card would fault)."""
    q, k, v, do = _make(70, 90, 64, dtype, 0)
    do = _offset(do, 1)
    scale = 0.125
    o, lse = tattn.mha_reference_with_lse(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True, scale)
    tol = 1e-5 if dtype == F32 else 2e-2
    assert _rel(run_k6(k6, *args), tattn.flash_bwd_dq_reference(*args)) < tol
    for a, r in zip(run_k5(k5, *args), tattn.flash_bwd_dkdv_reference(*args)):
        assert _rel(a, r) < tol


def test_bwd_host_build_matches_pallas_body(k5, k6):
    """K5 and K6, built for the CPU, against _flash_bwd_pallas in interpret
    mode at [1,2,128,128,64] fp32 causal, on the Pallas forward's lse:
    within 1e-5 of the largest entry."""
    rng = np.random.default_rng(2)
    q, k, v, do = (rng.standard_normal((1, 2, 128, 64)).astype(np.float32)
                   for _ in range(4))
    scale = 0.125
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = jattn._flash_fwd_pallas(jq, jk, jv, True, scale, 64, 64,
                                     interpret=True)
    dq_j, dk_j, dv_j = jattn._flash_bwd_pallas(
        jq, jk, jv, o, lse, jdo, True, scale, 64, 64, interpret=True)
    tq, tk, tv, tdo, to, tlse = (torch.from_numpy(np.array(x))
                                 for x in (q, k, v, do, o, lse))
    delta = (tdo * to).sum(-1)
    args = (tq, tk, tv, tdo, tlse, delta, True, scale)
    dk, dv = run_k5(k5, *args)
    dq = run_k6(k6, *args)
    for got, ref in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        assert _rel(got, torch.from_numpy(np.array(ref))) < 1e-5


def test_host_source_rewrites_launches_and_shared_memory():
    text = host_source("  kernel<<<grid, kThreads, smem, stream>>>(args...);\n"
                       "  extern __shared__ uint4 smem_raw[];\n")
    assert "<<<" not in text and "__shared__" not in text
    assert "::rtt_stub::launch(kernel, grid, kThreads, smem, stream, " \
           "args...);" in text
    assert "uint4* smem_raw = reinterpret_cast<uint4*>(" in text
