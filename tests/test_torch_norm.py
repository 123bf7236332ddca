"""The LayerNorm kernels (csrc/layer_norm.cu) built for the CPU and held
against the JAX package's LayerNorm and its gradients, and the wrapper's
routing and plan.

g++ builds the kernel source against the stub CUDA headers
(``torch_stub_build``); its two C entry points then run on CPU tensors
with the plan the wrapper would choose on a card, at tiny shapes: 16-byte
vectors and element by element, one warp and several a row, several row
groups a block and several rows a group in the backward. y, dx, dscale
and dbias are compared with ``ray_tpu.models.common.layer_norm`` and its
``jax.vjp`` on the same inputs. Without g++ those tests skip:

    python -m pytest tests/test_torch_norm.py -q
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import common as jcommon
from ray_tpu_torch import device as tdevice
from ray_tpu_torch.models import common
from ray_tpu_torch.observability import tracing
from ray_tpu_torch.ops import _build, norm
from torch_stub_build import host_library

F32, BF16, FP16 = torch.float32, torch.bfloat16, torch.float16


@pytest.fixture(autouse=True)
def _full_fp32():
    with tdevice.full_fp32():
        yield


@pytest.fixture(scope="module")
def ln(tmp_path_factory):
    return host_library(tmp_path_factory, "layer_norm",
                        norm._ENTRIES["layer_norm"])


def _offset(x: torch.Tensor, elems: int) -> torch.Tensor:
    """``x`` copied ``elems`` elements past the start of a new buffer."""
    if not elems:
        return x
    buf = torch.empty(x.numel() + elems, dtype=x.dtype)
    out = buf[elems:].view(x.shape)
    out.copy_(x)
    return out


def run_fwd(lib, x, scale, bias, eps=1e-5):
    rows, d = x.shape
    y = torch.full_like(x, float("nan"))
    mean = torch.full((rows,), float("nan"))
    rstd = torch.full((rows,), float("nan"))
    vec, row_threads = norm._plan(d, x.dtype, norm.FWD_ELEMS, (x, y),
                                  (scale, bias))
    err = lib.layer_norm_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), rows, d, row_threads, vec, eps,
        norm._CODE[x.dtype], norm._CODE[scale.dtype], None)
    assert err == 0
    return y, mean, rstd, vec


def run_bwd(lib, dy, x, scale, mean, rstd, sms=1):
    """The backward with the wrapper's grid for a card of ``sms`` SMs."""
    rows, d = x.shape
    dx = torch.full_like(x, float("nan"))
    dscale = torch.full_like(scale, float("nan"))
    dbias = torch.full_like(scale, float("nan"))
    vec, row_threads = norm._plan(d, x.dtype, norm.BWD_ELEMS, (dy, x, dx),
                                  (scale,))
    groups = norm.MAX_THREADS // row_threads
    blocks = min(-(-rows // groups), norm.BWD_BLOCKS_PER_SM * sms)
    partial = torch.full((2, blocks, d), float("nan"))
    err = lib.layer_norm_bwd(
        dy.data_ptr(), x.data_ptr(), scale.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), dx.data_ptr(), partial.data_ptr(),
        dscale.data_ptr(), dbias.data_ptr(), rows, d, row_threads, vec,
        blocks, norm._CODE[x.dtype], norm._CODE[scale.dtype], None)
    assert err == 0
    return dx, dscale, dbias, (vec, row_threads, groups, blocks)


def _rel(got, ref) -> float:
    """Largest |got - ref| over the largest |ref|."""
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def _inputs(rows, d, dtype, pdtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, d, generator=g) * 3 + 1).to(dtype)
    scale = (1 + 0.5 * torch.randn(d, generator=g)).to(pdtype)
    bias = (0.5 * torch.randn(d, generator=g)).to(pdtype)
    dy = torch.randn(rows, d, generator=g).to(dtype)
    return x, scale, bias, dy


_JNP = {F32: jnp.float32, BF16: jnp.bfloat16, FP16: jnp.float16}


def _to_jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(_JNP[t.dtype])


def _to_torch(a, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype)


def _reference(x, scale, bias, dy):
    """The JAX package's LayerNorm and its gradients by ``jax.vjp``, on the
    same inputs: (y, dx, dscale, dbias), each in its input's dtype."""
    y, vjp = jax.vjp(jcommon.layer_norm, *map(_to_jax, (x, scale, bias)))
    grads = vjp(_to_jax(dy))
    return (_to_torch(y, x.dtype),
            *(_to_torch(g, t.dtype) for g, t in zip(grads, (x, scale, bias))))


# 16-bit results are rounded once from fp32 values that differ from the
# JAX package's only by the order of their sums, so they differ by one
# unit in the last place at most: 2^-7 of the largest entry in bf16, 2^-10
# in fp16; fp32 ones by the order of the sums, well under 1e-5 of it.
TOL = {F32: 1e-5, BF16: 2 ** -7, FP16: 2 ** -10}

# (rows, d, x dtype, parameter dtype, misaligned elements, expected plan:
# forward vec and row threads, backward vec and row threads)
CASES = [
    (5, 16, F32, F32, 0, (4, 32, 4, 32)),
    (20, 40, BF16, BF16, 0, (8, 32, 8, 32)),
    (20, 40, BF16, F32, 0, (8, 32, 8, 32)),
    (20, 64, FP16, FP16, 0, (8, 32, 8, 32)),
    (9, 64, FP16, F32, 0, (8, 32, 8, 32)),
    (20, 64, F32, F32, 0, (4, 32, 4, 32)),
    (7, 77, BF16, BF16, 0, (1, 32, 1, 32)),   # odd d: element by element
    (7, 40, BF16, BF16, 1, (1, 32, 1, 32)),   # misaligned x: the same
    (6, 1000, BF16, BF16, 0, (8, 32, 8, 64)),  # two warps a row backward
    (3, 1000, F32, F32, 0, (4, 32, 4, 64)),
    (3, 2200, BF16, BF16, 0, (8, 64, 8, 160)),  # several warps both ways
]


@pytest.mark.parametrize("rows,d,dtype,pdtype,offset,plan", CASES)
def test_host_build_matches_plain_layer_norm(ln, rows, d, dtype, pdtype,
                                             offset, plan):
    """y, mean and rstd, then dx, dscale and dbias, against the JAX
    package's LayerNorm and its ``jax.vjp`` gradients, within TOL."""
    x, scale, bias, dy = _inputs(rows, d, dtype, pdtype, rows * 100 + d)
    x, dy = _offset(x, offset), _offset(dy, offset)
    ry, rdx, rdscale, rdbias = _reference(x, scale, bias, dy)
    y, mean, rstd, vec = run_fwd(ln, x, scale, bias)
    xf = x.float()
    assert _rel(y, ry) <= TOL[dtype]
    assert _rel(mean, xf.mean(-1)) < 1e-5
    var = (xf - xf.mean(-1, keepdim=True)).square().mean(-1)
    assert _rel(rstd, torch.rsqrt(var + 1e-5)) < 1e-5
    dx, dscale, dbias, (bvec, row_threads, *_) = run_bwd(
        ln, dy, x, scale, mean, rstd)
    assert (vec, norm._plan(d, dtype, norm.FWD_ELEMS, (x, y), (scale,))[1],
            bvec, row_threads) == plan
    assert _rel(dx, rdx) <= TOL[dtype]
    assert _rel(dscale, rdscale) <= TOL[pdtype]
    assert _rel(dbias, rdbias) <= TOL[pdtype]
    assert dx.dtype == dtype and dscale.dtype == dbias.dtype == pdtype


@pytest.mark.parametrize("sms", [1, 2, 64])
def test_host_build_backward_is_the_same_on_every_grid(ln, sms):
    """20 rows of 40 in bf16: 2, 3 or 3 blocks of 8 row groups (a group
    takes 2 rows on the smallest grid); each grid sums in its own fixed
    order, and each is within TOL of the JAX package's gradients and
    bit-equal when run again."""
    x, scale, bias, dy = _inputs(20, 40, BF16, F32, 7)
    _, rdx, rdscale, rdbias = _reference(x, scale, bias, dy)
    _, mean, rstd, _ = run_fwd(ln, x, scale, bias)
    first = run_bwd(ln, dy, x, scale, mean, rstd, sms)
    second = run_bwd(ln, dy, x, scale, mean, rstd, sms)
    assert first[3][3] == min(3, 2 * sms)
    for a, b in zip(first[:3], second[:3]):
        assert torch.equal(a, b)
    assert _rel(first[0], rdx) <= TOL[BF16]
    assert _rel(first[1], rdscale) <= TOL[F32]
    assert _rel(first[2], rdbias) <= TOL[F32]


@pytest.mark.parametrize("dtype,pdtype", [(F32, F32), (BF16, BF16),
                                          (BF16, F32), (FP16, FP16)])
def test_plain_layer_norm_matches_jax(dtype, pdtype):
    """The plain version, which the card tests hold the kernels to, and
    its autograd gradients against the JAX package's, within TOL."""
    x, scale, bias, dy = _inputs(9, 40, dtype, pdtype, 11)
    xs = [t.clone().requires_grad_() for t in (x, scale, bias)]
    y = norm.layer_norm_reference(*xs)
    y.backward(dy)
    ref = _reference(x, scale, bias, dy)
    for got, want in zip((y, *(t.grad for t in xs)), ref):
        assert got.dtype == want.dtype
        assert _rel(got, want) <= TOL[want.dtype]


@pytest.mark.parametrize("dtype,d,elems,plan", [
    (BF16, 1600, norm.FWD_ELEMS, (8, 32)),
    (BF16, 1600, norm.BWD_ELEMS, (8, 128)),
    (BF16, 1024, norm.BWD_ELEMS, (8, 64)),
    (F32, 1600, norm.FWD_ELEMS, (4, 32)),
    (F32, 1600, norm.BWD_ELEMS, (4, 128)),
    (BF16, 1601, norm.BWD_ELEMS, (1, 128)),
    (FP16, 4096, norm.BWD_ELEMS, (8, 256)),
])
def test_plan_follows_width_and_dtype(dtype, d, elems, plan):
    """Threads a row and vector width from d and the dtype alone: the two
    cells' widths (1600, 1024), fp32, a width no vector divides, and the
    widest row (every thread of a block)."""
    x = torch.empty(2, d, dtype=dtype)
    scale = torch.empty(d, dtype=dtype)
    assert norm._plan(d, dtype, elems, (x,), (scale,)) == plan


def test_plan_takes_elements_for_misaligned_parameters():
    x = torch.empty(2, 64, dtype=F32)
    scale = _offset(torch.empty(64, dtype=F32), 1)
    assert norm._plan(64, F32, norm.FWD_ELEMS, (x,), (scale,))[0] == 1


def test_cpu_tensors_take_the_plain_version_and_are_counted():
    """The plain version, counted onto the outermost open span of the
    call's trace (both counts, so a reader sees the share); nothing is
    launched, and with no span open nothing is counted."""
    x, scale, bias, _ = _inputs(4, 24, BF16, BF16, 3)
    _build.reset_launch_counts()
    tracer = tracing.get_tracer()
    was, tracer.enabled = tracer.enabled, True
    try:
        with tracing.span("job") as root, tracing.span("phase") as phase:
            y = common.layer_norm(x, scale, bias)
        common.layer_norm(x, scale, bias)
    finally:
        tracer.enabled = was
    assert torch.equal(y, norm.layer_norm_reference(x, scale, bias))
    assert root.attributes == {"norm_kernel_calls": 0, "norm_plain_calls": 1}
    assert phase.attributes == {}
    assert _build.launch_counts() == {}
    assert common.layer_norm is norm.layer_norm


def test_a_launch_that_returns_an_error_raises_naming_its_entry(
        ln, monkeypatch):
    """``_build.launch`` through the host build of the LayerNorm source: a
    launch returning 0 is counted under its entry; one returning a
    ``cudaError_t`` (a dtype code the entry does not know) raises with
    the entry's name and the code, and is not counted."""
    monkeypatch.setattr(_build, "_libs", {"layer_norm": ln})
    monkeypatch.setattr(_build, "_entries", {})
    _build.reset_launch_counts()
    x, scale, bias, _ = _inputs(4, 24, F32, F32, 3)
    y = torch.full_like(x, float("nan"))
    mean, rstd = torch.empty(4), torch.empty(4)
    vec, row_threads = norm._plan(24, F32, norm.FWD_ELEMS, (x, y),
                                  (scale, bias))
    args = (x, scale, bias, y, mean, rstd, 4, 24, row_threads, vec, 1e-5)
    _build.launch(norm._ENTRIES, "layer_norm_fwd", x.device, *args, 0, 0)
    assert _rel(y, norm.layer_norm_reference(x, scale, bias)) <= TOL[F32]
    assert _build.launch_counts() == {"layer_norm_fwd": 1}
    with pytest.raises(RuntimeError,
                       match="^layer_norm_fwd launch failed: cudaError 1$"):
        _build.launch(norm._ENTRIES, "layer_norm_fwd", x.device, *args, 9,
                      0)
    assert _build.launch_counts() == {"layer_norm_fwd": 1}


def test_the_kernel_wrappers_refuse_what_they_do_not_take():
    x, scale, bias, dy = _inputs(4, 24, BF16, BF16, 3)
    with pytest.raises(ValueError, match="run on CUDA"):
        norm.layer_norm_fwd(x, scale, bias)
    with pytest.raises(ValueError, match="run on CUDA"):
        norm.layer_norm_bwd(dy, x, scale, x[:, 0].float(), x[:, 0].float())
    assert norm.MAX_WIDTH == 4096
    assert norm._ENTRIES["layer_norm"]["layer_norm_fwd"][-1] is \
        ctypes.c_void_p
