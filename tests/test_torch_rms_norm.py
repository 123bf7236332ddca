"""The RMSNorm kernels (csrc/rms_norm.cu), the plain form and Mamba-2's
gated form with its skip, held to the fp32 autograd of the plain versions
they replace (``ops.norm.rms_norm_reference``, ``gated_rms_norm_reference``;
``tests/test_torch_gpt2.py`` holds the plain RMSNorm to the JAX package's).

Without a card, g++ builds the kernel source against the stub CUDA headers
(``torch_stub_build``) and the port's own wrappers and autograd functions
run it on CPU tensors, at tiny shapes, with the card-or-plain rule told
that the tensors are on a card: the dispatch, the plan and the arguments
each launch is handed, 16-byte vectors and element by element, one warp
and several a row, several rows a block, several blocks. Without g++ those
skip. On a card (marker ``cuda``) the kernels run at the Granite cell's
shapes and Llama's width. The file imports neither JAX nor ``ray_tpu``:

    python -m pytest tests/test_torch_rms_norm.py -q
"""

import pytest
import torch
import torch.nn.functional as F

from ray_tpu_torch import device as tdevice
from ray_tpu_torch.models import common
from ray_tpu_torch.observability import tracing
from ray_tpu_torch.ops import _build, norm
from torch_stub_build import host_library

F32, BF16, FP16 = torch.float32, torch.bfloat16, torch.float16
# Both ways compute in fp32 and round once to the output's type; their fp32
# values differ only by the order of the sums (and rsqrt against 1/sqrt), a
# few fp32 units. So a 16-bit output differs by one unit in its last place
# at most, 2^-7 of the largest entry in bf16 and 2^-10 in fp16. fp32
# outputs by far less than 1e-5 of it, and fp32 parameter gradients, summed
# over up to 4M terms a head, by less than 1e-4 of it.
TOL = {F32: 1e-5, BF16: 2 ** -7, FP16: 2 ** -10}
PARAM_TOL = {F32: 1e-4, BF16: 2 ** -7, FP16: 2 ** -10}


@pytest.fixture(autouse=True)
def _full_fp32():
    with tdevice.full_fp32():
        yield


def _rel(got, ref) -> float:
    """Largest |got - ref| over the largest |ref|."""
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def _offset(x: torch.Tensor, elems: int) -> torch.Tensor:
    """``x`` copied ``elems`` elements past the start of a new buffer."""
    if not elems:
        return x
    buf = torch.empty(x.numel() + elems, dtype=x.dtype, device=x.device)
    out = buf[elems:].view(x.shape)
    out.copy_(x)
    return out


def _plain_inputs(rows, d, dtype, pdtype, device="cpu", seed=0, offset=0):
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device=device)  # noqa: E731
    x = _offset((mk(rows, d) * 3 + 1).to(dtype), offset)
    scale = (1 + 0.5 * mk(d)).to(pdtype)
    return x, scale, mk(rows, d).to(dtype)


def _gated_inputs(b, s, h, p, n, dtype, pdtype, device="cpu", seed=0,
                  offset=0):
    """(y, xbc, D, proj, scale, dout): the scan's fp32 output y, the conv's
    row of d + 2 n (x its first d, ``offset`` elements off 16 bytes),
    in_proj's row of d + (d + 2 n) + h (z its first d), D, the norm's
    scale and the output's gradient, as the mixer has them."""
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device=device)  # noqa: E731
    d = h * p
    proj = (mk(b, s, 2 * d + 2 * n + h) * 2).to(dtype)
    xbc = _offset(mk(b, s, d + 2 * n).to(dtype), offset)
    y = mk(b, s, h, p)
    D = (1 + 0.5 * mk(h)).to(pdtype)
    scale = (1 + 0.5 * mk(d)).to(pdtype)
    return y, xbc, D, proj, scale, mk(b, s, d).to(dtype)


def _leaves(*ts):
    """Leaves sharing each tensor's memory (its address and strides too)."""
    return [t.detach().requires_grad_() for t in ts]


def _run_plain(x, scale, dout, eps=1e-6):
    """((out, want), (dx, want), (dscale, want)): through ``rms_norm``,
    and through the plain version's fp32 autograd with its results in the
    inputs' types, as the composite's own casts leave them."""
    xs = _leaves(x, scale)
    got = [common.rms_norm(*xs, eps)]
    got += torch.autograd.grad(got[0], xs, dout)
    refs = [t.detach().float().requires_grad_() for t in (x, scale)]
    ref = norm.rms_norm_reference(*refs, eps)
    want = [ref.to(x.dtype)] + [r.to(t.dtype) for r, t in zip(
        torch.autograd.grad(ref, refs, dout.float()), (x, scale))]
    return list(zip(got, want))


def _split(xbc, proj, h, p):
    """The mixer's views: x [b, s, h, p] of xbc, z [b, s, h p] of proj."""
    return xbc[..., :h * p].unflatten(-1, (h, p)), proj[..., :h * p]


def _run_gated(y, xbc, D, proj, scale, dout, h, p, eps=1e-5):
    """((out, want), (dy, want), (dx, want), (dD, want), (dz, want),
    (dscale, want)) through ``gated_rms_norm`` on the mixer's views, and
    through the plain version's fp32 autograd as ``_run_plain``."""
    y, xbc, D, proj, scale = _leaves(y, xbc, D, proj, scale)
    x, z = _split(xbc, proj, h, p)
    ins = (y, x, D, z, scale)
    got = [norm.gated_rms_norm(*ins, eps)]
    got += torch.autograd.grad(got[0], ins, dout)
    refs = [t.detach().float().requires_grad_() for t in ins]
    ref = norm.gated_rms_norm_reference(*refs, eps)
    want = [ref.to(z.dtype)] + [r.to(t.dtype) for r, t in zip(
        torch.autograd.grad(ref, refs, dout.float()), ins)]
    return list(zip(got, want))


def _check(pairs, types):
    """Each (got, want) of ``pairs`` in ``want``'s dtype and within the
    tolerance ``types`` gives it: "out" the output's type, "param" the
    parameters' (``PARAM_TOL``)."""
    for i, ((got, want), kind) in enumerate(zip(pairs, types)):
        assert got.dtype == want.dtype and got.shape == want.shape, i
        tol = (PARAM_TOL if kind == "param" else TOL)[want.dtype]
        assert _rel(got, want) <= tol, (i, _rel(got, want), tol)


PLAIN_KINDS = ("out", "out", "param")
GATED_KINDS = ("out", "out", "out", "param", "out", "param")


# -- the host build: the port's wrappers on CPU tensors -----------------------

@pytest.fixture(scope="module")
def host_rms(tmp_path_factory):
    return host_library(tmp_path_factory, "rms_norm",
                        norm._RMS_ENTRIES["rms_norm"])


@pytest.fixture
def launches(host_rms, monkeypatch):
    """The host build in place of the card's library, CPU tensors taken
    for a card's by the card-or-plain rule, a card of 2 SMs; yields the
    (entry, arguments) of each launch."""
    monkeypatch.setattr(_build, "_libs", {"rms_norm": host_rms})
    monkeypatch.setattr(_build, "_entries", {})
    monkeypatch.setattr(_build, "on_card", lambda t: True)
    monkeypatch.setattr(norm, "_sms", lambda index: 2)
    _build.reset_launch_counts()
    calls = []
    launch = _build.launch

    def record(table, entry, device, *args, **kw):
        calls.append((entry, args))
        return launch(table, entry, device, *args, **kw)

    monkeypatch.setattr(_build, "launch", record)
    yield calls


# Where each entry point takes row_threads (vec follows it).
ROW_THREADS_AT = {"rms_norm_fwd": 6, "rms_norm_bwd": 9,
                  "gated_rms_norm_fwd": 12, "gated_rms_norm_bwd": 18}


def _plan_of(entry, args):
    """(vec, row_threads) as a launch was handed them."""
    at = ROW_THREADS_AT[entry]
    return args[at + 1], args[at]


# (rows, d, x dtype, parameter dtype, misaligned elements, expected plan:
# forward vec and row threads, backward vec and row threads)
PLAIN_CASES = [
    (5, 16, F32, F32, 0, (4, 32, 4, 32)),
    (20, 40, BF16, BF16, 0, (8, 32, 8, 32)),
    (20, 40, BF16, F32, 0, (8, 32, 8, 32)),
    (20, 64, FP16, FP16, 0, (8, 32, 8, 32)),
    (9, 64, FP16, F32, 0, (8, 32, 8, 32)),
    (7, 77, BF16, BF16, 0, (1, 32, 1, 32)),    # odd d: element by element
    (7, 40, BF16, BF16, 1, (1, 32, 1, 32)),    # misaligned x: the same
    (6, 1000, BF16, BF16, 0, (8, 64, 8, 64)),  # several warps a row
    (3, 2200, F32, F32, 0, (4, 160, 4, 160)),
    (70, 48, BF16, BF16, 0, (8, 32, 8, 32)),   # several blocks; rows a loop
]


@pytest.mark.parametrize("rows,d,dtype,pdtype,offset,plan", PLAIN_CASES)
def test_host_build_plain_matches_plain_version(launches, rows, d, dtype,
                                                pdtype, offset, plan):
    """``rms_norm`` through the kernels, forward and backward, against the
    plain version's fp32 autograd: one launch each way, with the plan the
    width, dtype and alignment call for."""
    x, scale, dout = _plain_inputs(rows, d, dtype, pdtype, seed=rows + d,
                                   offset=offset)
    _check(_run_plain(x, scale, dout), PLAIN_KINDS)
    assert [e for e, _ in launches] == ["rms_norm_fwd", "rms_norm_bwd"]
    assert sum((_plan_of(*c) for c in launches), ()) == plan


# (b, s, heads, head size, n (the conv row's extra 2 n), x dtype, parameter
# dtype, misaligned elements of x, expected plan as above)
GATED_CASES = [
    (2, 5, 8, 16, 16, BF16, BF16, 0, (8, 32, 8, 32)),
    (2, 5, 8, 16, 16, BF16, F32, 0, (8, 32, 8, 32)),
    (2, 5, 8, 16, 16, F32, F32, 0, (4, 32, 4, 32)),
    (2, 5, 8, 16, 16, FP16, FP16, 0, (8, 32, 8, 32)),
    (1, 7, 4, 16, 8, FP16, FP16, 0, (1, 32, 1, 32)),  # z's row stride odd
    (2, 3, 3, 12, 8, BF16, BF16, 0, (1, 32, 1, 32)),  # heads of 12
    (2, 5, 8, 16, 16, BF16, BF16, 1, (1, 32, 1, 32)),  # misaligned x
    (1, 3, 16, 64, 16, BF16, BF16, 0, (8, 64, 8, 64)),  # several warps
    (4, 20, 8, 16, 16, BF16, BF16, 0, (8, 32, 8, 32)),  # rows a loop
]


@pytest.mark.parametrize("b,s,h,p,n,dtype,pdtype,offset,plan", GATED_CASES)
def test_host_build_gated_matches_plain_version(launches, b, s, h, p, n,
                                                dtype, pdtype, offset,
                                                plan):
    """``gated_rms_norm`` on the mixer's views through the kernels against
    the plain version's fp32 autograd: the output and the gradients of y,
    x, D, z and the scale; x and z handed over at their row strides
    (d + 2 n and 2 d + 2 n + h), not copied."""
    ins = _gated_inputs(b, s, h, p, n, dtype, pdtype, seed=b * s + h,
                        offset=offset)
    _check(_run_gated(*ins, h, p), GATED_KINDS)
    assert [e for e, _ in launches] == ["gated_rms_norm_fwd",
                                        "gated_rms_norm_bwd"]
    assert sum((_plan_of(*c) for c in launches), ()) == plan
    d = h * p
    for entry, args in launches:
        at = ROW_THREADS_AT[entry] - 3  # head_dim, x's and z's row strides
        assert args[at:at + 3] == (p, d + 2 * n, 2 * d + 2 * n + h)


@pytest.mark.parametrize("sms", [1, 2, 64])
def test_host_build_backward_sums_in_a_fixed_order(launches, monkeypatch,
                                                   sms):
    """The gated backward at 80 rows on a card of 1, 2 or 64 SMs (1, 2 or
    5 blocks of 16 rows a pass): within tolerance each, and dD and dscale
    the same bits when run again."""
    monkeypatch.setattr(norm, "_sms", lambda index: sms)
    y, xbc, D, proj, scale, dout = _gated_inputs(4, 20, 8, 16, 16, BF16,
                                                 F32, seed=5)
    x, z = (t.reshape(80, -1) for t in _split(xbc, proj, 8, 16))
    y2 = y.reshape(80, -1)
    _, rstd = norm.gated_rms_norm_fwd(y2, x, D, z, scale, 1e-5)
    first = norm.gated_rms_norm_bwd(dout.reshape(80, -1), y2, x, D, z,
                                    scale, rstd)
    second = norm.gated_rms_norm_bwd(dout.reshape(80, -1), y2, x, D, z,
                                     scale, rstd)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert launches[-1][1][20] == min(5, sms)  # blocks
    want = _run_gated(y, xbc, D, proj, scale, dout, 8, 16)
    _check([(first[2], want[3][0]), (first[4], want[5][0])],
           ("param", "param"))


def test_host_build_counts_each_call_on_its_trace(launches):
    """A kernel call forward and one backward each add one to
    ``rms_norm_kernel_calls`` on the outermost open span of the trace."""
    x, scale, dout = _plain_inputs(4, 24, BF16, BF16)
    y, xbc, D, proj, scale2, dout2 = _gated_inputs(1, 4, 2, 16, 8, BF16,
                                                   BF16)
    tracer = tracing.get_tracer()
    was, tracer.enabled = tracer.enabled, True
    try:
        with tracing.span("job") as root, tracing.span("phase") as phase:
            _run_plain(x, scale, dout)
            _run_gated(y, xbc, D, proj, scale2, dout2, 2, 16)
    finally:
        tracer.enabled = was
    assert root.attributes == {"rms_norm_kernel_calls": 4,
                               "rms_norm_plain_calls": 0}
    assert phase.attributes == {}
    assert _build.launch_counts() == {
        "rms_norm_fwd": 1, "rms_norm_bwd": 1, "gated_rms_norm_fwd": 1,
        "gated_rms_norm_bwd": 1}


def test_the_kernel_wrappers_refuse_what_they_do_not_take(launches):
    x, scale, dout = _plain_inputs(4, norm.RMS_MAX_WIDTH + 1, BF16, BF16)
    with pytest.raises(ValueError, match="d 1 to 8192"):
        common.rms_norm(x, scale)
    x, scale, _ = _plain_inputs(4, 64, BF16, FP16)
    with pytest.raises(TypeError, match="dtype or fp32"):
        norm.rms_norm_fwd(x, scale)
    y, xbc, D, proj, scale, _ = _gated_inputs(1, 4, 2, 16, 8, BF16, BF16)
    x, z = _split(xbc, proj, 2, 16)
    with pytest.raises(ValueError, match="contiguous fp32"):
        norm.gated_rms_norm(y.to(BF16), x, D, z, scale)
    with pytest.raises(ValueError, match="heads"):
        norm.gated_rms_norm_fwd(y.reshape(4, 32), x.reshape(4, 32),
                                D[:1].expand(3).contiguous(),
                                z.reshape(4, 32), scale)
    assert launches == []


# -- off the card: the plain versions -----------------------------------------

def _old_rms_norm(x, scale, eps):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_plain_versions_are_the_old_expressions_bit_for_bit(dtype):
    """On the CPU ``rms_norm`` and ``gated_rms_norm`` are the composites
    the models computed before the kernels (``models/common.rms_norm``;
    the mixer's skip, gate, norm and cast), values and gradients."""
    x, scale, dout = _plain_inputs(6, 40, dtype, dtype)
    xs, olds = _leaves(x, scale), _leaves(x.clone(), scale.clone())
    new, old = common.rms_norm(*xs, 1e-5), _old_rms_norm(*olds, 1e-5)
    assert torch.equal(new, old)
    for a, b in zip(torch.autograd.grad(new, xs, dout),
                    torch.autograd.grad(old, olds, dout)):
        assert torch.equal(a, b)
    y, xbc, D, proj, scale, dout = _gated_inputs(2, 3, 4, 8, 4, dtype, dtype)
    ins = _leaves(y, xbc, D, proj, scale)
    x, z = _split(ins[1], ins[3], 4, 8)
    new = norm.gated_rms_norm(ins[0], x, ins[2], z, ins[4], 1e-5)
    olds = _leaves(y, xbc.clone(), D, proj.clone(), scale)
    ox, oz = _split(olds[1], olds[3], 4, 8)
    u = olds[0] + olds[2].float()[:, None] * ox.float()
    old = _old_rms_norm(u.flatten(2) * F.silu(oz.float()), olds[4],
                        1e-5).to(dtype)
    assert torch.equal(new, old)
    for a, b in zip(torch.autograd.grad(new, ins, dout),
                    torch.autograd.grad(old, olds, dout)):
        assert torch.equal(a, b)


def test_cpu_tensors_take_the_plain_versions_and_are_counted():
    """Both forms' plain versions, each call counted onto the outermost
    open span of its trace (both counts, so a reader sees the share);
    nothing launched, and with no span open nothing counted."""
    x, scale, _ = _plain_inputs(4, 24, BF16, BF16)
    y, xbc, D, proj, scale2, _ = _gated_inputs(1, 4, 2, 16, 8, BF16, BF16)
    x2, z = _split(xbc, proj, 2, 16)
    _build.reset_launch_counts()
    tracer = tracing.get_tracer()
    was, tracer.enabled = tracer.enabled, True
    try:
        with tracing.span("job") as root, tracing.span("phase") as phase:
            out = common.rms_norm(x, scale)
            gated = norm.gated_rms_norm(y, x2, D, z, scale2)
        common.rms_norm(x, scale)
    finally:
        tracer.enabled = was
    assert torch.equal(out, norm.rms_norm_reference(x, scale))
    assert torch.equal(gated, norm.gated_rms_norm_reference(y, x2, D, z,
                                                            scale2))
    assert root.attributes == {"rms_norm_kernel_calls": 0,
                               "rms_norm_plain_calls": 2}
    assert phase.attributes == {}
    assert _build.launch_counts() == {}
    assert common.rms_norm is norm.rms_norm


def test_the_kernels_refuse_tensors_off_the_card():
    x, scale, dout = _plain_inputs(4, 24, BF16, BF16)
    with pytest.raises(ValueError, match="run on CUDA"):
        norm.rms_norm_fwd(x, scale)
    with pytest.raises(ValueError, match="run on CUDA"):
        norm.rms_norm_bwd(dout, x, scale, x[:, 0].float())


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,offset", [
    (4096, 4096, 0),   # Granite's input, post and final norms
    (4096, 2048, 0),   # Llama's width
    (3, 2048, 0),      # a decode step's few rows
    (1000, 3001, 0),   # an odd width: element by element
    (1000, 4096, 1),   # a misaligned x: the same
    (500, 8192, 0),    # the widest
])
@pytest.mark.parametrize("dtype,pdtype", [(BF16, BF16), (BF16, F32),
                                          (FP16, FP16), (F32, F32)])
def test_cuda_plain_matches_plain_version(cuda, rows, d, offset, dtype,
                                          pdtype):
    """``rms_norm`` on the card against the plain version's fp32 autograd:
    the output, dx and dscale, one launch each way and no plain call."""
    x, scale, dout = _plain_inputs(rows, d, dtype, pdtype, device=cuda,
                                   offset=offset)
    _build.reset_launch_counts()
    pairs = _run_plain(x, scale, dout, eps=1e-5)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {"rms_norm_fwd": 1, "rms_norm_bwd": 1}
    _check(pairs, PLAIN_KINDS)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,offset", [
    (1, 512, 128, 64, 128, 0),  # Granite's mixer: d 8192, strides 8448, 16768
    (2, 300, 8, 64, 16, 0),
    (1, 200, 128, 64, 128, 1),  # a misaligned x: element by element
    (2, 100, 6, 50, 8, 0),      # heads of 50: element by element
])
@pytest.mark.parametrize("dtype,pdtype", [(BF16, BF16), (BF16, F32),
                                          (FP16, FP16), (F32, F32)])
def test_cuda_gated_matches_plain_version(cuda, b, s, h, p, n, offset, dtype,
                                          pdtype):
    """``gated_rms_norm`` on the card on the mixer's views (x and z at
    their row strides) against the plain version's fp32 autograd: the
    output and the gradients of y, x, D, z and the scale."""
    ins = _gated_inputs(b, s, h, p, n, dtype, pdtype, device=cuda,
                        offset=offset)
    _build.reset_launch_counts()
    pairs = _run_gated(*ins, h, p)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {"gated_rms_norm_fwd": 1,
                                      "gated_rms_norm_bwd": 1}
    _check(pairs, GATED_KINDS)


@pytest.mark.cuda
def test_cuda_parameter_gradients_are_the_same_bits_twice(cuda):
    """dscale and dD are summed in a fixed order, without atomics: two
    backward runs on the same inputs give the same bits, both forms."""
    x, scale, dout = _plain_inputs(16384, 4096, BF16, BF16, device=cuda)
    _, rstd = norm.rms_norm_fwd(x, scale, 1e-5)
    runs = [norm.rms_norm_bwd(dout, x, scale, rstd) for _ in range(2)]
    y, xbc, D, proj, scale, dout = _gated_inputs(1, 8192, 128, 64, 128, BF16,
                                                 BF16, device=cuda)
    x, z = (t.reshape(8192, -1) for t in _split(xbc, proj, 128, 64))
    y2, dout2 = y.reshape(8192, -1), dout.reshape(8192, -1)
    _, rstd = norm.gated_rms_norm_fwd(y2, x, D, z, scale, 1e-5)
    gated = [norm.gated_rms_norm_bwd(dout2, y2, x, D, z, scale, rstd)
             for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    for a, b in zip(*gated):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_calls_run_the_kernels_or_raise(cuda):
    """On the card nothing falls back: a width past the kernels' raises,
    and a Granite step's norms all launch the kernels."""
    from ray_tpu_torch.models import granite_hybrid as gh

    x, scale, _ = _plain_inputs(4, norm.RMS_MAX_WIDTH + 8, BF16, BF16,
                                device=cuda)
    with pytest.raises(ValueError, match="d 1 to 8192"):
        norm.rms_norm(x, scale)
    # The scan's and attention's kernels take p 32, n 16, chunk 64 and a
    # head of 64.
    conf = dict(vocab_size=128, hidden_size=64, num_hidden_layers=3,
                layer_types=["mamba", "attention", "mamba"],
                num_attention_heads=1, num_key_value_heads=1,
                mamba_n_heads=2, mamba_d_head=32, mamba_d_state=16,
                mamba_expand=1, mamba_chunk_size=64, num_local_experts=4,
                num_experts_per_tok=2, intermediate_size=16,
                shared_intermediate_size=32)
    cfg = gh.GraniteHybridConfig.from_dict(conf, experts_held=(0, 4),
                                           dtype=BF16)
    model = gh.GraniteHybrid(cfg, torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
    tokens = torch.randint(0, 128, (2, 129), device=cuda)
    _build.reset_launch_counts()
    model.loss_fn({"tokens": tokens}).backward()
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    # Two plain norms a layer, forward and in the recompute, and the final
    # one; the gated norm in each Mamba layer's forward and recompute.
    assert {k: v for k, v in counts.items() if "rms" in k} == {
        "rms_norm_fwd": 13, "rms_norm_bwd": 7, "gated_rms_norm_fwd": 4,
        "gated_rms_norm_bwd": 2}
