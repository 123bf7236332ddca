"""The scan's CUDA kernels (``ray_tpu_torch/ops/csrc/ssd_*.cu``) built by
g++ for the CPU against the stub CUDA headers (``tests/torch_stub_build.py``;
each CUDA thread a std::thread, each warp-level matrix product computed from
the warp's fragments through shuffles) and driven through the port's own
wrappers (``ops.ssd.ssd_kernel_forward``, ``ssd_kernel_backward``), held to
the plain scan's fp32 autograd.

The shape is the small instantiation (p 32, n 16, chunk 64) with more than
one chunk, a ragged last one, and x, B, C split from one bf16 row a
position as the Granite mixer leaves them. Tolerance: 1e-2 of each output's
largest entry, as on the card: the kernels' products take bf16 operands (dy,
the states and the decays times C B^T rounded once, at the product), which
read 2-6e-3 here.
"""

import pytest
import torch

from ray_tpu_torch.ops import _build, ssd
from torch_stub_build import host_library

TOL = 1e-2


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    return {name: host_library(tmp_path_factory, name,
                               {entry: ssd._ARGTYPES})
            for name, entry in ssd._LIBS.items()}


@pytest.fixture
def host_kernels(libs, monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name, entries: libs[name])
    monkeypatch.setattr(_build, "has_library", lambda name: True)


def _inputs(b, s, h, p, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    xbc = torch.randn(b, s, h * p + 2 * n, generator=g).to(torch.bfloat16)
    x = xbc[..., :h * p].unflatten(-1, (h, p))
    B, C = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=g))
    A = -torch.exp(torch.randn(h, generator=g))
    return x, dt, A, B, C


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


@pytest.mark.parametrize("s", [100, 128])  # a ragged last chunk; whole ones
def test_host_build_of_the_kernels_matches_plain(host_kernels, s):
    x, dt, A, B, C = _inputs(1, s, 2, 32, 16)
    ssd.check_kernel_layout(x, dt, A, B, C, 64)
    ssd.reset_counts()
    y = ssd.ssd_kernel_forward(x, dt, A, B, C, 64)[0]
    refs = [t.float().requires_grad_() for t in (x, dt, A, B, C)]
    want = ssd.ssd_reference(*refs, chunk=64)
    assert _rel(y, want) <= TOL
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(3))
    grads = ssd.ssd_kernel_backward(dy, x, dt, A, B, C, 64)
    for name, got, ref, t in zip(("x", "dt", "A", "B", "C"), grads,
                                 torch.autograd.grad(want, refs, dy),
                                 (x, dt, A, B, C)):
        assert got.shape == t.shape and got.dtype == t.dtype, name
        assert _rel(got, ref) <= TOL, (name, _rel(got, ref))
    # The backward makes the entering states again: chunk_state and
    # state_pass twice in it.
    assert ssd.counts() == {"chunk_state": 3, "state_pass": 3,
                            "chunk_scan": 2, "chunk_dg": 1, "chunk_bc": 2}
