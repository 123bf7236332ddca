"""K4 (csrc/flash_fwd_general.cu) built for the CPU and held against the
plain attention.

g++ compiles the kernel's source, as it is, against the stub CUDA headers
in ``tests/torch_cuda_stub`` (one std::thread a CUDA thread; barriers for
``__syncthreads``, ``__syncwarp`` and the warp shuffles; the cp.async
helpers copy at once), after two textual rewrites the stub's header
describes. The library's C entry point then runs on CPU tensors: the
kernel's tiling, masks, online softmax, rounding of P and copy paths, at
tiny shapes, with no card. Without g++ the tests skip.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from ray_tpu_torch import device as tdevice
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as tattn

STUB = Path(__file__).resolve().parent / "torch_cuda_stub"
_LAUNCH = re.compile(r"(\w+)<<<(.*?)>>>\((.*?)\);")
_SMEM = re.compile(r"extern __shared__ (\w+) (\w+)\[\];")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@pytest.fixture(autouse=True)
def _full_fp32():
    with tdevice.full_fp32():
        yield


def host_source(text: str) -> str:
    """A kernel source with its launches and dynamic shared memory
    rewritten for the stub (see torch_cuda_stub/cuda_runtime.h)."""
    text = _LAUNCH.sub(r"::rtt_stub::launch(\1, \2, \3);", text)
    return _SMEM.sub(
        r"\1* \2 = reinterpret_cast<\1*>(::rtt_stub::dynamic_smem());", text)


def build_host_library(name: str, out_dir: Path) -> ctypes.CDLL:
    """csrc/<name>.cu and the csrc headers, rewritten, built by g++ into
    a shared library in ``out_dir``."""
    for src in list(_build.CSRC.glob("*.cuh")) + [_build.CSRC / f"{name}.cu"]:
        (out_dir / src.name).write_text(host_source(src.read_text()))
    lib = out_dir / f"lib{name}.so"
    cmd = ["g++", "-std=c++20", "-O1", "-fno-strict-aliasing", "-pthread",
           "-shared", "-fPIC", "-I", str(STUB), "-x", "c++",
           str(out_dir / f"{name}.cu"), "-o", str(lib)]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def k4(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    fn = build_host_library("flash_fwd_general",
                            tmp_path_factory.mktemp("k4")).flash_fwd_general
    fn.argtypes = [_P] * 5 + [_I] * 6 + [_F, _I, _P]
    fn.restype = ctypes.c_int
    return fn


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


F32, BF16, FP16 = torch.float32, torch.bfloat16, torch.float16


@pytest.mark.parametrize("sq,sk,d,causal,dtype,offset", [
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
])
def test_k4_host_build_matches_plain(k4, sq, sk, d, causal, dtype, offset):
    """fp32 within 1e-5 of the largest entry (sums in another order),
    16-bit within 2e-2, lse within 1e-4: the card's tolerances."""
    g = torch.Generator().manual_seed(sq * 1000 + sk + d)
    mk = lambda s: _offset(torch.randn((1, 2, s, d), generator=g)
                           .to(dtype), offset)
    q, k, v = mk(sq), mk(sk), mk(sk)
    scale = d ** -0.5
    o, lse = run_k4(k4, q, k, v, causal, scale)
    ro, rlse = tattn.mha_reference_with_lse(q, k, v, causal, scale)
    tol = 1e-5 if dtype == F32 else 2e-2
    err = (o.float() - ro.float()).abs().max() / ro.float().abs().max()
    assert err < tol
    assert (lse - rlse).abs().max() < 1e-4


def test_host_source_rewrites_launches_and_shared_memory():
    text = host_source("  kernel<<<grid, kThreads, smem, stream>>>(args...);\n"
                       "  extern __shared__ uint4 smem_raw[];\n")
    assert "<<<" not in text and "__shared__" not in text
    assert "::rtt_stub::launch(kernel, grid, kThreads, smem, stream, " \
           "args...);" in text
    assert "uint4* smem_raw = reinterpret_cast<uint4*>(" in text
