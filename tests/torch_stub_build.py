"""Builds a kernel source of ``ray_tpu_torch/ops/csrc`` for the CPU.

g++ compiles the source, as it is, against the stub CUDA headers in
``tests/torch_cuda_stub`` (one std::thread a CUDA thread; barriers for
``__syncthreads``, ``__syncwarp`` and the warp shuffles; shared memory
starts as NaNs), after two textual rewrites the stub's header describes.
The library's C entry points then run the kernels' arithmetic on CPU
tensors, with no card.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

from ray_tpu_torch.ops import _build

STUB = Path(__file__).resolve().parent / "torch_cuda_stub"
_LAUNCH = re.compile(r"(\w+)<<<(.*?)>>>\((.*?)\);")
_SMEM = re.compile(r"extern __shared__ (\w+) (\w+)\[\];")


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


def host_library(tmp_path_factory, name: str, entries) -> ctypes.CDLL:
    """The host build of csrc/<name>.cu with ``entries`` ({entry point:
    argtypes}) bound, each returning an int; skips without g++."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    lib = build_host_library(name, tmp_path_factory.mktemp(name))
    for entry, argtypes in entries.items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
