"""Builds the CUDA sources under ``csrc/`` and loads them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with plain C entry
points (those ``load`` is given), compiled by ``nvcc`` for ``sm_90a`` into
``ray_tpu_torch/_build/`` on first use. The file name carries a hash of
the sources and flags, so an edited kernel is rebuilt and an unchanged one
is loaded as it is. ``build()`` starts one
``nvcc`` per source, all at once. A failed build raises: nothing falls
back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
KERNELS = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq", "flash_fwd_general",
           "flash_bwd_dkdv_general", "flash_bwd_dq_general", "layer_norm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output of the build of each kernel's current library (ptxas:
# registers, shared memory and spills of every instantiation), kept beside
# the library as <library>.log.
build_logs: Dict[str, str] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises if there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin);"
        " the CUDA kernels of ray_tpu_torch cannot be built")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compiles the named kernels (default: all) that are not built yet,
    one ``nvcc`` process per source, in parallel. Returns the seconds each
    build took (0.0 for a library already built)."""
    names = list(names or KERNELS)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            seconds[name] = 0.0
            log = out.with_suffix(".log")
            build_logs[name] = log.read_text() if log.exists() else ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return seconds


def load(name: str, entries) -> ctypes.CDLL:
    """The built library of kernel ``name``, building it first if needed;
    each entry point of ``entries`` ({entry point: argtypes}) gets its
    argtypes and an int result (the launch's ``cudaError_t``)."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        for entry, argtypes in entries.items():
            fn = getattr(lib, entry)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib
