"""Builds the CUDA sources under ``csrc/``, loads them with ctypes and
launches their entry points: the one seam between the ops and their
kernels.

Each ``csrc/<name>.cu`` becomes one shared library with plain C entry
points, compiled by ``nvcc`` for ``sm_90a`` into ``ray_tpu_torch/_build/``
on first use. The file name carries a hash of the sources and flags, so an
edited kernel is rebuilt and an unchanged one is loaded as it is.
``build()`` starts one ``nvcc`` per source, all at once. A failed build
raises: nothing falls back to the plain versions.

An op declares its kernels once, in a table ``{library: {entry point:
argtypes}}`` (the stream last), and calls them through ``launch``. The
first launch of any entry of a table builds every library of it not built
yet, at once, and binds their argtypes; later launches find the bound
entry in a dict. ``launch`` counts each launch under the wrapper's name
(``launch_counts``, ``reset_launch_counts``). Which version an op runs is
``on_card``'s rule, the same for every op.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Mapping, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
KERNELS = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq", "flash_fwd_general",
           "flash_bwd_dkdv_general", "flash_bwd_dq_general", "layer_norm",
           "ssd_state", "ssd_scan", "ssd_grad")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
# Entry point (a C symbol, unique across the libraries) -> its function in
# a loaded library, argtypes bound, and the positions of its pointer
# arguments before the stream, where ``launch`` takes a tensor or None.
_entries: Dict[str, Any] = {}
_launches: Dict[str, int] = {}
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


def on_card(t: torch.Tensor) -> bool:
    """The rule every op follows: a CUDA tensor goes to the kernels (which
    run or raise), any other tensor to the plain version."""
    return t.device.type == "cuda"


def _bind(table: Mapping[str, Mapping[str, Sequence]]) -> None:
    """Builds the libraries of ``table`` not loaded yet, all at once, loads
    them, and binds each entry point's argtypes and int result."""
    todo = [lib for lib in table if lib not in _libs]
    if todo:
        build(todo)
    for lib in todo:
        so = _libs[lib] = ctypes.CDLL(str(_library_path(lib)))
        for entry, argtypes in table[lib].items():
            fn = getattr(so, entry)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    for lib, entries in table.items():
        for entry, argtypes in entries.items():
            _entries[entry] = (getattr(_libs[lib], entry), [
                i for i, t in enumerate(argtypes[:-1]) if t is ctypes.c_void_p])


def launch(table: Mapping[str, Mapping[str, Sequence]], entry: str,
           device: torch.device, *args, name: Optional[str] = None) -> None:
    """Calls C entry point ``entry`` of ``table`` with ``args`` (a tensor
    or None where the entry takes a pointer, passed as the tensor's
    pointer or NULL) and the stream: ``device``'s current one on a card,
    NULL off it (a host build of the sources, as the tests make). Raises
    ``RuntimeError`` naming ``entry`` and the ``cudaError_t`` it returned,
    if not 0; else counts one launch of ``name`` (default ``entry``)."""
    bound = _entries.get(entry)
    if bound is None:
        _bind(table)
        bound = _entries[entry]
    fn, pointers = bound
    args = list(args)
    for i in pointers:
        if args[i] is not None:
            args[i] = args[i].data_ptr()
    if device.type == "cuda":
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        err = fn(*args, None)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    key = name or entry
    _launches[key] = _launches.get(key, 0) + 1


def launch_counts() -> collections.Counter:
    """Launches of each kernel wrapper, by name, since
    ``reset_launch_counts``; a wrapper not launched reads 0."""
    return collections.Counter(_launches)


def reset_launch_counts() -> None:
    _launches.clear()
