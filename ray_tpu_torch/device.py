"""The device every entry point of the port runs on.

CUDA unless the caller asks for the CPU: with no ``device`` argument the
port runs on ``cuda`` and raises when there is none. It never picks the
CPU by itself, so a run that was meant for the card cannot quietly run
somewhere else.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch


def default_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` when ``device`` is None; ``cpu`` only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on CUDA and no CUDA device is available; "
            "pass device='cpu' to run the plain CPU path")
    return dev


def gpu_resources() -> dict:
    """This process's cards as a runtime resource, for
    ``init(resources=gpu_resources())``: the counterpart of the JAX
    package's ``_local_chip_count`` (``core/runtime.py:2386``), which
    counts TPUs through JAX and which the port leaves as it is."""
    return {"GPU": float(torch.cuda.device_count())}


# Backends with an ``fp32_precision`` setting ("ieee", "tf32", "bf16" or
# "none", which defers to the parent), generic first.
_FP32_BACKENDS = ("", "mkldnn", "mkldnn.matmul", "mkldnn.conv", "mkldnn.rnn",
                  "cuda.matmul", "cudnn", "cudnn.conv", "cudnn.rnn")


def fp32_knobs() -> dict:
    """Every ``fp32_precision`` setting this PyTorch has, by backend name
    ("generic" for ``torch.backends`` itself); empty before PyTorch 2.9."""
    knobs = {}
    for name in _FP32_BACKENDS:
        obj = torch.backends
        for part in filter(None, name.split(".")):
            obj = getattr(obj, part, None)
        if obj is not None and hasattr(obj, "fp32_precision"):
            knobs[name or "generic"] = obj
    return knobs


@contextlib.contextmanager
def full_fp32() -> Iterator[None]:
    """fp32 products at full IEEE fp32 for the duration, on every backend:
    each ``fp32_precision`` setting at "ieee" (no implicit bf16 in oneDNN,
    no TF32 on the card). The plain versions of the kernels are
    references only while this holds. The previous settings come back
    afterwards."""
    knobs = fp32_knobs()
    if not knobs:
        raise RuntimeError("full_fp32 needs PyTorch >= 2.9 (fp32_precision)")
    saved = [(obj, obj.fp32_precision) for obj in knobs.values()]
    for obj in knobs.values():
        obj.fp32_precision = "ieee"
    try:
        yield
    finally:
        for obj, value in saved:
            obj.fp32_precision = value


def fp32_settings() -> str:
    """The process-wide settings that decide how precisely an fp32 product
    is computed, for a failure message."""
    b = torch.backends

    def legacy(read):
        try:
            return read()
        except RuntimeError:  # the fp32_precision settings disagree with it
            return "mixed"

    knobs = {"float32_matmul_precision":
             legacy(torch.get_float32_matmul_precision),
             "cudnn.allow_tf32": legacy(lambda: b.cudnn.allow_tf32),
             "mkldnn.enabled": b.mkldnn.enabled,
             "cpu_capability": b.cpu.get_cpu_capability(),
             "threads": torch.get_num_threads()}
    for name, obj in fp32_knobs().items():
        knobs[f"{name}.fp32_precision"] = obj.fp32_precision
    return ", ".join(f"{k}={v}" for k, v in knobs.items())
