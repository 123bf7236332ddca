"""Tensors on the object plane (``ray_tpu_torch.core.serialization``)
through the JAX package's ``Serializer`` and runtime, which the port
does not import: its reducer goes into cloudpickle's dispatch table, which
the runtime's pickler inherits.

Every tensor must come back bit-equal, its bytes in one out-of-band
buffer (no storage in the in-band pickle), with ``torch.save``/``torch.load``
and ``copyreg.dispatch_table`` untouched; through the runtime, a 10 MB
tensor's put costs the one copy a numpy put costs and its get none (the
counters ``tests/test_hotpath.py`` pins).
"""

import copyreg
import gc
import io

import numpy as np
import pytest
import torch

import ray_tpu.core
from ray_tpu.core.serialization import Serializer
from ray_tpu.observability import hotpath
from ray_tpu_torch import device as tdevice
from ray_tpu_torch.core import serialization as S
from torch_time_limit import time_limit

LIMIT_S = 120  # each test's own limit (torch_time_limit)
BIG = 10 * 1024 * 1024


_limit = time_limit(LIMIT_S)


def _tensor(kind):
    g = torch.Generator().manual_seed(0)
    if kind == "fp32":
        return torch.randn(1 << 16, generator=g)
    if kind == "bf16":
        return torch.randn(64, 1024, generator=g).to(torch.bfloat16)
    if kind == "int64_strided":
        return torch.arange(4096).reshape(64, 64).t()  # not contiguous
    return torch.nn.Parameter(torch.randn(256, 256, generator=g))


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int64_strided",
                                  "parameter"])
def test_serializer_sends_tensors_out_of_band(kind):
    assert S.install()
    t = _tensor(kind)
    ser = Serializer()
    so = ser.serialize({"t": t, "meta": "x"})
    assert len(so.buffers) == 1
    assert so.buffers[0].raw().nbytes == t.numel() * t.element_size()
    assert len(so.inband) < 1024  # no storage in band
    back = ser.deserialize(so.to_bytes())["t"]
    assert type(back) is type(t) and back.dtype == t.dtype
    assert back.shape == t.shape and back.device.type == "cpu"
    assert back.requires_grad == t.requires_grad
    assert torch.equal(back.detach(), t.detach())
    if kind == "bf16":  # bit for bit, not only equal values
        assert torch.equal(back.view(torch.int16), t.view(torch.int16))


def test_install_leaves_copyreg_and_torch_save_alone():
    before = dict(copyreg.dispatch_table)  # torch registers torch.layout
    assert S.install() and S.install()  # idempotent
    assert copyreg.dispatch_table == before
    assert not any(isinstance(k, type) and issubclass(k, torch.Tensor)
                   for k in copyreg.dispatch_table)
    state = {"w": torch.randn(8, 8).to(torch.bfloat16), "n": torch.arange(3)}
    buf = io.BytesIO()
    torch.save(state, buf)
    buf.seek(0)
    back = torch.load(buf)  # weights-only by default
    assert all(torch.equal(back[k], state[k]) for k in state)


def test_install_refuses_copyreg_table():
    class Bad:
        dispatch_table = copyreg.dispatch_table

    with pytest.raises(ValueError, match="copyreg"):
        S.install(Bad)
    assert torch.Tensor not in copyreg.dispatch_table


def test_cuda_payload_needs_a_card():
    payload = S.TensorPayload(np.zeros(4, np.float32), "float32", "cuda")
    if torch.cuda.is_available():
        pytest.skip("this process has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.rebuild_tensor(payload)


def test_gpu_resources_counts_cards():
    assert tdevice.gpu_resources() == {
        "GPU": float(torch.cuda.device_count())}


def test_put_get_10mb_tensor_adds_no_copy(rt_shared):
    S.install()
    big = torch.arange(BIG // 4, dtype=torch.float32)
    ray_tpu.core.put(big)  # prime the path
    hotpath.reset("copy.")
    ref = ray_tpu.core.put(big)
    copies = hotpath.breakdown("copy.")
    assert copies.get("copy.serialize.write_into", 0) == 1, copies
    assert copies.get("copy.serialize.to_bytes", 0) == 0, copies
    hotpath.reset("copy.")
    got = ray_tpu.core.get(ref)
    copies = hotpath.breakdown("copy.")
    assert copies.get("copy.store.read_bytes", 0) == 0, copies
    assert got.dtype == torch.float32 and torch.equal(got, big)
    del got
    gc.collect()


class _TensorActor:
    def __init__(self):
        S.install()  # this process sends tensors

    def make(self, n: int):
        g = torch.Generator().manual_seed(n)
        return {"fp32": torch.randn(n, generator=g),
                "bf16": torch.randn(n, generator=g).to(torch.bfloat16)}

    def echo(self, t):
        return t * 2


def test_actor_returns_tensors_to_the_driver(rt_shared):
    actor = ray_tpu.core.remote(_TensorActor).remote()
    try:
        got = ray_tpu.core.get(actor.make.remote(1 << 18), timeout=60)
        g = torch.Generator().manual_seed(1 << 18)
        want = {"fp32": torch.randn(1 << 18, generator=g),
                "bf16": torch.randn(1 << 18, generator=g).to(torch.bfloat16)}
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k])
        S.install()
        x = torch.randn(1000, generator=torch.Generator().manual_seed(3))
        assert torch.equal(ray_tpu.core.get(actor.echo.remote(x)), x * 2)
    finally:
        ray_tpu.core.kill(actor)
