"""The port's ``LLMServer(checkpoint_path=)`` and ``build_llm_app`` against
the JAX package's, on llama-tiny (fp32) saved by the port's
``save_arrays`` from the JAX package's initial parameters: the port's
server gives the JAX server's tokens on the same ``arrays.pkl``, and the
app behind ``ray_tpu.serve`` (injected as ``serve=``; the port imports no
Serve runtime) answers over HTTP with the JAX reference's tokens, plain
and streamed. Greedy decoding, so the tokens must be equal.
"""

import asyncio
import json
import urllib.request

import jax
import numpy as np
import pytest

from ray_tpu.models import llama as jl
from ray_tpu_torch import device as tdevice
from ray_tpu_torch.llm.serve import LLMServer, build_llm_app
from ray_tpu_torch.train import save_arrays
from torch_time_limit import time_limit

LIMIT_S = 240  # each test's own limit (torch_time_limit)
PORT = 18593   # no other test file serves on it
PROMPTS = ([3, 141, 59, 26, 5], [7, 7, 300, 12, 9, 44, 2, 100, 18])


_limit = time_limit(LIMIT_S)


@pytest.fixture(autouse=True)
def _full_fp32():
    with tdevice.full_fp32():
        yield


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """llama-tiny's JAX initial parameters, saved by the port."""
    cfg = jl.CONFIGS["llama-tiny"]
    params, _ = jl.init_params(jax.random.PRNGKey(0), cfg)
    path = str(tmp_path_factory.mktemp("llama") / "arrays")
    save_arrays(path, jax.tree.map(np.asarray, params))
    return path


def _reference(prompt, max_new):
    cfg = jl.CONFIGS["llama-tiny"]
    params, _ = jl.init_params(jax.random.PRNGKey(0), cfg)
    out = jl.generate(params, np.asarray([prompt], dtype=np.int32), cfg,
                      max_new=max_new)
    return [int(t) for t in np.asarray(out)[0, len(prompt):]]


def test_llm_server_checkpoint_path_matches_jax(ckpt):
    from ray_tpu.llm.serve import LLMServer as JaxLLMServer

    async def ask(server):
        return [(await server({"prompt": p, "max_tokens": 8}))["tokens"]
                for p in PROMPTS]

    jax_server = JaxLLMServer(model="llama-tiny", num_slots=2, chunk=8,
                              checkpoint_path=ckpt)
    try:
        want = asyncio.run(ask(jax_server))
    finally:
        jax_server.engine.stop()
    server = LLMServer(model="llama-tiny", num_slots=2, chunk=8,
                       checkpoint_path=ckpt, device="cpu")
    try:
        got = asyncio.run(ask(server))
    finally:
        server.engine.stop()
    assert got == want
    assert all(len(t) == 8 for t in got)


def test_build_llm_app_over_http_matches_jax(rt_shared, ckpt):
    from ray_tpu import serve

    serve.start(http_port=PORT)
    try:
        app = build_llm_app(model="llama-tiny", num_slots=4, chunk=8,
                            checkpoint_path=ckpt, name="torch-llm",
                            serve=serve, device="cpu")
        serve.run(app)
        url = f"http://127.0.0.1:{PORT}/torch-llm"
        for prompt in PROMPTS:
            ref = _reference(prompt, 10)
            body = json.dumps({"prompt": prompt, "max_tokens": 10}).encode()
            req = urllib.request.Request(url, data=body, headers={
                "Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                out = json.loads(r.read())
            assert out["tokens"] == ref
            assert out["finish_reason"] == "length"
            assert out["prompt_len"] == len(prompt)
        body = json.dumps({"prompt": PROMPTS[0], "max_tokens": 10,
                           "stream": True}).encode()
        req = urllib.request.Request(url, data=body, headers={
            "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            lines = [ln for ln in r.read().decode().splitlines() if ln]
        assert [json.loads(ln) for ln in lines] == _reference(PROMPTS[0], 10)
    finally:
        serve.shutdown()


def test_build_llm_app_needs_serve_and_mirrors_admission():
    with pytest.raises(TypeError):
        build_llm_app(model="llama-tiny")  # serve= is required

    class FakeServe:
        def deployment(self, target, name, **opts):
            self.seen = (target, name, opts)
            return self

        def bind(self, **kw):
            return kw

    fake = FakeServe()
    bound = build_llm_app(name="x", max_pending=3, queue_timeout_s=2.0,
                          serve=fake, device="cpu")
    assert fake.seen[0] is LLMServer and fake.seen[1] == "x"
    assert fake.seen[2] == {"max_pending": 3, "queue_timeout_s": 2.0}
    assert bound["device"] == "cpu" and bound["max_pending"] == 3
