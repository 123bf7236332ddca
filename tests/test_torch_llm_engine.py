"""The port's serving engine (ray_tpu_torch.llm.engine.SlotEngine) and
request plane (llm.serve.LLMServer) against the JAX package's.

Both engines serve llama-tiny (fp32) with the JAX package's
``init_params(PRNGKey(0))`` weights, carried across by ``convert.py``,
and get the same requests in the same order; the port runs on the CPU,
eagerly (on the card every block is a CUDA graph; tests/test_torch_cuda.py
holds the two against each other). Tokens must be equal: greedy and
seeded, through chunked prefill, staggered joins, decode blocks with EOS
overshoot, slot recycling, prefix hits with copy-on-write, and a session
exported by the JAX engine and continued by the port's. The JAX engines
are module-scoped: each compiles its block programs once.
"""

import asyncio
import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu.llm.engine import SlotEngine as JaxEngine
from ray_tpu.models import llama as jl
from ray_tpu_torch import device as tdevice
from ray_tpu_torch.core.exceptions import (EngineStoppedError,
                                           OverloadedError, RuntimeError_)
from ray_tpu_torch.llm.engine import SlotEngine
from ray_tpu_torch.llm.serve import LLMServer
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.convert import llama_params_from_numpy

JCFG = jl.CONFIGS["llama-tiny"]
TCFG = tl.CONFIGS["llama-tiny"]
PS = 8
BASE = dict(num_slots=3, chunk=4, page_size=PS)
BLOCK = dict(num_slots=2, chunk=8, page_size=PS, decode_block=4)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: at llama-tiny size more buy little time and
    crowd the test processes running beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _full_fp32():
    with tdevice.full_fp32():
        yield


@pytest.fixture(scope="module")
def params():
    p, _ = jl.init_params(jax.random.PRNGKey(0), JCFG)
    return p


@pytest.fixture(scope="module")
def numpy_params(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def model(numpy_params):
    m = tl.Llama(TCFG, device="cpu")
    m.load_state_dict(llama_params_from_numpy(numpy_params, TCFG))
    return m.requires_grad_(False)


@pytest.fixture(scope="module")
def pair(params, model):
    """(JAX engine, port engine) with the BASE knobs: chunk 4 cuts prompts
    into several prefill chunks; both keep a prefix cache."""
    return (JaxEngine(params, JCFG, **BASE),
            SlotEngine(model, device="cpu", **BASE))


@pytest.fixture(scope="module")
def block_pair(params, model):
    """Decode blocks of 4, two slots."""
    return (JaxEngine(params, JCFG, **BLOCK),
            SlotEngine(model, device="cpu", **BLOCK))


def drain(engine, handles, max_steps=800):
    for _ in range(max_steps):
        if all(h._done.is_set() for h in handles):
            return
        engine.step()
    raise AssertionError("engine did not finish in max_steps")


def run_both(engines, requests, steps_between=0):
    """Submit ``requests`` (dicts of submit kwargs) to each engine, with
    ``steps_between`` steps after each submit; return each engine's
    results."""
    out = []
    for engine in engines:
        handles = []
        for req in requests:
            handles.append(engine.submit(**req))
            for _ in range(steps_between):
                engine.step()
        drain(engine, handles)
        out.append([h.result(timeout=0) for h in handles])
    return out


def prompts(seed, *lengths):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, JCFG.vocab_size, size=n)]
            for n in lengths]


def tokens(results):
    return [r.tokens for r in results]


def test_single_request_matches_jax(pair):
    jax_res, port_res = run_both(pair, [dict(prompt=[3, 141, 59, 26, 5],
                                             max_new=12)])
    assert tokens(port_res) == tokens(jax_res)
    res = port_res[0]
    assert (res.finish_reason, res.prompt_len) == ("length", 5)
    assert set(res.timing) == set(jax_res[0].timing)


def test_chunked_prefill_matches_jax(pair):
    """23 tokens in chunks of 4: six chunks with a ragged tail."""
    jax_res, port_res = run_both(
        pair, [dict(prompt=prompts(7, 23)[0], max_new=8)])
    assert tokens(port_res) == tokens(jax_res)


def test_staggered_joins_match_jax(pair):
    """Requests joining mid-flight, greedy and seeded; four requests on
    three slots also queue."""
    reqs = [dict(prompt=p, max_new=m, temperature=t, seed=s)
            for p, m, t, s in zip(prompts(11, 5, 17, 3, 9), (10, 6, 14, 8),
                                  (0.0, 0.8, 0.0, 1.5), (None, 4242, None,
                                                         -7))]
    jax_res, port_res = run_both(pair, reqs, steps_between=3)
    assert tokens(port_res) == tokens(jax_res)


def test_decode_block_matches_jax(block_pair):
    reqs = [dict(prompt=p, max_new=10) for p in prompts(19, 6, 13, 4)]
    jax_res, port_res = run_both(block_pair, reqs, steps_between=1)
    assert tokens(port_res) == tokens(jax_res)


def test_decode_block_eos_overshoot_discarded(block_pair):
    prompt = [3, 141, 59, 26, 5]
    ref = run_both(block_pair[1:], [dict(prompt=prompt, max_new=12)])[0][0]
    eos = ref.tokens[4]
    jax_res, port_res = run_both(
        block_pair, [dict(prompt=prompt, max_new=12, eos_id=eos)])
    assert tokens(port_res) == tokens(jax_res)
    res = port_res[0]
    assert res.finish_reason == "stop"
    assert res.tokens == ref.tokens[:ref.tokens.index(eos) + 1]


def test_slots_recycle_many_requests(block_pair):
    reqs = [dict(prompt=p, max_new=5) for p in prompts(3, *[4] * 7)]
    counts = [(e.requests_completed, e.tokens_generated) for e in block_pair]
    jax_res, port_res = run_both(block_pair, reqs)
    assert tokens(port_res) == tokens(jax_res)
    for engine, (done0, toks0) in zip(block_pair, counts):
        assert engine.requests_completed - done0 == 7
        assert engine.tokens_generated - toks0 == 35


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_prefix_hit_matches_cold_and_jax(pair, temperature):
    """A prompt served twice: the second admission hits the radix index
    (16 of 21 tokens: the two full pages) and, greedy or seeded, gives
    the cold run's tokens, in both packages."""
    prompt = prompts(31 + int(temperature * 10), 21)[0]
    req = dict(prompt=prompt, max_new=10, temperature=temperature,
               seed=1234)
    saved0 = [e.prefix_tokens_saved for e in pair]
    hits0 = [e.prefix_hits for e in pair]
    cold = run_both(pair, [req])
    warm = run_both(pair, [req])
    assert tokens(cold[1]) == tokens(cold[0]) == tokens(warm[1]) \
        == tokens(warm[0])
    for engine, s0, h0 in zip(pair, saved0, hits0):
        assert engine.prefix_hits == h0 + 1
        assert engine.prefix_tokens_saved - s0 == 16
    assert warm[1][0].timing["matched_tokens"] == 16


def test_cow_fork_matches_jax(pair):
    """Two prompts fork from a shared prefix mid-page, concurrently: the
    borrowed page is copied on write, both match the JAX engine, and the
    original prompt replays clean afterwards."""
    shared = prompts(43, 12)[0]
    a = shared + prompts(44, 6)[0]
    b = shared + prompts(45, 7)[0]
    first = run_both(pair, [dict(prompt=a, max_new=8)])
    saved0 = [e.prefix_tokens_saved for e in pair]
    fork = run_both(pair, [dict(prompt=a, max_new=8),
                           dict(prompt=b, max_new=8)])
    again = run_both(pair, [dict(prompt=a, max_new=8)])
    assert tokens(fork[1]) == tokens(fork[0])
    assert tokens(again[1]) == tokens(first[1]) == tokens(first[0])
    saved = [e.prefix_tokens_saved - s for e, s in zip(pair, saved0)]
    assert saved[1] == saved[0] > 0


def test_page_accounting_drains_clean(model):
    eng = SlotEngine(model, num_slots=2, chunk=8, page_size=PS,
                     device="cpu")
    assert eng.pages_total == 2 * (TCFG.max_seq // PS) + 1
    reqs = [dict(prompt=p, max_new=4) for p in prompts(47, 5, 11, 9, 17, 6)]
    res = run_both([eng], reqs)[0]
    assert all(len(r.tokens) == 4 for r in res)
    assert eng.pages_used + eng.pages_free == eng.pages_total
    assert not eng._tables.any(), "drained slots must unmap pages"
    held = eng.pages_used - 1
    assert held == eng.prefix_cache_len()
    assert eng.clear_prefix_cache() == held
    assert eng.pages_used == 1
    assert eng._pool.refcount(0) == 0


def test_decode_profile_counts_attended_pages(model):
    """decode_profile's bytes per step are the weights plus the pages the
    live slots attend, not the radix-held pages of finished requests."""
    eng = SlotEngine(model, num_slots=2, chunk=8, page_size=PS,
                     decode_block=4, device="cpu")
    old = [dict(prompt=p, max_new=4) for p in prompts(59, 40, 40, 40)]
    run_both([eng], old)
    assert eng.prefix_cache_len() >= 15
    eng.reset_decode_profile()
    res = run_both([eng], [dict(prompt=prompts(61, 8)[0], max_new=16)])[0]
    assert len(res[0].tokens) == 16
    prof = eng.decode_profile()
    assert prof["steps"] > 0
    kv_pages = (prof["bytes_per_step"] - eng._param_bytes) \
        / eng._kv_page_bytes
    assert 1 <= kv_pages <= -(-(8 + 16) // PS)


def test_lru_eviction_under_pool_pressure(params, model):
    """Zero headroom: admissions evict earlier radix entries, tokens stay
    equal to the JAX engine's, no page leaks."""
    engines = (JaxEngine(params, JCFG, num_slots=2, chunk=8, page_size=PS),
               SlotEngine(model, num_slots=2, chunk=8, page_size=PS,
                          device="cpu"))
    for i, p in enumerate(prompts(53, *[100] * 3)):
        jax_res, port_res = run_both(engines, [dict(prompt=p, max_new=4)])
        assert tokens(port_res) == tokens(jax_res), f"round {i}"
        eng = engines[1]
        assert eng.pages_used + eng.pages_free == eng.pages_total


def test_bounded_pending_sheds_with_typed_error(model):
    eng = SlotEngine(model, num_slots=1, chunk=8, page_size=PS,
                     max_pending=2, device="cpu")
    eng.warmup()
    prompt = [3, 141, 59, 26, 5]
    keep = [eng.submit(prompt, max_new=4) for _ in range(2)]
    eng.step()  # admits the first; the queue holds one
    keep.append(eng.submit(prompt, max_new=4))
    with pytest.raises(OverloadedError):
        eng.submit(prompt, max_new=4)
    assert eng.requests_shed == 1
    drain(eng, keep)
    assert all(len(h.result(timeout=0).tokens) == 4 for h in keep)


def test_queue_timeout_expires_pending_only(model):
    eng = SlotEngine(model, num_slots=1, chunk=8, page_size=PS,
                     queue_timeout_s=0.2, device="cpu")
    eng.warmup()
    prompt = [9, 2, 77, 31]
    resident = eng.submit(prompt, max_new=4)
    eng.step()
    late = eng.submit(prompt, max_new=4)
    time.sleep(0.3)
    drain(eng, [resident, late])
    assert len(resident.result(timeout=0).tokens) == 4
    with pytest.raises(OverloadedError):
        late.result(timeout=0)
    assert issubclass(OverloadedError, RuntimeError_)


def test_submit_validation(model):
    eng = SlotEngine(model, num_slots=2, chunk=8, device="cpu")
    with pytest.raises(ValueError):
        eng.submit([], max_new=4)
    with pytest.raises(ValueError):
        eng.submit(list(range(1, 100)), max_new=TCFG.max_seq)
    with pytest.raises(ValueError):
        SlotEngine(model, chunk=7, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        SlotEngine(model, mesh=object(), device="cpu")


def test_entry_points_need_cuda_unless_cpu_asked(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlotEngine(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMServer()


def test_threaded_engine_streams_and_stops(model, pair):
    engine = SlotEngine(model, num_slots=2, chunk=8, device="cpu").start()
    try:
        prompt = [9, 2, 77, 31]
        streamed = list(engine.submit(prompt, max_new=9))
        ref = run_both(pair[:1], [dict(prompt=prompt, max_new=9)])[0][0]
        assert streamed == ref.tokens
        h = engine.submit(list(range(2, 10)), max_new=100)
    finally:
        engine.stop()
    with pytest.raises(EngineStoppedError):
        h.result(timeout=10)


# -- sessions -----------------------------------------------------------------

SESSION = dict(num_slots=2, chunk=8, page_size=PS, num_pages=64)


@pytest.fixture(scope="module")
def jax_session_engine(params):
    return JaxEngine(params, JCFG, **SESSION)


@pytest.mark.parametrize("temperature,seed", [(0.0, None), (1.0, 42)])
def test_session_from_jax_engine_continues_in_port(jax_session_engine, model,
                                                   temperature, seed):
    """A session exported by the JAX engine (numpy KV frames) imports into
    the port's engine; the next turn hits the imported pages and gives
    the tokens the JAX engine gives on its own."""
    A = jax_session_engine
    sid = f"s-{temperature}"
    prompt = list(range(2, 34))  # 32 tokens = 4 full pages
    h = A.submit(prompt, max_new=4, temperature=temperature, seed=seed,
                 session_id=sid)
    drain(A, [h])
    turn2 = prompt + h.result(timeout=0).tokens + [7, 8, 9]
    snap = A.export_session(sid)
    assert snap["covered_tokens"] > 0
    B = SlotEngine(model, device="cpu", **SESSION)
    info = B.import_session(snap)
    assert info["pages_imported"] == snap["covered_tokens"] // PS
    assert sid in B.sessions()
    req = dict(prompt=turn2, max_new=6, temperature=temperature, seed=seed,
               session_id=sid)
    jax_res, port_res = run_both((A, B), [req])
    assert tokens(port_res) == tokens(jax_res)
    assert B.prefix_hits == 1
    assert port_res[0].timing["matched_tokens"] >= snap["covered_tokens"]
    # And back out of the port: its export imports into a fresh port
    # engine, which continues the same way.
    C = SlotEngine(model, device="cpu", **SESSION)
    C.import_session(B.export_session(sid))
    again = run_both([C], [dict(req, prompt=turn2 + port_res[0].tokens)])
    ref = run_both([B], [dict(req, prompt=turn2 + port_res[0].tokens)])
    assert tokens(again[0]) == tokens(ref[0])


def test_session_export_refuses_in_flight_and_unknown(model):
    eng = SlotEngine(model, device="cpu", **SESSION)
    with pytest.raises(KeyError):
        eng.export_session("nope")
    prompt = list(range(2, 12))
    drain(eng, [eng.submit(prompt, max_new=4, session_id="s3")])
    h = eng.submit(prompt + [3, 4], max_new=8, session_id="s3")
    with pytest.raises(RuntimeError):
        eng.export_session("s3")
    drain(eng, [h])
    eng.export_session("s3")


def test_prefill_session_recovery(model, pair):
    eng = SlotEngine(model, device="cpu", **SESSION)
    transcript = list(range(2, 42))
    info = eng.prefill_session("lost", transcript)
    assert info["seconds"] > 0 and "lost" in eng.sessions()
    turn = transcript + [9, 9]
    res = run_both([eng], [dict(prompt=turn, max_new=4,
                                session_id="lost")])[0]
    assert eng.prefix_hits == 1
    assert tokens(res) == tokens(run_both(pair[:1], [dict(prompt=turn,
                                                          max_new=4)])[0])


# -- LLMServer ------------------------------------------------------------------

@pytest.fixture(scope="module")
def server(numpy_params):
    s = LLMServer(model="llama-tiny", num_slots=2, chunk=8,
                  params=numpy_params, device="cpu")
    yield s
    s.engine.stop()


def test_llm_server_plain_and_stream_match_jax(server, pair):
    prompt = prompts(71, 9)[0]
    ref = run_both(pair[:1], [dict(prompt=prompt, max_new=7)])[0][0].tokens

    async def both():
        plain = await server({"prompt": prompt, "max_tokens": 7})
        stream = [t async for t in await server(
            {"prompt": prompt, "max_tokens": 7, "stream": True})]
        seeded = await server({"prompt": prompt, "max_tokens": 7,
                               "temperature": 0.8, "seed": 5,
                               "session": "chat"})
        return plain, stream, seeded

    plain, stream, seeded = asyncio.run(both())
    assert plain["tokens"] == stream == ref
    assert plain["finish_reason"] == "length" and plain["prompt_len"] == 9
    assert set(plain["timing"]) >= {"prefill_s", "decode_s", "total_s"}
    want = run_both(pair[:1], [dict(prompt=prompt, max_new=7,
                                     temperature=0.8, seed=5)])[0][0]
    assert seeded["tokens"] == want.tokens
    assert server.sessions() == ["chat"]
    assert [s["session_id"] for s in server.export_sessions()] == ["chat"]
    stats = server.stats()
    assert stats["requests_completed"] >= 3
    assert asyncio.run(server({"nope": 1}))["error"]


def test_llm_server_unported_options_raise():
    # checkpoint_path is ported (tests/test_torch_llm_app.py); a directory
    # without arrays raises before any model is built.
    with pytest.raises(FileNotFoundError, match="no checkpoint arrays"):
        LLMServer(checkpoint_path="/nonexistent", device="cpu")
