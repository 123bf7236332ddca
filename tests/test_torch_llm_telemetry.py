"""The port's LLM telemetry (``llm.paged.llm_metrics``, the engine's
emission sites and ``llm.*`` spans, the observability copy under
``ray_tpu_torch/observability``) against the JAX package's.

Both engines serve llama-tiny (fp32) with the JAX package's
``init_params(PRNGKey(0))`` weights, carried across by ``convert.py``, and
get the same request script. The registries are process-wide (other tests
in the process may have moved them), so the test compares what the script
moved (deltas), never resets a registry, and holds every deterministic
series exactly: counters, histogram counts, and the page and session
gauges at the drain. Timings (histogram sums, the roofline gauges) are
host clock and only checked for consistency. The port's span durations
equal its ``timing`` dict within 1 us (SPAN_TOL_S). At tp 2 (two gloo ranks,
``torch_dist_worker``) only rank 0 emits, and ``decode_profile`` has the
JAX engine's keys and meanings: ``hbm_gbps`` one card's (chip's)
bandwidth, ``devices`` the tp degree, the roof their product, a roof of 0
giving ``roofline_frac`` 0.0. Then ``build_llm_app`` behind
``ray_tpu.serve`` with ``observability=ray_tpu.observability``: its
``llm.request`` span joins the HTTP request's trace under the proxy's
span, as ``tests/test_tracing_e2e.py`` checks the JAX app.
"""

import contextlib
import json
import os
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

import ray_tpu.observability.metrics as jmetrics
import ray_tpu.observability.tracing as jtracing
import torch_dist_worker as W
from ray_tpu.llm import paged as jpaged
from ray_tpu.llm.engine import SlotEngine as JaxEngine
from ray_tpu.models import llama as jl
from ray_tpu.parallel.mesh import MeshSpec
from ray_tpu_torch import device as tdevice
from ray_tpu_torch.core import config as tconfig
from ray_tpu_torch.llm import paged as tpaged
from ray_tpu_torch.llm.engine import SlotEngine
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.convert import llama_params_from_numpy
from ray_tpu_torch.observability import metrics as tmetrics
from ray_tpu_torch.observability import tracing as ttracing
from torch_time_limit import time_limit

JCFG = jl.CONFIGS["llama-tiny"]
TCFG = tl.CONFIGS["llama-tiny"]
ENGINE = dict(num_slots=3, chunk=8, page_size=8, decode_block=2)
MAX_NEW = 6
PORT = 18659     # no other test file serves on it
LIMIT_S = 240    # each test's own limit (torch_time_limit)
# Spans hold epoch seconds in float64, whose spacing near 1.8e9 s is
# 2.4e-7 s: each stage's bounds are rounded once, and the stages are laid
# end to end by additions.
SPAN_TOL_S = 1e-6
# Series whose values are host-clock rates; the rest are deterministic.
TIMED = ("rt_llm_roofline_frac", "rt_llm_decode_steps_per_s")


_limit = time_limit(LIMIT_S)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
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
    return jl.init_params(jax.random.PRNGKey(0), JCFG)[0]


@pytest.fixture(scope="module")
def numpy_params(params):
    return jax.tree.map(np.asarray, params)


def port_model(numpy_params):
    m = tl.Llama(TCFG, device="cpu")
    m.load_state_dict(llama_params_from_numpy(numpy_params, TCFG))
    return m.requires_grad_(False)


def prompts(seed, *lengths):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, JCFG.vocab_size, size=n)]
            for n in lengths]


def drive(engine, handles, max_steps=2000):
    for _ in range(max_steps):
        if all(h._done.is_set() for h in handles):
            return [h.result(timeout=0) for h in handles]
        engine.step()
    raise AssertionError("the engine did not finish")


@contextlib.contextmanager
def tracers_on():
    """Both packages' tracers enabled for the block, then disabled and
    cleared as they were."""
    tracers = (jtracing.get_tracer(), ttracing.get_tracer())
    was = [t.enabled for t in tracers]
    for t in tracers:
        t.enable()
    try:
        yield
    finally:
        for t, on in zip(tracers, was):
            t.enabled = on


def moved(before, after):
    """What a script moved: counters and histogram counts as deltas,
    gauges as their values after; series that did not move are left out;
    TIMED series by presence only."""
    out = {}
    for name, series in after.items():
        if name in TIMED:
            out[name] = sorted(series)
            continue
        gauge = name in GAUGES
        old = before.get(name, {})
        d = {k: v if gauge else v - old.get(k, 0)
             for k, v in series.items()}
        d = {k: v for k, v in d.items() if gauge or v}
        if d:
            out[name] = d
    return out


GAUGES = ("rt_llm_pages_used", "rt_llm_pages_free",
          "rt_llm_sessions_resident")


def script(engine, p):
    """Cold prompts, a prefix hit, a session exported and imported back
    after the index was cleared, and a crash-path restore; returns the
    tokens and the decode profile."""
    cold = drive(engine, [engine.submit(q, max_new=MAX_NEW) for q in p[:2]])
    hit = drive(engine, [engine.submit(p[0], max_new=MAX_NEW)])
    sess = drive(engine, [engine.submit(p[2], max_new=MAX_NEW,
                                        session_id="s")])
    snap = engine.export_session("s")
    engine.clear_prefix_cache()
    imported = engine.import_session(snap)
    restored = engine.prefill_session("r", p[3])
    return ([r.tokens for r in cold + hit + sess], imported,
            restored["matched_tokens"], hit[0].timing["matched_tokens"],
            engine.decode_profile())


def test_llm_metrics_family_matches_jax():
    got, want = tpaged.llm_metrics(), jpaged.llm_metrics()
    assert got is not None and want is not None
    assert sorted(got) == sorted(want)
    for key, m in want.items():
        t = got[key]
        assert type(t).__name__ == type(m).__name__, key
        assert (t.name, t.description, t.tag_keys) == (
            m.name, m.description, m.tag_keys), key
        assert getattr(t, "boundaries", None) == getattr(
            m, "boundaries", None), key
        # The family lives in the port's own registry.
        assert tmetrics.registry.get(t.name) is t
    assert tpaged.llm_metrics() is got  # one family a module


def test_same_script_moves_the_same_series(params, numpy_params):
    p = prompts(11, 20, 13, 17, 19)
    jax_eng = JaxEngine(params, JCFG, **ENGINE)
    port_eng = SlotEngine(port_model(numpy_params), device="cpu", **ENGINE)
    out = {}
    for name, eng, reg in (("jax", jax_eng, jmetrics.registry),
                           ("port", port_eng, tmetrics.registry)):
        before = W.llm_series(reg)
        toks, imported, restored, matched, prof = script(eng, p)
        out[name] = (moved(before, W.llm_series(reg)), toks, imported,
                     restored, matched, prof)
    (jm, jtoks, jimp, jres, jmatch, _), (tm, ttoks, timp, tres, tmatch,
                                         prof) = out["jax"], out["port"]
    assert ttoks == jtoks and timp == jimp and (tres, tmatch) == (
        jres, jmatch)
    assert tmatch >= 16  # the prefix hit borrowed two full pages
    assert tm == jm
    # The script's own counts, as the engines keep them.
    n_req = 5  # four requests and the restore's one-token prefill
    assert tm["rt_llm_ttft_seconds"] == {(): n_req}
    assert tm["rt_llm_decode_per_token_seconds"] == {(): n_req}
    assert tm["rt_llm_stage_seconds"] == {
        (("stage", s),): n_req for s in ("admission", "queue",
                                         "prefix_match", "prefill",
                                         "decode")}
    assert tm["rt_llm_tokens_generated_total"] == {
        (): port_eng.tokens_generated}
    assert tm["rt_llm_prefix_hit"] == {
        (("result", "hit"),): port_eng.prefix_hits,
        (("result", "miss"),): port_eng.prefix_misses}
    assert tm["rt_llm_prefix_tokens_saved"] == {
        (): port_eng.prefix_tokens_saved}
    assert tm["rt_llm_session_migrations"] == {
        (("result", "export"),): 1, (("result", "import"),): 1}
    assert tm["rt_llm_session_recovery_seconds"] == {(): 1}
    assert tm["rt_llm_pages_used"] == {(): port_eng.pages_used}
    assert tm["rt_llm_pages_free"] == {(): port_eng.pages_free}
    assert tm["rt_llm_sessions_resident"] == {(): 2}
    # The roofline gauges read the last measured window.
    assert prof["steps"] > 0
    frac = tmetrics.registry.get("rt_llm_roofline_frac").collect()[1][()]
    assert frac == prof["roofline_frac"]
    # An import that fails counts as an error in both packages.
    bad = dict(port_eng.export_session("s"), page_size=4)
    for eng, reg in ((jax_eng, jmetrics.registry),
                     (port_eng, tmetrics.registry)):
        before = W.llm_series(reg)
        with pytest.raises(ValueError, match="page_size"):
            eng.import_session(bad)
        assert moved(before, W.llm_series(reg))[
            "rt_llm_session_migrations"] == {(("result", "error"),): 1}


def span_tree(spans, trace_id):
    """{name: (parent name, attributes)} of one trace's spans."""
    mine = [s for s in spans if s.trace_id == trace_id]
    by_id = {s.span_id: s.name for s in mine}
    return {s.name: (by_id.get(s.parent_id, s.parent_id), s.attributes)
            for s in mine}


def test_span_trees_match_jax(params, numpy_params):
    p = prompts(12, 21)[0]
    jax_eng = JaxEngine(params, JCFG, **ENGINE)
    port_eng = SlotEngine(port_model(numpy_params), device="cpu", **ENGINE)
    trees, results = {}, {}
    with tracers_on():
        for name, eng, tracing in (("jax", jax_eng, jtracing),
                                   ("port", port_eng, ttracing)):
            runs = []
            for i in range(2):  # cold, then a prefix hit
                tid = f"{name}{i}".ljust(32, "0")
                h = eng.submit(p, max_new=MAX_NEW,
                               trace_ctx=(tid, "caller0000000000"))
                runs.append((tid, drive(eng, [h])[0]))
            spans = tracing.get_tracer().spans("llm.")
            trees[name] = [span_tree(spans, tid) for tid, _ in runs]
            results[name] = (runs, spans)
    assert trees["port"] == trees["jax"]
    cold, hit = trees["port"]
    stages = {"llm.admission", "llm.queue", "llm.prefill", "llm.decode",
              "llm.prefix_match"}
    assert set(cold) == set(hit) == stages | {"llm.request"}
    assert cold["llm.request"] == ("caller0000000000", {
        "prompt_len": 21, "produced": MAX_NEW, "matched_tokens": 0})
    assert hit["llm.request"][1]["matched_tokens"] == 16
    assert all(cold[s][0] == "llm.request" for s in stages)
    # The port's spans are its timing dict, laid end to end.
    runs, spans = results["port"]
    for tid, res in runs:
        mine = {s.name: s for s in spans if s.trace_id == tid}
        t = res.timing
        root = mine["llm.request"]
        assert abs((root.end_s - root.start_s) - t["total_s"]) < SPAN_TOL_S
        cur = root.start_s
        for stage in ("admission", "queue", "prefill", "decode"):
            s = mine[f"llm.{stage}"]
            assert abs(s.start_s - cur) < SPAN_TOL_S
            assert abs((s.end_s - s.start_s) - t[f"{stage}_s"]) < SPAN_TOL_S
            cur = s.end_s
        pm = mine["llm.prefix_match"]
        assert abs((pm.end_s - pm.start_s) - t["prefix_match_s"]) < SPAN_TOL_S
        assert abs(pm.start_s - (root.start_s + t["admission_s"]
                                 + t["queue_s"])) < SPAN_TOL_S


def test_submit_adopts_the_open_span(numpy_params):
    eng = SlotEngine(port_model(numpy_params), device="cpu", **ENGINE)
    with tracers_on():
        with ttracing.span("caller") as caller:
            h = eng.submit(prompts(13, 9)[0], max_new=2)
        drive(eng, [h])
        spans = ttracing.get_tracer().spans("llm.request")
    mine = [s for s in spans if s.trace_id == caller.trace_id]
    assert len(mine) == 1 and mine[0].parent_id == caller.span_id
    # No trace open and none given: no span.
    before = len(ttracing.get_tracer().spans("llm."))
    with tracers_on():
        drive(eng, [eng.submit(prompts(13, 9)[0], max_new=2)])
        assert len(ttracing.get_tracer().spans("llm.")) == before


@contextlib.contextmanager
def telemetry_off():
    """RT_TELEMETRY_ENABLED=0 read by both packages' configs."""
    from ray_tpu.core.config import Config as JConfig

    saved = os.environ.get("RT_TELEMETRY_ENABLED")
    os.environ["RT_TELEMETRY_ENABLED"] = "0"
    JConfig.reset()
    tconfig.Config.reset()
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("RT_TELEMETRY_ENABLED")
        else:
            os.environ["RT_TELEMETRY_ENABLED"] = saved
        JConfig.reset()
        tconfig.Config.reset()


def test_telemetry_off_emits_nothing(numpy_params):
    eng = SlotEngine(port_model(numpy_params), device="cpu", **ENGINE)
    p = prompts(14, 12)[0]
    with telemetry_off():
        assert tpaged.llm_metrics() is None
        assert jpaged.llm_metrics() is None
        before = W.llm_series(tmetrics.registry)
        spans = len(ttracing.get_tracer().spans())
        res = drive(eng, [eng.submit(p, max_new=3,
                                     trace_ctx=("off".ljust(32, "0"),
                                                "caller0000000000"))])
        eng.decode_profile()
        assert W.llm_series(tmetrics.registry) == before
        assert not ttracing.get_tracer().enabled
        assert len(ttracing.get_tracer().spans()) == spans
    assert len(res[0].tokens) == 3
    assert tpaged.llm_metrics() is not None  # back on


def test_llm_metrics_one_family_per_observability_module():
    import ray_tpu.observability as jobs

    theirs = tpaged.llm_metrics(jobs)
    assert theirs["tokens"] is jmetrics.registry.get(
        "rt_llm_tokens_generated_total")
    assert tpaged.llm_metrics(jobs) is theirs
    assert tpaged.llm_metrics()["tokens"] is not theirs["tokens"]


# -- tp 2: only rank 0 emits; decode_profile's keys and meanings -------------

TP_TRACE = ("tp2".ljust(32, "0"), "caller0000000000")
TP_ENGINE = dict(num_slots=2, chunk=8, page_size=8, decode_block=2)
TP_NEW = 12


@pytest.fixture(scope="module")
def tp_world(numpy_params, tmp_path_factory):
    prompt = prompts(15, 21)[0]
    return W.run_world(2, [("case_llm_telemetry_tp", dict(
        params=numpy_params, prompt=prompt, max_new=TP_NEW,
        engine_kw=TP_ENGINE, trace_ctx=TP_TRACE))],
        tmp_path_factory.mktemp("gloo"))


@pytest.fixture(scope="module")
def jax_tp2(params):
    from ray_tpu.core.config import config as jconfig

    eng = JaxEngine(params, JCFG, mesh=MeshSpec(tp=2).build(
        jax.devices()[:2]), **TP_ENGINE)
    res = drive(eng, [eng.submit(prompts(15, 21)[0], max_new=TP_NEW)])
    cfg = jconfig()
    roof = cfg.hbm_bandwidth_gbps
    prof = eng.decode_profile()
    cfg.apply_overrides({"hbm_bandwidth_gbps": 0.0})
    try:
        no_roof = eng.decode_profile()
    finally:
        cfg.apply_overrides({"hbm_bandwidth_gbps": roof})
    return res[0].tokens, prof, no_roof, roof


def test_tp2_only_rank0_emits(tp_world):
    rank0, rank1 = tp_world[0][0], tp_world[1][0]
    assert rank1["after"] == rank1["before"]
    assert rank1["spans"] == []
    d = moved(rank0["before"], rank0["after"])
    assert d["rt_llm_tokens_generated_total"] == {(): TP_NEW}
    assert d["rt_llm_prefix_hit"] == {(("result", "miss"),): 1}
    assert d["rt_llm_ttft_seconds"] == {(): 1}
    names = sorted(n for n, _, _ in rank0["spans"])
    assert names == sorted(["llm.request", "llm.admission", "llm.queue",
                            "llm.prefill", "llm.decode",
                            "llm.prefix_match"])
    assert all(t == TP_TRACE[0] for _, t, _ in rank0["spans"])


def test_tp2_decode_profile_keys_and_meaning_match_jax(tp_world, jax_tp2):
    jtoks, jprof, jno_roof, jroof = jax_tp2
    rank0 = tp_world[0][0]
    prof, no_roof = rank0["profile"], rank0["profile_no_roof"]
    assert rank0["tokens"] == jtoks
    assert sorted(prof) == sorted(jprof)
    # hbm_gbps is one card's (one chip's) configured bandwidth, devices
    # the tp degree, the roof their product.
    assert (prof["hbm_gbps"], jprof["hbm_gbps"]) == (3350.0, jroof)
    assert prof["devices"] == jprof["devices"] == 2
    for p in (prof, jprof):
        assert p["steps"] > 0
        # achieved_gbps is rounded to 4 decimals: half a unit of 1e-4.
        assert abs(p["roofline_frac"] * p["hbm_gbps"] * p["devices"]
                   - p["achieved_gbps"]) <= 5e-5
    assert rank0["roofline_gauge"] == prof["roofline_frac"]
    for p in (no_roof, jno_roof):
        assert p["hbm_gbps"] == 0.0 and p["roofline_frac"] == 0.0
        assert p["steps"] > 0


# -- the app behind ray_tpu.serve joins the request's trace -----------------

@contextlib.contextmanager
def traced_runtime():
    """A fresh runtime with tracing on and a fast telemetry flush, as
    tests/test_tracing_e2e.py starts one; config, environment and the
    trace store restored after."""
    import ray_tpu as rt
    from ray_tpu.core.config import Config
    from ray_tpu.observability import telemetry

    if rt.is_initialized():
        rt.shutdown()
    overrides = {"RT_TRACING_ENABLED": "1",
                 "RT_METRICS_REPORT_INTERVAL_MS": "200"}
    saved = {k: os.environ.get(k) for k in overrides}
    os.environ.update(overrides)
    Config.reset()
    telemetry.clear()
    rt.init(num_cpus=4)
    try:
        yield rt
    finally:
        rt.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        Config.reset()
        jtracing.disable()
        jtracing.get_tracer().clear()


def wait_trace(trace_id, pred, timeout=60.0):
    from ray_tpu.observability import tracestore

    deadline = time.monotonic() + timeout
    data = None
    while time.monotonic() < deadline:
        data = tracestore.get_trace(trace_id)
        if data is not None and pred(data):
            return data
        time.sleep(0.25)
    return data


def test_llm_app_spans_join_the_request_trace():
    import ray_tpu.observability as jobs
    from ray_tpu_torch.llm.serve import build_llm_app

    with traced_runtime():
        from ray_tpu import serve

        serve.start(http_port=PORT)
        try:
            app = build_llm_app(model="llama-tiny", num_slots=2, chunk=8,
                                seed=0, name="torchtrace", serve=serve,
                                device="cpu", observability=jobs)
            serve.run(app)
            rid = "torchtrace" + os.urandom(8).hex()
            body = json.dumps({"prompt": [3, 141, 59, 26, 5],
                               "max_tokens": 8}).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{PORT}/torchtrace", data=body,
                headers={"Content-Type": "application/json",
                         "x-request-id": rid})
            with urllib.request.urlopen(req, timeout=120) as r:
                out = json.loads(r.read())
                assert r.headers.get("x-request-id") == rid
            timing = out["timing"]
            assert len(out["tokens"]) == 8 and timing["total_s"] > 0
            data = wait_trace(rid, lambda d: {
                "llm.request", "llm.decode"} <= {s["name"]
                                                 for s in d["spans"]})
            assert data is not None
            spans = {s["name"]: s for s in data["spans"]}
            assert "llm.request" in spans, sorted(spans)
            # The engine's spans came from the replica's process, the
            # proxy's from the head.
            assert len(data["procs"]) >= 2, data["procs"]
            root_id = spans["llm.request"]["span_id"]
            for stage in ("admission", "queue", "prefill", "decode"):
                s = spans[f"llm.{stage}"]
                assert s["parent_id"] == root_id
                # The store keeps durations to 1e-3 ms.
                assert s["dur_ms"] == pytest.approx(
                    timing[f"{stage}_s"] * 1e3, abs=1e-3)
            assert (spans["llm.request"]["parent_id"]
                    == spans["proxy.request"]["span_id"])
        finally:
            serve.shutdown()
