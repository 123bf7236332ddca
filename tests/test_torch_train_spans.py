"""The device spans of the port's training step and attention op
(``observability.tracing.device_span``, ``train/step.py``,
``ops/attention.py``).

A step of ``build_train`` (and of ``build_sharded_train`` on a one-rank
gloo mesh) is one trace: ``train.step`` over ``train.forward``,
``train.backward`` and ``train.optimizer``, with one ``attn.forward`` under
the forward and one ``attn.backward`` under the backward per layer. The
spans record while a torch profiler records, with the tracer disabled,
and then also land in the profiler's trace as host ranges; with neither,
the device span is the shared no-op and nothing is made. ``span`` and
``record_span`` keep recording only while the tracer is enabled. The
file imports neither JAX nor ``ray_tpu``, so on a card it runs with
``--noconftest``; its ``cuda`` tests read ``device_ms`` there.
"""

import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_dist_worker as W
from ray_tpu_torch import device as tdevice
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.observability import tracing
from ray_tpu_torch.train import optim
from ray_tpu_torch.train.step import build_train

LAYERS = 2
TINY = dict(vocab_size=128, max_seq=64, num_layers=LAYERS, num_heads=2,
            d_model=64, attention_impl="flash")
PHASES = ("train.forward", "train.backward", "train.optimizer")


@pytest.fixture(autouse=True)
def _full_fp32():
    with tdevice.full_fp32():
        yield


@pytest.fixture(autouse=True)
def _fresh_tracer():
    """An empty ring, the tracer disabled, before and after each test."""
    tracer = tracing.get_tracer()
    was = tracer.enabled
    tracer.disable()
    tracer.clear()
    yield tracer
    tracer.clear()
    tracer.enabled = was


def _trainer(device="cpu", dtype=torch.float32, heads=2):
    cfg = gpt2.GPT2Config(**dict(TINY, num_heads=heads), dtype=dtype)
    init, step = build_train(lambda g: gpt2.GPT2(cfg),
                             lambda m, b: m.loss_fn(b),
                             optim.adafactor(1e-3), device=device)
    return init(0), step


def _tokens(batch=4, seq=33, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 128, (batch, seq), generator=g).to(device)


def _profiled_step(state, step, tokens):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        *state, _ = step(*state, {"tokens": tokens})
    return state, prof


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_a_profiled_step_is_one_trace_with_three_phases():
    state, step = _trainer()
    _, _ = _profiled_step(state, step, _tokens())
    spans = _by_name(tracing.get_tracer().spans())
    (root,) = spans["train.step"]
    assert root.parent_id is None
    # On the CPU every LayerNorm call (ln1 and ln2 a layer, lnf) takes the
    # plain version, and counts itself onto the step.
    assert root.attributes == {"step": 0, "tokens": 4 * 33,
                               "norm_kernel_calls": 0,
                               "norm_plain_calls": 2 * LAYERS + 1}
    for name in PHASES:
        (s,) = spans[name]
        assert (s.trace_id, s.parent_id) == (root.trace_id, root.span_id)
        assert root.start_s <= s.start_s <= s.end_s <= root.end_s
    fwd, bwd, opt = (spans[n][0] for n in PHASES)
    assert fwd.end_s <= bwd.start_s and bwd.end_s <= opt.start_s


def test_attention_spans_join_the_step_trace_under_their_phase():
    state, step = _trainer()
    _profiled_step(state, step, _tokens(batch=3))
    spans = _by_name(tracing.get_tracer().spans())
    root = spans["train.step"][0]
    for name, phase in (("attn.forward", "train.forward"),
                        ("attn.backward", "train.backward")):
        assert len(spans[name]) == LAYERS
        for s in spans[name]:
            assert s.trace_id == root.trace_id
            assert s.parent_id == spans[phase][0].span_id
            assert s.attributes == {"shape": (3, 2, 32, 32)}


def test_the_profiler_holds_each_span_as_a_host_range():
    state, step = _trainer()
    _, prof = _profiled_step(state, step, _tokens())
    counts = {}
    for e in prof.events():
        counts[e.name] = counts.get(e.name, 0) + 1
    assert {n: counts.get(n) for n in ("train.step", *PHASES)} == \
        {n: 1 for n in ("train.step", *PHASES)}
    assert counts.get("attn.forward") == counts.get("attn.backward") \
        == LAYERS


def test_a_step_after_the_profiler_records_nothing():
    state, step = _trainer()
    state, _ = _profiled_step(state, step, _tokens())
    n = len(tracing.get_tracer().spans())
    step(*state, {"tokens": _tokens()})
    assert len(tracing.get_tracer().spans()) == n


def test_two_threads_stepping_at_once_keep_their_own_traces(
        _fresh_tracer):
    _fresh_tracer.enable()
    steps, batches = 3, (2, 5)
    trainers = [_trainer() for _ in batches]
    barrier = threading.Barrier(len(batches), timeout=60)
    errors = []

    def run(i):
        try:
            state, step = trainers[i]
            for j in range(steps):
                barrier.wait()
                *state, _ = step(*state, {"tokens": _tokens(batches[i],
                                                            seed=j)})
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(batches))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    by_trace = {}
    for s in _fresh_tracer.spans():
        by_trace.setdefault(s.trace_id, []).append(s)
    assert len(by_trace) == steps * len(batches)
    seen = []
    for spans in by_trace.values():
        named = _by_name(spans)
        (root,) = named["train.step"]
        batch = root.attributes["tokens"] // 33
        seen.append(batch)
        ids = {s.span_id: s.name for s in spans}
        assert all(s.parent_id in ids for s in spans if s is not root)
        assert sorted(len(named[n]) for n in PHASES) == [1, 1, 1]
        for name in ("attn.forward", "attn.backward"):
            assert len(named[name]) == LAYERS
            assert {s.attributes["shape"][0] for s in named[name]} == \
                {batch}
    assert sorted(seen) == sorted(list(batches) * steps)


def test_steps_in_two_threads_count_only_their_own_layer_norm_calls(
        _fresh_tracer):
    """Two steps of ``build_train`` in flight at once, one a thread, on
    models of 1 and 3 layers: each ``train.step`` span carries the
    LayerNorm calls of its own step (ln1 and ln2 a layer and lnf, all
    plain on the CPU), not the other's. A barrier in the loss holds both
    forwards' calls made before either step ends."""
    _fresh_tracer.enable()
    layers = (1, 3)
    barrier = threading.Barrier(len(layers))

    def loss(m, b):
        out = m.loss_fn(b)
        barrier.wait(60)
        return out

    trainers = []
    for n in layers:
        cfg = gpt2.GPT2Config(**dict(TINY, num_layers=n),
                              dtype=torch.float32)
        init, step = build_train(lambda g, cfg=cfg: gpt2.GPT2(cfg), loss,
                                 optim.adafactor(1e-3), device="cpu")
        trainers.append((init(0), step))
    errors = []

    def run(i):
        try:
            state, step = trainers[i]
            for j in range(2):
                *state, _ = step(*state, {"tokens": _tokens(seed=j)})
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(layers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    roots = _fresh_tracer.spans("train.step")
    assert len(roots) == 2 * len(layers)
    got = []
    for root in roots:
        n = sum(s.trace_id == root.trace_id
                for s in _fresh_tracer.spans("attn.forward"))
        got.append(n)
        assert root.attributes["norm_plain_calls"] == 2 * n + 1, n
        assert root.attributes["norm_kernel_calls"] == 0
    assert sorted(got) == [1, 1, 3, 3]


def test_count_adds_to_the_outermost_open_span_of_a_trace(_fresh_tracer):
    """``tracing.count``: onto the thread's trace, or a trace given by id
    from another thread; a no-op, returning None, where no span of the
    trace is open."""
    _fresh_tracer.enable()
    assert tracing.count({"n": 1}) is None
    with tracing.device_span("root", None) as root, \
            tracing.device_span("phase", None) as phase:
        assert tracing.count({"n": 1, "m": 0}) == root.trace_id
        t = threading.Thread(target=tracing.count,
                             args=({"n": 2}, root.trace_id))
        t.start()
        t.join(60)
        assert not t.is_alive()
    assert root.attributes == {"n": 3, "m": 0}
    assert phase.attributes == {}
    assert tracing.count({"n": 1}, root.trace_id) is None
    assert root.attributes == {"n": 3, "m": 0}


def test_a_span_on_another_thread_joins_its_trace_innermost_open_span(
        _fresh_tracer):
    """What the attention backward does on autograd's CUDA worker thread:
    with the trace id captured where the work was launched, a span opened
    on a thread with no open span of its own nests under that trace's
    innermost open span, whichever thread opened it."""
    _fresh_tracer.enable()
    found = {}

    def worker(key, trace):
        with tracing.device_span("inner", None, trace) as s:
            found[key] = (s.trace_id, s.parent_id)

    with tracing.device_span("b", None) as b:
        pass
    with tracing.device_span("a", None) as a, \
            tracing.device_span("a.phase", None) as a_phase:
        for key, trace in (("a", a.trace_id), ("b", b.trace_id)):
            t = threading.Thread(target=worker, args=(key, trace))
            t.start()
            t.join(60)
            assert not t.is_alive()
    assert found["a"] == (a.trace_id, a_phase.span_id)
    assert found["b"] == (b.trace_id, None)  # b had closed
    assert _fresh_tracer._open == {}


def test_open_spans_of_many_threads_stay_consistent(_fresh_tracer):
    """More threads than cores, switching often, each opening nested spans
    in a trace of its own and joining them from a helper thread: every span
    keeps its own trace and parent, and no open span is left behind."""
    _fresh_tracer.enable()
    threads_n, rounds, errors = 16, 50, []

    def helper(trace, parent_id):
        with tracing.device_span("helper", None, trace) as s:
            if (s.trace_id, s.parent_id) != (trace, parent_id):
                errors.append((s.trace_id, s.parent_id, trace, parent_id))

    def run():
        try:
            for _ in range(rounds):
                with tracing.device_span("root", None) as root, \
                        tracing.device_span("phase", None) as phase:
                    if phase.parent_id != root.span_id:
                        errors.append("phase")
                    h = threading.Thread(target=helper,
                                         args=(root.trace_id, phase.span_id))
                    h.start()
                    h.join(30)
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert len(_fresh_tracer.spans("helper")) == threads_n * rounds
    assert _fresh_tracer._open == {}


def test_off_without_tracer_or_profiler_creates_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("made on the off path")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    for where in (None, torch.device("cpu"), torch.device("cuda"),
                  torch.zeros(1)):
        assert tracing.device_span("x", where) is tracing._NULL_SPAN
    state, step = _trainer()
    step(*state, {"tokens": _tokens()})
    assert tracing.get_tracer().spans() == []


def test_the_tracer_alone_turns_span_and_record_span_on():
    """The LLM engine's rule: a profiler does not make ``span``,
    ``record_span`` or ``inject_context`` record."""
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.span("llm.x") is tracing._NULL_SPAN
        assert tracing.record_span("llm.y", trace_id="t") is None
        with tracing.device_span("train.step", None):
            assert tracing.inject_context() is None
    assert [s.name for s in tracing.get_tracer().spans()] == ["train.step"]


def test_device_ms_is_none_on_the_cpu():
    state, step = _trainer()
    _profiled_step(state, step, _tokens())
    spans = tracing.get_tracer().spans()
    assert spans and all(s.device_ms is None for s in spans)
    assert all("reserved_bytes" not in s.attributes for s in spans)


def test_the_tracer_has_no_export_plane():
    tracer = tracing.Tracer()
    assert not any(hasattr(tracer, n) for n in
                   ("export_enabled", "_export", "drain_export"))


def test_a_sharded_step_on_a_one_rank_mesh_is_one_trace(tmp_path):
    (res,) = W.run_world(1, [("case_step_spans", dict(
        cfg=dict(TINY, dtype="float32"),
        tokens=_tokens().numpy()))], tmp_path)
    spans = res[0]["spans"]
    ids = {sid: name for name, sid, _, _ in spans}
    parents = sorted((name, ids.get(pid)) for name, _, pid, _ in spans)
    assert parents == sorted(
        [("train.step", None)] + [(p, "train.step") for p in PHASES]
        + [("attn.forward", "train.forward")] * LAYERS
        + [("attn.backward", "train.backward")] * LAYERS)
    assert len({trace for *_, trace in spans}) == 1
    assert set(res[0]["ranges"]) >= {"train.step", *PHASES}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device_ms is read from CUDA events")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_ms_on_the_card_tiles_the_step(cuda):
    """On the card every span has ``device_ms``; the phases lie inside the
    step on the device's clock, and the step holds the allocator's
    reserved bytes and its LayerNorm calls: ln1 and ln2 a layer and lnf,
    forward and backward, all through the kernels."""
    state, step = _trainer(cuda, torch.bfloat16, heads=1)  # K1-K3
    for _ in range(2):  # the kernels built and warm
        *state, _ = step(*state, {"tokens": _tokens(device=cuda)})
    _profiled_step(state, step, _tokens(device=cuda))
    named = _by_name(tracing.get_tracer().spans())
    root = named["train.step"][0]
    assert root.attributes["reserved_bytes"] == \
        torch.cuda.memory_reserved(cuda)
    assert root.attributes["norm_kernel_calls"] == 2 * (2 * LAYERS + 1)
    assert root.attributes["norm_plain_calls"] == 0
    phases = sum(named[n][0].device_ms for n in PHASES)
    assert 0 < phases <= root.device_ms
    for name in ("attn.forward", "attn.backward"):
        assert len(named[name]) == LAYERS
        assert all(s.device_ms > 0 for s in named[name])
        assert all(s.trace_id == root.trace_id for s in named[name])
    (bwd,) = named["train.backward"]
    assert {s.parent_id for s in named["attn.backward"]} == {bwd.span_id}
