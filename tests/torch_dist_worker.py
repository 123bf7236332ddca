"""Ranks of a gloo world for the port's parallel tests, on the CPU.

``run_world(world, cases, tmp_path)`` spawns ``world`` processes that join
one gloo group over a ``file://`` store under ``tmp_path`` and run the
named cases (functions of this module, ``case(rank, world, **kwargs)``)
in order; it returns each rank's results (dicts of numpy arrays). This
module imports only torch, numpy and the port, so a child imports neither
JAX nor the tests' conftest.

Every case makes its inputs from numpy seeds, the same on every rank, as
the JAX side of the test does.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import traceback

import numpy as np
import torch
import torch.distributed as dist


def _rank_main(rank, world, store, cases, out):
    import logging

    torch.set_num_threads(1)
    # DTensor notes each two-step all-reduce of a 2-D mesh; not a failure.
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        from ray_tpu_torch import device

        with device.full_fp32():
            results = [globals()[name](rank, world, **kw)
                       for name, kw in cases]
        out.put((rank, results, None))
    except BaseException:  # reported to the parent, which fails the test
        out.put((rank, None, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def run_world(world: int, cases, tmp_path, timeout_s: float = 300.0):
    """Run ``cases`` (a list of ``(name, kwargs)``) on ``world`` gloo ranks;
    returns ``results[rank][case]``. Raises with the first rank's
    traceback if any rank fails."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = os.path.join(str(tmp_path), f"store_{os.getpid()}_{id(cases)}")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, cases, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            rank, res, err = out.get(timeout=timeout_s)
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
                break
            results[rank] = res
    except queue_mod.Empty:
        errors.append(f"ranks {sorted(set(range(world)) - set(results))} "
                      f"gave no result within {timeout_s} s")
    finally:
        for p in procs:
            p.join(timeout=5 if errors else 30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
    if errors:
        raise RuntimeError(errors[0])
    return [results[r] for r in range(world)]


def _np(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().cpu().numpy()


def rand(seed: int, *shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# -- cases --------------------------------------------------------------------

def case_collectives(rank, world):
    """Each eager op on rank r's share (row r of the [world, ...] inputs)."""
    from ray_tpu_torch.parallel import collective as C
    from ray_tpu_torch.parallel.mesh import MeshSpec

    C.init_collective_group(MeshSpec(dp=world).build("cpu"), "dp", "t")
    x = torch.from_numpy(rand(0, world, 3, 4)[rank])
    rs = torch.from_numpy(rand(1, world, world * 2, 3)[rank])
    out = {f"allreduce_{op}": _np(C.allreduce(x, op, group_name="t"))
           for op in ("sum", "max", "min", "mean")}
    out["allgather"] = _np(C.allgather(x, group_name="t"))
    out["reducescatter"] = _np(C.reducescatter(rs, "sum", group_name="t"))
    out["broadcast"] = _np(C.broadcast(x, 2, group_name="t"))
    out["send_recv"] = _np(C.send_recv(x, 1, 3, group_name="t"))
    out["reduce"] = _np(C.reduce(x, 1, "sum", group_name="t"))
    gathered = C.gather(x, 0, group_name="t")
    out["gather_is_none"] = np.asarray(gathered is None)
    if gathered is not None:
        out["gather"] = _np(gathered)
    C.barrier("t")
    C.destroy_collective_group("t")
    return out


def case_mesh_device(rank, world):
    """The device of ``MeshSpec(dp=world)``'s mesh on a gloo group: the
    card by default (so without one ``build()`` raises), the CPU when
    asked for."""
    from ray_tpu_torch.parallel.mesh import MeshSpec

    try:
        default = MeshSpec(dp=world).build().device_type
    except RuntimeError as e:
        default = f"raised: {e}"
    return {"default": np.asarray(default),
            "cpu": np.asarray(MeshSpec(dp=world).build("cpu").device_type)}


def case_sharded_train(rank, world, mesh, cfg, params, tokens, rules=None,
                       lr=1e-3, eps=1e-5, master_fp32=False, eval_tokens=None):
    """``build_sharded_train`` of the port's GPT-2 on ``MeshSpec(**mesh)``,
    from the JAX package's initial parameters (numpy, JAX layout); one step
    for each entry of ``tokens``. Returns the losses and gradient norms
    (and the eval loss of ``eval_tokens`` after the steps)."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.convert import gpt2_params_from_numpy
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.parallel.sharding import prune_rules_for_mesh
    from ray_tpu_torch.train.optim import adamw_lowmem
    from ray_tpu_torch.train.step import build_sharded_train, make_eval_step

    tcfg = gpt2.GPT2Config(**cfg)
    dmesh = MeshSpec(**mesh).build("cpu")
    pruned = prune_rules_for_mesh(dmesh, rules)

    def init_fn(_generator):
        model = gpt2.GPT2(tcfg)
        model.load_state_dict(gpt2_params_from_numpy(params, tcfg))
        return model

    loss_fn = lambda m, b: m.loss_fn(b, pruned)
    init, step_fn, _ = build_sharded_train(
        init_fn, loss_fn, dmesh, rules=rules,
        optimizer=adamw_lowmem(lr, eps=eps), master_fp32=master_fp32)
    model, opt_state, step = init(0)
    losses, norms = [], []
    for tok in tokens:
        model, opt_state, step, m = step_fn(model, opt_state, step,
                                            {"tokens": torch.from_numpy(tok)})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out = {"losses": np.asarray(losses), "norms": np.asarray(norms),
           "layer_rows": np.asarray(
               [p.to_local().shape[0] for n, p in model.named_parameters()
                if n.startswith("layers.")], np.int64),
           "state_layer_rows": np.asarray(
               [t.to_local().shape[0] for t in _dtensors(opt_state)
                if t.ndim and t.shape[0] == tcfg.num_layers], np.int64)}
    if eval_tokens is not None:
        ev = make_eval_step(loss_fn, dmesh, rules)
        out["eval"] = np.asarray(float(ev(
            model, {"tokens": torch.from_numpy(eval_tokens)})))
    return out


def case_step_spans(rank, world, cfg, tokens):
    """One step of ``build_sharded_train`` on ``MeshSpec(dp=world)`` under
    a CPU profiler, the tracer disabled: each span's (name, id, parent id,
    trace id) and the names of the profiler's host events."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.observability import tracing
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.train.optim import adafactor
    from ray_tpu_torch.train.step import build_sharded_train

    tcfg = gpt2.GPT2Config(**dict(cfg, dtype=getattr(torch, cfg["dtype"])))
    dmesh = MeshSpec(dp=world).build("cpu")
    init, step_fn, rules = build_sharded_train(
        lambda g: gpt2.GPT2(tcfg), lambda m, b: m.loss_fn(b), dmesh,
        optimizer=adafactor(1e-3))
    state = init(0)
    tracing.get_tracer().clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step_fn(*state, {"tokens": torch.from_numpy(tokens)})
    return {"spans": [(s.name, s.span_id, s.parent_id, s.trace_id)
                      for s in tracing.get_tracer().spans()],
            "ranges": sorted({e.name for e in prof.events()})}


def _dtensors(tree):
    """The DTensors of a tree of dicts, lists and tuples."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _dtensors(x)]
    return []


def _mesh(**axes):
    from ray_tpu_torch.parallel.mesh import MeshSpec

    return MeshSpec(**axes).build("cpu")


def case_ring(rank, world, mesh, shape, causal, impl="einsum", seed=3):
    """``ring_attention`` on whole q/k/v (seeded), with the gradients of
    sum(out * g) unless ``impl`` is "flash" (forward only)."""
    from ray_tpu_torch.parallel.ring import ring_attention

    q, k, v, g = (torch.from_numpy(rand(seed + i, *shape)) for i in range(4))
    grad = impl == "einsum"
    for t in (q, k, v):
        t.requires_grad_(grad)
    out = ring_attention(q, k, v, _mesh(**mesh), causal=causal,
                         impl=impl).full_tensor()
    res = {"out": _np(out)}
    if grad:
        (out * g).sum().backward()
        res.update(dq=_np(q.grad), dk=_np(k.grad), dv=_np(v.grad))
    return res


def case_ulysses(rank, world, mesh, shape, causal=True, seed=7):
    """``ulysses_attention`` on whole q/k/v, with gradients."""
    from ray_tpu_torch.parallel.ulysses import ulysses_attention

    q, k, v, g = (torch.from_numpy(rand(seed + i, *shape)) for i in range(4))
    for t in (q, k, v):
        t.requires_grad_()
    out = ulysses_attention(q, k, v, _mesh(**mesh), causal=causal,
                            impl="flash").full_tensor()
    (out * g).sum().backward()
    return {"out": _np(out), "dq": _np(q.grad), "dk": _np(k.grad),
            "dv": _np(v.grad)}


def moe_inputs(tokens, model, hidden, experts, seed=11):
    return (rand(seed, tokens, model),
            rand(seed + 1, model, experts, scale=0.1),
            rand(seed + 2, experts, model, hidden, scale=0.1),
            rand(seed + 3, experts, hidden, model, scale=0.1))


def case_moe_ep(rank, world, tokens, model, hidden, experts, top_k,
                capacity_factor):
    """``moe_ffn_local`` over ep = world: rank r routes tokens
    [r*T, (r+1)*T) and owns experts [r*E/ep, (r+1)*E/ep). Returns its
    output, aux, expert choices and dispatch, and the gradient of
    sum(out) with respect to its tokens and expert weights."""
    from ray_tpu_torch.parallel.moe import (_dispatch_mask, moe_ffn_local,
                                            router_topk)
    from ray_tpu_torch.parallel.sharding import use_mesh

    x, rw, wi, wo = (torch.from_numpy(a) for a in
                     moe_inputs(world * tokens, model, hidden, experts))
    xr = x.chunk(world)[rank].clone().requires_grad_()
    wir = wi.chunk(world)[rank].clone().requires_grad_()
    wor = wo.chunk(world)[rank].clone().requires_grad_()
    with use_mesh(_mesh(ep=world)):
        y, aux = moe_ffn_local(xr, rw, wir, wor, num_experts=experts,
                               top_k=top_k, capacity_factor=capacity_factor,
                               axis_name="ep")
        y.sum().backward()
    vals, idx, _ = router_topk(xr.detach() @ rw, top_k)
    cap = max(1, int(capacity_factor * tokens * top_k / experts))
    dispatch, _ = _dispatch_mask(idx, vals, experts, -(-cap // 8) * 8)
    return {"y": _np(y), "aux": _np(aux), "gate_idx": idx.numpy(),
            "dispatch": _np(dispatch), "dx": _np(xr.grad),
            "dw_in": _np(wir.grad), "dw_out": _np(wor.grad)}


def pipeline_inputs(stages=4, micro=8, mb=4, dim=16):
    return (rand(21, stages, dim, dim, scale=0.3), rand(22, micro, mb, dim),
            rand(23, micro, mb, dim))


def case_pipeline(rank, world):
    """``pipeline_apply`` of tanh(x @ w) stages over pp = world, with the
    gradient of sum(out * g) with respect to the stacked weights."""
    from ray_tpu_torch.parallel.pipeline import pipeline_apply

    ws, x, g = (torch.from_numpy(a) for a in pipeline_inputs(world))
    ws.requires_grad_()
    out = pipeline_apply(lambda w, xb: torch.tanh(xb @ w), ws, x,
                         _mesh(pp=world)).full_tensor()
    (out * g).sum().backward()
    return {"out": _np(out), "dws": _np(ws.grad)}


def case_gpt2_grads(rank, world, mesh, cfg, params, tokens, rules=None):
    """The port's GPT-2 loss and gradients under ``MeshSpec(**mesh)``
    (parameters placed by the pruned rules), from the JAX package's
    parameters. Gradients in the JAX layout."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.convert import (gpt2_params_from_numpy,
                                              gpt2_tree_to_numpy)
    from ray_tpu_torch.parallel.sharding import (distribute, place,
                                                 prune_rules_for_mesh,
                                                 spec_for, use_mesh)

    tcfg = gpt2.GPT2Config(**cfg)
    dmesh = _mesh(**mesh)
    pruned = prune_rules_for_mesh(dmesh, rules)
    model = gpt2.GPT2(tcfg)
    model.load_state_dict(gpt2_params_from_numpy(params, tcfg))
    place(dmesh, model, model.logical_axes(), pruned)
    tok = distribute(torch.from_numpy(tokens), dmesh,
                     spec_for(("batch",), pruned))
    with use_mesh(dmesh):
        loss = model.loss_fn({"tokens": tok}, pruned)
        loss.backward()
    grads = {n: p.grad.full_tensor() for n, p in model.named_parameters()}
    return {"loss": _np(loss), "grads": gpt2_tree_to_numpy(grads, tcfg)}


def case_pp_moe_raises(rank, world, cfg):
    """The port's GPT-2 with MoE under pp rules: the error it raises."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel.sharding import (distribute, place,
                                                 prune_rules_for_mesh,
                                                 use_mesh)

    dmesh = _mesh(pp=world)
    rules = prune_rules_for_mesh(dmesh, {"layers": "pp"})
    model = gpt2.GPT2(gpt2.GPT2Config(**cfg))
    place(dmesh, model, model.logical_axes(), rules)
    tok = distribute(torch.zeros((2, 9), dtype=torch.long), dmesh, ())
    try:
        with use_mesh(dmesh):
            model.loss_fn({"tokens": tok}, rules)
    except NotImplementedError as e:
        return {"error": np.asarray(str(e))}
    return {"error": np.asarray("")}


OPS = ("psum", "pmean", "all_gather", "all_gather_tiled", "psum_scatter",
       "all_to_all", "ring_permute", "ppermute_partial", "pmax", "pmin")


def ops_inputs(world):
    return rand(31, world, 8, 4), rand(32, world, 8, 4)


def apply_op(ops, name, x, axis):
    """One in-graph collective of ``collective.ops`` (or ``jax.lax``)."""
    if name == "psum":
        return ops.psum(x, axis)
    if name == "pmean":
        return ops.pmean(x, axis)
    if name == "all_gather":
        return ops.all_gather(x, axis)
    if name == "all_gather_tiled":
        return ops.all_gather(x, axis, axis=1, tiled=True)
    if name == "psum_scatter":
        return ops.psum_scatter(x, axis, scatter_dimension=0, tiled=True)
    if name == "all_to_all":
        return ops.all_to_all(x, axis, 0, 1, tiled=True)
    if name == "ring_permute":
        return ops.ring_permute(x, axis)
    if name == "ppermute_partial":
        return ops.ppermute(x, axis, [(0, 2), (3, 1)])
    if name == "pmax":
        return ops.pmax(x, axis)
    return ops.pmin(x, axis)


def case_ops(rank, world):
    """Each in-graph op on rank r's row of the inputs over sp = world: its
    output, and the gradient of sum(out * g) where it has one."""
    from ray_tpu_torch.parallel.collective import ops
    from ray_tpu_torch.parallel.sharding import use_mesh

    xs, gs = ops_inputs(world)
    out = {}
    with use_mesh(_mesh(sp=world)):
        out["axis_index"] = np.asarray(ops.axis_index("sp"))
        for name in OPS:
            x = torch.from_numpy(xs[rank]).requires_grad_()
            y = apply_op(ops, name, x, "sp")
            out[name] = _np(y)
            if name not in ("pmax", "pmin"):
                g = torch.from_numpy(
                    np.resize(gs[rank], y.shape).astype(np.float32))
                (y * g).sum().backward()
                out[name + "_grad"] = _np(x.grad)
    return out


def case_llama_grads(rank, world, params, tokens, rules=None, remat=False):
    """The port's llama-tiny loss and gradients on ``MeshSpec(tp=world)``
    (parameters placed by the pruned rules), from the JAX package's
    parameters; gradients in the JAX layout, and each rank's local shape of
    every parameter."""
    import dataclasses

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import (llama_params_from_numpy,
                                              llama_tree_to_numpy)
    from ray_tpu_torch.parallel.sharding import (place, prune_rules_for_mesh,
                                                 use_mesh)

    cfg = dataclasses.replace(llama.CONFIGS["llama-tiny"], remat=remat)
    dmesh = _mesh(tp=world)
    pruned = prune_rules_for_mesh(dmesh, rules)
    model = llama.Llama(cfg, device="cpu")
    model.load_state_dict(llama_params_from_numpy(params, cfg))
    place(dmesh, model, model.logical_axes(), pruned)
    with use_mesh(dmesh):
        loss = model.loss_fn({"tokens": torch.from_numpy(tokens)}, pruned)
        loss.backward()
    grads = {n: p.grad.full_tensor() for n, p in model.named_parameters()}
    return {"loss": _np(loss), "grads": llama_tree_to_numpy(grads, cfg),
            "local": {n: np.asarray(p.to_local().shape)
                      for n, p in model.named_parameters()}}


def _drive(engine, prompt, max_new, **kw):
    """Rank 0: one request through ``step()`` to its end; its tokens."""
    h = engine.submit(prompt, max_new=max_new, **kw)
    for _ in range(4000):
        if h._done.is_set():
            return h.result(timeout=0).tokens
        engine.step()
    raise AssertionError("the engine did not finish")


def _tiny_llama(params):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import llama_params_from_numpy

    cfg = llama.CONFIGS["llama-tiny"]
    model = llama.Llama(cfg, device="cpu")
    model.load_state_dict(llama_params_from_numpy(params, cfg))
    return model.requires_grad_(False)


def case_llm_tp(rank, world, params, prompt, max_new, engine_kw):
    """llama-tiny served at tp = world (rank 0 schedules, the others
    follow) and, on rank 0, at tp1 from the same weights: greedy and
    seeded-sampled tokens, each rank's parameter shards and page pool after
    the requests, ``decode_profile``, a session exported at tp1 and
    continued at tp = world and the other way round, and the error of a
    config whose 3 heads tp does not divide."""
    from ray_tpu_torch.llm.engine import SlotEngine
    from ray_tpu_torch.models import llama

    mesh = _mesh(tp=world)
    tp = SlotEngine(_tiny_llama(params), mesh=mesh, device="cpu",
                    **engine_kw)
    out = {"kv_spec": np.asarray(str(tuple(tp.kv_spec)))}
    sampled = dict(temperature=0.7, seed=99)
    turn2 = [int(t) for t in np.random.default_rng(6).integers(1, 512, 5)]
    if rank == 0:
        one = SlotEngine(_tiny_llama(params), device="cpu", **engine_kw)
        out["greedy_tp1"] = np.asarray(_drive(one, prompt, max_new))
        out["sampled_tp1"] = np.asarray(_drive(one, prompt, max_new,
                                               **sampled))
        out["greedy"] = np.asarray(_drive(tp, prompt, max_new))
        out["sampled"] = np.asarray(_drive(tp, prompt, max_new, **sampled))
        out["devices"] = np.asarray(tp.decode_profile()["devices"])
        # tp1 -> tp: the session's first turn at tp1, its second at tp
        # after an import, against tp1 going on alone.
        first = _drive(one, prompt, max_new, session_id="a")
        snap = one.export_session("a")
        follow_up = prompt + first + turn2
        out["session_tp1_alone"] = np.asarray(_drive(one, follow_up, 6))
        tp.clear_prefix_cache()  # the import writes every page
        imported = tp.import_session(snap)
        out["session_tp_after_import"] = np.asarray(
            _drive(tp, follow_up, 6))
        out["session_tp_matched"] = np.asarray(imported["pages_imported"])
        # tp -> tp1, the other way round.
        first = _drive(tp, prompt, max_new, session_id="b")
        snap = tp.export_session("b")
        out["snapshot_heads"] = np.asarray(snap["pages_kv"].shape[4])
        follow_up = prompt + first + turn2
        out["session_tp_alone"] = np.asarray(_drive(tp, follow_up, 6))
        fresh = SlotEngine(_tiny_llama(params), device="cpu", **engine_kw)
        fresh.import_session(snap)
        out["session_tp1_after_import"] = np.asarray(
            _drive(fresh, follow_up, 6))
        out["no_graphs"] = np.asarray(len(tp._graphs) == 0)
        tp.stop()
    else:
        tp.follow()
    out["local"] = {n: np.asarray(p.to_local().shape)
                    for n, p in tp._model.named_parameters()}
    out["pool"] = np.asarray(tp._cache["kv"].shape)
    bad = llama.LlamaConfig(vocab_size=512, max_seq=128, num_layers=1,
                            num_heads=3, num_kv_heads=3, d_model=48, d_mlp=96,
                            dtype=torch.float32)
    try:
        SlotEngine(llama.Llama(bad, device="cpu"), num_slots=2, chunk=8,
                   page_size=8, mesh=mesh, device="cpu")
        out["bad_error"] = np.asarray("")
    except ValueError as e:
        out["bad_error"] = np.asarray(str(e))
    return out


def case_llm_server_tp(rank, world, params, prompt, max_new):
    """``LLMServer(tp=world)`` from the JAX package's parameters: rank 0
    answers one plain and one streaming request, the others follow."""
    import asyncio

    from ray_tpu_torch.llm.serve import LLMServer

    server = LLMServer(model="llama-tiny", num_slots=2, chunk=8,
                       page_size=8, decode_block=2, tp=world,
                       params=params, device="cpu")
    out = {"tp": np.asarray(server.engine.tp)}
    if rank == 0:
        async def both():
            plain = await server({"prompt": prompt, "max_tokens": max_new})
            stream = [t async for t in await server(
                {"prompt": prompt, "max_tokens": max_new, "stream": True})]
            return plain, stream

        plain, stream = asyncio.run(both())
        out["plain"] = np.asarray(plain["tokens"])
        out["stream"] = np.asarray(stream)
        server.engine.stop()
    else:
        server.engine._thread.join(timeout=120)
        out["followed"] = np.asarray(not server.engine._thread.is_alive())
    return out


def llm_series(registry):
    """The ``rt_llm_*`` series of a metrics registry: counters and gauges
    by tag key, histograms by their observation counts."""
    out = {}
    for name, (kind, data) in registry.collect_all().items():
        if name.startswith("rt_llm_"):
            out[name] = {k: v["count"] if kind == "histogram" else v
                         for k, v in data.items()}
    return out


def case_llm_telemetry_tp(rank, world, params, prompt, max_new, engine_kw,
                          trace_ctx):
    """llama-tiny at tp = world with the port's tracer on: rank 0 serves
    one traced request, then reads ``decode_profile`` with the configured
    roof and with a roof of 0; every rank returns its ``rt_llm_*`` series
    before and after, and its ``llm.*`` spans."""
    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.llm.engine import SlotEngine
    from ray_tpu_torch.observability import metrics, tracing

    tracing.get_tracer().enable()
    tp = SlotEngine(_tiny_llama(params), mesh=_mesh(tp=world), device="cpu",
                    **engine_kw)
    out = {"before": llm_series(metrics.registry)}
    if rank == 0:
        out["tokens"] = _drive(tp, prompt, max_new, trace_ctx=trace_ctx)
        out["profile"] = tp.decode_profile()
        out["roofline_gauge"] = metrics.registry.get(
            "rt_llm_roofline_frac").collect()[1][()]
        cfg = config()
        roof = cfg.hbm_bandwidth_gbps
        cfg.apply_overrides({"hbm_bandwidth_gbps": 0.0})
        try:
            out["profile_no_roof"] = tp.decode_profile()
        finally:
            cfg.apply_overrides({"hbm_bandwidth_gbps": roof})
        tp.stop()
    else:
        tp.follow()
    out["after"] = llm_series(metrics.registry)
    out["spans"] = [(s.name, s.trace_id, s.parent_id)
                    for s in tracing.get_tracer().spans("llm.")]
    return out
