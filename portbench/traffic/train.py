"""Training traffic: whole training steps of the program on batches of
tokens drawn from the seed.

A mix file of this kind (``"kind": "train"``) gives the batch, the
sequence length, the batches drawn (``pool``; the window cycles through
them), the steps the reference follows (``check_steps``), the steps the
traced run profiles with device activity only for the card's busy time
(``busy_steps``) and with host operations too (``profile_steps``).

One run:

1. set-up: the kernels built or found, the weights and batches made from
   the seed, the program's ``build_train`` step on them; the first
   ``check_steps`` steps go through the window's own call and feed, on
   batches that all differ, and are the warm-up; the program's readings
   (each step's loss, the first gradient's norms as the optimizer gets
   them, the parameters' change over the checked steps) are taken there;
2. the window: whole steps for ``seconds``, ended by a synchronize; the
   device's peak memory over it;
3. with ``trace``: ``busy_steps`` steps under torch.profiler tracing the
   device alone, between two marker kernels (the busy time, the device
   operations, and the window's length a step against the untraced
   window's); ``profile_steps`` steps tracing the host too (the idle gaps
   by host operation); as many again with marker kernels around each call
   of the program's attention; then one optimizer update timed by CUDA
   events on the model's own gradients;
4. the program's state freed, the reference's steps from the same weights
   and batches, and the comparison.
"""

from __future__ import annotations

import dataclasses
import gc
import statistics
import sys
import time
from typing import Dict

ATTN_RANGES = ("portbench.attn_fwd", "portbench.attn_bwd")
OPTIM_REPS = 3


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _recording(optim, record: Dict, fam):
    """``optim`` with the first update's gradient norms kept in ``record``:
    ``fam.unit_norms`` of each gradient, by the parameter names in
    ``record["names"]``."""

    def update(grads, state, params=None):
        if "grad_norms" not in record:
            record["grad_norms"] = {
                n: fam.unit_norms(fam.leaf_name(n), g[None])
                for n, g in zip(record["names"], grads)}
        return optim.update(grads, state, params)

    return type(optim)(optim.init, update)


def run(cell, seed: int, seconds: float, trace: bool, device,
        process_age) -> Dict:
    import torch

    from ray_tpu_torch.train.step import build_train

    fam, conf, mix = cell.family, cell.config, cell.mix
    device = torch.device(device)
    marks = [("start", process_age())]
    if device.type == "cuda":
        torch.cuda.init()
        marks.append(("cuda", process_age()))
        fam.build_kernels()
        marks.append(("kernels", process_age()))
    weights = fam.make_weights(conf, seed, device)
    batches = fam.make_batches(conf, mix, seed, mix["pool"], device)
    _sync(torch, device)
    marks.append(("inputs", process_age()))
    tokens_per_step = mix["batch"] * mix["seq"]
    optim = fam.optimizer(conf)
    record: Dict = {}
    init_fn, loss_fn = fam.build_program(conf, weights, device)
    init, step = build_train(init_fn, loss_fn,
                             _recording(optim, record, fam),
                             master_fp32=False, device=device)
    state = init(seed)
    _sync(torch, device)
    marks.append(("program", process_age()))
    model = state[0]
    record["names"] = [n for n, _ in model.named_parameters()]
    layers = fam.sizes(conf)["layers"]

    losses = []
    for i in range(mix["check_steps"]):
        *state, met = step(*state, {"tokens": batches[i]})
        losses.append(met["loss"])
    with torch.no_grad():
        named = dict(model.named_parameters())
        change = {}
        for leaf, w0 in weights.items():
            now = fam.leaf_of(named, leaf, layers).float()
            first = w0.float() if leaf.startswith("blocks.") else \
                w0.float()[None]
            change[leaf] = fam.unit_norms(leaf, now - first)
    del weights, named
    # An optimizer never called leaves no gradient norms (read as infinite).
    prog = {"losses": [float(x) for x in losses],
            "grad_norms": (fam.by_leaf(record["grad_norms"], layers)
                           if "grad_norms" in record else None),
            "change_norms": change}

    # The window.
    _sync(torch, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = process_age()
    marks.append(("checked steps", setup_s))
    print("set-up: " + ", ".join(f"{name} {t:.3f} s" for name, t in marks),
          file=sys.stderr)
    window_losses, n = [], 0
    t0 = time.perf_counter()
    while True:
        *state, met = step(*state,
                           {"tokens": batches[(mix["check_steps"] + n)
                                              % mix["pool"]]})
        window_losses.append(met["loss"])
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(torch, device)
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    out = {"attempted": n, "failed": failed, "memory_peak_bytes": peak,
           "e2e": {"train_tokens_per_s": n * tokens_per_step / window_s,
                   "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
           "summary": None, "extra": {}}

    if trace:
        out["summary"], out["extra"] = _traced(torch, fam, cell, step, state,
                                               batches, optim, loss_fn,
                                               device)
        print(f"traced: {out['extra']['traced_step_s']:.6f} s a step on the "
              f"device's clock over {mix['busy_steps']} profiled steps, "
              f"untraced {window_s / n:.6f} s", file=sys.stderr)
    del model, state, step, init, window_losses, met
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = fam.reference_train(
        conf, fam.make_weights(conf, seed, device),
        batches[:mix["check_steps"]])
    out["readings"] = {"program": prog, "reference": ref}
    return out


def _traced(torch, fam, cell, step, state, batches, optim, loss_fn, device):
    """The profiled steps and the optimizer's timing, after the window (on
    the card only)."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from .. import traces as tr

    mix = cell.mix
    entry = fam.attention_entry()
    saved = {k: entry.__dict__[k] for k in ("forward", "backward")}

    calls, marking = [0], [False]

    def mark():
        if marking[0]:
            torch.cuda._sleep(0)  # a kernel named traces.MARKER

    def ranged(fn, name):
        def call(ctx, *args):
            with record_function(name):
                calls[0] += marking[0]
                mark()
                out = fn(ctx, *args)
                mark()
                return out
        return staticmethod(call)

    # Three windows. The first traces the device alone (recording host
    # operations slows the host, and with it the card) for the busy time
    # and the device operations; the second, with the host, names the idle
    # gaps; the third brackets each attention call (the markers stall the
    # host).
    entry.forward = ranged(entry.forward, ATTN_RANGES[0])
    entry.backward = ranged(entry.backward, ATTN_RANGES[1])
    summaries = []
    try:
        _sync(torch, device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(0)  # a kernel named traces.MARKER
            for i in range(mix["busy_steps"]):
                *state, _ = step(*state,
                                 {"tokens": batches[i % mix["pool"]]})
            torch.cuda._sleep(0)
            _sync(torch, device)
        busy = tr.device_window(tr.from_profiler(prof))
        del prof
        for marking[0] in (False, True):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function(tr.WINDOW):
                    for i in range(mix["profile_steps"]):
                        *state, _ = step(*state, {"tokens": batches[i]})
                    _sync(torch, device)
            summaries.append(tr.summarize(tr.from_profiler(prof)))
            del prof
    finally:
        for k, v in saved.items():
            setattr(entry, k, v)
    summary = dataclasses.replace(busy, idle_gaps=summaries[0].idle_gaps,
                                  bracketed_s=summaries[1].bracketed_s,
                                  brackets=summaries[1].brackets)

    model, opt_state = state[0], state[1]
    params = list(model.parameters())
    loss_fn(model, {"tokens": batches[0]}).backward()
    grads = [p.grad for p in params]
    for p in params:
        p.grad = None
    times = []
    with torch.no_grad():
        for _ in range(OPTIM_REPS):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            _sync(torch, device)
            start.record()
            updates, _ = optim.update(grads, opt_state,
                                      [p.detach() for p in params])
            for p, u in zip(params, updates):
                p.copy_(p + u)
            end.record()
            _sync(torch, device)
            times.append(start.elapsed_time(end) / 1e3)
            del updates
    extra = {"optim_s": statistics.median(times),
             "profile_steps": mix["profile_steps"], "attn_calls": calls[0],
             "traced_step_s": busy.window_s / mix["busy_steps"]}
    return summary, extra

