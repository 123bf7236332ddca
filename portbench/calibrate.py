"""The readings a cell's limits are set from, all in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds <n> [<n> ...]
        [--control <n> ...] [--faults <n> ...] [--out <file.jsonl>]

For each seed of ``--seeds``: the program's run (set-up, one window step)
against the fp32 reference, the three numbers of ``compare``. For each seed
of ``--control``: the control, the reference computed in fp8 put in the
program's place. For each seed of ``--faults``: the program with a fault
planted underneath it (``FAULTS``). One JSON line a reading. The benchmark's
own runs never run this.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.join(ROOT,
                                                             "portbench"):
    sys.path[0] = ROOT
else:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402


@contextlib.contextmanager
def half_batch():
    """The loss over the first half of the batch's rows only."""
    from ray_tpu_torch.models import gpt2

    orig = gpt2.GPT2.loss_fn

    def loss_fn(self, batch, *a, **k):
        toks = batch["tokens"]
        return orig(self, {"tokens": toks[:toks.shape[0] // 2]}, *a, **k)

    gpt2.GPT2.loss_fn = loss_fn
    try:
        yield
    finally:
        gpt2.GPT2.loss_fn = orig


@contextlib.contextmanager
def state_unchanged():
    """Every optimizer update dropped: the step returns its parameters and
    state as they were."""
    from ray_tpu_torch.train import step as step_mod

    orig = step_mod._apply_updates
    step_mod._apply_updates = lambda opt, state, *a, **k: state
    try:
        yield
    finally:
        step_mod._apply_updates = orig


FAULTS = {"half_batch": half_batch, "state_unchanged": state_unchanged}


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--faults", type=int, nargs="*", default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from portbench import compare, harness

    cell = harness.load_cell(args.workload)
    fam = cell.family
    refs = {}
    real_ref = fam.reference_train
    current = {}

    def cached_ref(conf, weights, batches, precision="fp32"):
        key = (current["seed"], precision)
        if key not in refs:
            refs[key] = real_ref(conf, weights, batches, precision)
        return refs[key]

    fam.reference_train = cached_ref
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def program(seed, label, ctx=contextlib.nullcontext):
        current["seed"] = seed
        t0 = time.perf_counter()
        with ctx():
            res = cell.driver.run(cell, seed, 0.0, False, "cuda",
                                  lambda: 0.0)
        vals = compare.readings(res["readings"]["program"],
                                res["readings"]["reference"])
        emit({"cell": cell.name, "kind": label, "seed": seed, **vals,
              **compare.detail(res["readings"]["program"],
                               res["readings"]["reference"]),
              "seconds": time.perf_counter() - t0})

    for seed in args.seeds:
        program(seed, "program")
    for seed in args.control:
        import torch

        current["seed"] = seed
        t0 = time.perf_counter()
        batches = fam.make_batches(cell.config, cell.mix, seed,
                                   cell.mix["pool"], "cuda")[
                                       :cell.mix["check_steps"]]
        ref = fam.reference_train(cell.config, fam.make_weights(
            cell.config, seed, "cuda"), batches)
        ctl = fam.reference_train(cell.config, fam.make_weights(
            cell.config, seed, "cuda"), batches, "fp8")
        vals = compare.readings(ctl, ref)
        emit({"cell": cell.name, "kind": "control_fp8", "seed": seed,
              **vals, **compare.detail(ctl, ref),
              "seconds": time.perf_counter() - t0})
        del batches
        torch.cuda.empty_cache()
    for seed in args.faults:
        for name, ctx in FAULTS.items():
            program(seed, name, ctx)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
