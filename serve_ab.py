#!/usr/bin/env python3
"""Times the llama-1b serving engine of one or more checkouts of the port
on one NVIDIA card, each checkout in a process of its own, in the order
given.

    python3 serve_ab.py ROOT [ROOT ...]

For A/B runs, give the roots alternately (parent, change, change, parent).
Each ROOT is a directory holding a ``ray_tpu_torch`` package. Each process
builds ``chip_smoke.py`` phase 6's engine from its root (llama-1b, bf16,
random weights from seed 0, 8 slots, chunk 128, page 16, decode block 16,
each checkout's defaults otherwise), warms it up, then serves REPS runs of
8 requests of 128-token prompts and 128 new tokens (prompts from
``default_rng(0)``, the same for every root), and reports each run's
decode step ms (``decode_profile()["avg_step_ms"]``: host wall time of the
steady pipeline over its steps) and tokens/s, and their medians.

Prints one JSON line per process, a table, the card's name and power
limit, and writes every line to chiprun_out/serve_ab.json.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPS, REQUESTS, PROMPT, NEW = 5, 8, 128, 128


def one(root):
    """Serves with ``root``'s engine in this process; returns a dict."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from ray_tpu_torch.llm.engine import SlotEngine
    from ray_tpu_torch.models import llama

    if not torch.cuda.is_available():
        raise SystemExit("serve_ab: no CUDA device")
    if not llama.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"serve_ab: imported {llama.__file__}, not "
                         f"{root}'s")
    dev = torch.device("cuda")
    cfg = llama.CONFIGS["llama-1b"]
    model = llama.Llama(cfg, torch.Generator(device=dev).manual_seed(0),
                        dev).to(cfg.dtype).requires_grad_(False)
    engine = SlotEngine(model, num_slots=8, chunk=128, page_size=16,
                        decode_block=16, device=dev)
    engine.warmup()
    rng = np.random.default_rng(0)
    runs = []
    for _ in range(REPS):
        engine.reset_decode_profile()
        t0 = time.perf_counter()
        handles = [engine.submit(rng.integers(1, cfg.vocab_size,
                                              size=PROMPT).tolist(),
                                 max_new=NEW) for _ in range(REQUESTS)]
        for _ in range(100000):
            if not engine.step() and all(h._done.is_set() for h in handles):
                break
        dt = time.perf_counter() - t0
        if not all(len(h.result(timeout=0).tokens) == NEW for h in handles):
            raise SystemExit("serve_ab: a request did not finish")
        runs.append({"step_ms": engine.decode_profile()["avg_step_ms"],
                     "tokens_s": REQUESTS * NEW / dt})
        engine.clear_prefix_cache()
    engine.stop()
    return {"root": root, "runs": runs,
            "step_ms": statistics.median(r["step_ms"] for r in runs),
            "tokens_s": statistics.median(r["tokens_s"] for r in runs)}


def main(argv):
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as smoke

    card = smoke.smi_line()
    rows = []
    for root in argv:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root], capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            raise SystemExit(f"serve_ab: {root} failed ({proc.returncode})")
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]))
    print(f"{'root':<28}{'decode step ms':>16}{'tokens/s':>12}")
    for r in rows:
        print(f"{r['root']:<28}{r['step_ms']:>16.4f}{r['tokens_s']:>12.2f}")
    print(f"card: {card}")
    out = os.path.join(HERE, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "serve_ab.json"), "w") as f:
        json.dump({"card": card, "runs": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
