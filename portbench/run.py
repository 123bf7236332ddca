"""Runs one cell of the benchmark on the card this process finds.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the comparison with the
plain reference held, beside its limit (also the last lines of standard
error). Exits non-zero, printing no result, where there is no CUDA card
or fewer than the cell asks for, and where JAX or the JAX package was
loaded.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Every compile cache the run may cause, at a fixed place in the checkout.
CACHE = os.path.join(ROOT, ".portbench_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
# The checkout's root in place of this script's directory, whose modules
# would otherwise shadow top-level names.
if sys.path and os.path.abspath(sys.path[0]) == os.path.join(ROOT,
                                                             "portbench"):
    sys.path[0] = ROOT
else:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA devices, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda")
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for c in result["checks"].values():
        c["value"] = harness.finite_or_none(c["value"])
    for line in harness.check_lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
