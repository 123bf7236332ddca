"""``calibrate.py`` with its half-batch fault planted in any family's loss.

    python3 portbench/calibrate_family.py --workload <cell> [the arguments
        of calibrate.py]

``calibrate.py``'s ``half_batch`` patches GPT-2's ``loss_fn``; here the
fault wraps the loss the cell's family builds (``build_program``), so that
the program sees only the first half of each batch's rows whatever the
model. Everything else is ``calibrate.py``'s own. The benchmark's own runs
never run this.
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


@contextlib.contextmanager
def half_batch(family):
    """The family's loss over the first half of the batch's rows only."""
    orig = family.build_program

    def build_program(conf, weights, device):
        init_fn, loss_fn = orig(conf, weights, device)

        def half(model, batch):
            toks = batch["tokens"]
            return loss_fn(model, {"tokens": toks[:toks.shape[0] // 2]})

        return init_fn, half

    family.build_program = build_program
    try:
        yield
    finally:
        family.build_program = orig


def main(argv) -> int:
    from portbench import calibrate, harness

    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--workload", required=True)
    known, _ = p.parse_known_args(argv)
    family = harness.load_cell(known.workload).family
    calibrate.FAULTS["half_batch"] = lambda: half_batch(family)
    return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
