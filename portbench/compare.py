"""The comparison that decides ``correct`` for a training cell.

Three numbers, each held to its limit from the cell's file:

- ``loss_gap``: the largest relative gap between the program's and the
  reference's loss over the checked steps;
- ``grad_norm_gap``: over the parameters, the largest gap between the
  program's and the reference's norm of the first step's gradient, as the
  optimizer gets it;
- ``change_norm_gap``: the same for the norm of the parameters' change over
  the checked steps.

A parameter is a leaf's layer, or a part of it where the leaf fuses
several projections (``reference.gpt2.unit_norms``). A gap is
measured against the reference's norm of that parameter or of the median
parameter, whichever is larger, since some gradients are all but zero. The
change leaves out parameters whose reference gradient is under a
thousandth of the median's: rounding alone moves them under Adafactor.
A number that is not finite reads as infinite, and so do the gradient
norms of a program whose optimizer was never called.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

NAMES = ("loss_gap", "grad_norm_gap", "change_norm_gap")
NEGLIGIBLE_GRAD = 1e-3


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def _flat(norms: Dict) -> Dict[Tuple[str, int], float]:
    return {(leaf, j): float(v) for leaf, t in norms.items()
            for j, v in enumerate(t.detach().float().cpu().tolist())}


def _median(values: Sequence[float]) -> float:
    s = sorted(values)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def gaps(prog: Dict, ref: Dict, keys) -> Dict:
    """Each parameter's gap of norms, against the reference's norm of that
    parameter or of the median parameter, whichever is larger."""
    med = _median([ref[k] for k in keys])
    return {k: _finite(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30))
            for k in keys}


def _pairs(prog: Dict, ref: Dict):
    """The program's and the reference's gradient norms with the parameters
    compared, then the same for the change."""
    rg = _flat(ref["grad_norms"])
    pg = ({k: math.nan for k in rg} if prog["grad_norms"] is None
          else _flat(prog["grad_norms"]))
    pc, rc = _flat(prog["change_norms"]), _flat(ref["change_norms"])
    if set(pg) != set(rg) or set(pc) != set(rc):
        raise ValueError("the program's and the reference's parameters "
                         "differ")
    med = _median(list(rg.values()))
    moved = [k for k in rc if rg[k] >= NEGLIGIBLE_GRAD * med]
    return (pg, rg, list(rg)), (pc, rc, moved)


def readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The three numbers, from the program's and the reference's
    ``losses``, ``grad_norms`` and ``change_norms``."""
    losses = [_finite(abs(a - b) / abs(b)) for a, b in
              zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        losses.append(math.inf)
    grad, change = (gaps(*pair) for pair in _pairs(prog, ref))
    return {"loss_gap": max(losses),
            "grad_norm_gap": max(grad.values()),
            "change_norm_gap": max(change.values())}


def floored(prog: Dict, ref: Dict, keys) -> Dict[str, list]:
    """By leaf, the parameters whose reference norm is under the median
    parameter's, so that the median's norm measures their gap: [how many,
    the least of their norms over the median's, the largest of their gaps
    against their own norm]."""
    med = _median([ref[k] for k in keys])
    out: Dict[str, list] = {}
    for k in keys:
        if ref[k] < med:
            c = out.setdefault(k[0], [0, math.inf, 0.0])
            c[0] += 1
            c[1] = min(c[1], ref[k] / med)
            c[2] = max(c[2], _finite(abs(prog[k] - ref[k])
                                     / max(ref[k], 1e-30)))
    return out


def detail(prog: Dict, ref: Dict) -> Dict:
    """Where the numbers come from: each step's loss gap, and for the
    gradient and the change the median parameter's gap, the three
    parameters with the largest and the parameters the median's norm
    measures (``floored``)."""
    out = {"loss_gaps": [abs(a - b) / abs(b) for a, b in
                         zip(prog["losses"], ref["losses"])]}
    for name, pair in zip(("grad", "change"), _pairs(prog, ref)):
        g = gaps(*pair)
        top = sorted(g.items(), key=lambda kv: -kv[1])[:3]
        out[name] = {"median": _median(list(g.values())),
                     "worst": [[f"{k[0]}[{k[1]}]", v] for k, v in top],
                     "floored": floored(*pair)}
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """Whether every number is within its limit, and each beside it."""
    checks = {n: {"value": values[n], "limit": limits[n]} for n in NAMES}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
