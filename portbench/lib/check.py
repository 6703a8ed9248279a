"""What decides ``correct``: the program's first steps against the plain
reference's, from the same seed's weights and batches.  Three numbers:

* ``loss_gap``   the largest |loss - reference loss| over the steps the
  reference names (``compare_steps``: each replica's first step; all of
  them when it names none);
* ``grad_gap``   over the leaves, the largest gap between the program's
  and the reference's norm of the first gradient as the optimizer read
  it, over the larger of the reference's norm of that leaf and of the
  median leaf;
* ``dparam_gap`` the same of each leaf's change after the steps, leaving
  out the leaves whose reference first gradient is under a thousandth of
  the median leaf's (their change is AdamW turning round-off into steps).

Each has a limit of its own, set in the cell's file from readings of
sound runs and of the lower-precision control (``PERF.md``)."""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Tuple

NUMBERS = ("loss_gap", "grad_gap", "dparam_gap")
QUIET = 1e-3          # a leaf's gradient under this share of the median's


def leaf_gap(prog: Dict[tuple, float], ref: Dict[tuple, float],
             keep: Optional[List[tuple]] = None) -> Tuple[float, tuple]:
    keys = list(ref) if keep is None else keep
    med = statistics.median(ref[k] for k in keys)
    worst, at = 0.0, ()
    for k in keys:
        den = max(ref[k], med)
        g = abs(prog[k] - ref[k]) / den if den > 0 else \
            (0.0 if prog[k] == 0 else math.inf)
        if not math.isfinite(prog[k]):
            g = math.inf
        if g > worst or not at:
            worst, at = g, k
    return worst, at


def readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The three numbers of ``prog`` (losses, grad1, dparam) against
    ``ref``; non-finite program values read as infinite."""
    n = len(ref["losses"])
    if len(prog["losses"]) < n:
        return {k: math.inf for k in NUMBERS}
    steps = ref.get("compare_steps", range(n))
    a, b = prog["losses"], ref["losses"]
    lg = max((abs(a[i] - b[i]) if math.isfinite(a[i]) else math.inf)
             for i in steps)
    gg, _ = leaf_gap(prog["grad1"], ref["grad1"])
    med = statistics.median(ref["grad1"].values())
    keep = [k for k, v in ref["grad1"].items() if v >= QUIET * med]
    dg, _ = leaf_gap(prog["dparam"], ref["dparam"], keep)
    return {"loss_gap": lg, "grad_gap": gg, "dparam_gap": dg}


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
