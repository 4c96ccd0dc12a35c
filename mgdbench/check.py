"""The comparison that decides ``correct``: the program's first steps
against the float32 reference's.

The reference follows the program's trajectory (``reference.mgd.follow``
with the program's C̃): at each checked step it computes its own C₊, C₋
and C̃ at the program's parameters, then updates with the program's C̃.
Numbers, each held to the cell's limit (``limits/<workload>.json``):

* ``cost_gap``: the widest relative gap of a probe cost, C₊ or C₋ at any
  checked step, |C_program − C_reference| / |C_reference|.
* ``change_gap``: the program's ‖θₙ − θ₀‖ after the checked steps against
  the reference's along the same C̃s, worst leaf, over the larger of the
  reference's norm of that leaf and of the median leaf.
* ``nonfinite``: costs of the measured window that are not finite.

A leaf whose reference gradient is under a thousandth of the median
leaf's is left out of ``change_gap``: a leaf's MGD gradient C̃·θ̃/Δθ² has
the norm |C̃|·√n/Δθ, so the rule reads the leaves' sizes.
"""
from __future__ import annotations

import math
import statistics


def _kept(sizes):
    med = statistics.median(math.sqrt(n) for n in sizes.values())
    return [p for p, n in sizes.items() if math.sqrt(n) >= 1e-3 * med], med


def _worst(prog, ref, keep, scale):
    worst = 0.0
    for p in keep:
        den = scale(p)
        gap = abs(prog[p] - ref[p]) / den if den > 0 else (
            0.0 if prog[p] == ref[p] else math.inf)
        worst = max(worst, gap)
    return worst


def numbers(prog, ref, sizes):
    """The compared numbers of a program run (``prog``) against the
    reference that followed it (``ref``): both dicts of ``costs`` [[C₊,
    C₋] a step] and ``change_n`` ({path: norm}), ``prog`` also
    ``nonfinite``.  ``sizes`` is {path: elements}."""
    cost_gap = 0.0
    for cp, cr in zip(prog["costs"], ref["costs"]):
        for a, b in zip(cp, cr):
            gap = abs(a - b) / abs(b) if math.isfinite(a) else math.inf
            cost_gap = max(cost_gap, gap)
    keep, _ = _kept(sizes)
    med_n = statistics.median(ref["change_n"][p] for p in keep)
    return {
        "cost_gap": cost_gap,
        "change_gap": _worst(prog["change_n"], ref["change_n"], keep,
                             lambda p: max(ref["change_n"][p], med_n)),
        "nonfinite": float(prog.get("nonfinite", 0))}


def judge(values, limits):
    """({name: {"value", "limit"}}, correct) over the numbers the cell's
    limits name: every one at most its limit; one that is not finite
    fails.  A number without a limit is a reading, not compared."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value, limit = values[name], float(limit)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return checks, ok
