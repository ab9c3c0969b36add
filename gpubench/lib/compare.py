"""The numbers that decide ``correct``, and their judging.

A training cell's step is judged as the benchmark's rules set out: each
step's loss, the norm of the first gradient as the optimizer gets it, and
the norm of the parameters' change after the checked steps, the last two
by the worst leaf: the gap between the program's norm and the
reference's, over the reference's norm of that leaf or of the median leaf,
whichever is larger. Leaves whose reference gradient is under a thousandth
of the median leaf's move by round-off alone and are left out.
"""
from __future__ import annotations

import statistics


def loss_gap(program, reference) -> float:
    """The largest relative gap of the per-step losses."""
    return max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(program, reference))


def leaf_gap(program: dict, reference: dict, ref_grads: dict) -> float:
    """The worst leaf's gap of two dicts of per-leaf norms; ``ref_grads``
    (the reference's first-gradient norms) picks the leaves that count."""
    med_grad = statistics.median(ref_grads.values())
    counted = [k for k in reference if ref_grads[k] >= 1e-3 * med_grad]
    med = statistics.median(reference[k] for k in counted)
    return max(abs(program[k] - reference[k]) / max(reference[k], med, 1e-30)
               for k in counted)


def judge(numbers: dict, limits: dict):
    """``(correct, checks)``: every number at or under its limit; a number
    that is missing or not finite fails. ``checks`` maps each name to
    ``{"value", "limit"}``, in the order of ``limits``."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
