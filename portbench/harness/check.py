"""The numbers that decide ``correct``, each beside its limit.

Training cells: the program's first steps, read from its losses and its
optimizer's state, against the plain reference's steps from the same
weights and rows (``reference/_train.py``):

- ``loss_gap``: the largest relative gap of a step's total loss;
- ``grad_gap``: over the parameters, the largest gap between the norm of
  the program's first gradient (worked out from its optimizer state after
  one step) and the reference's, against the larger of the reference's
  norm of that parameter and of the median parameter;
- ``change_gap``: the same of the norm of each parameter's change after
  the steps, over the parameters whose reference gradient is at least a
  thousandth of the median parameter's (a gradient nought to rounding,
  such as a bias under a softmax, moves under adam by round-off alone);
- ``grad_gap_median``, ``change_gap_median``: the median parameter's gap
  of the same, steady from seed to seed where the worst parameter's is
  the noise of one small sum.

The cell's limits file names the numbers compared; the others are read
and not compared.

Serving cells: ``score_gap``, the widest gap between a served score and
the reference's over a sample of the requests answered in the window.
"""

import math
import statistics

ADAM_B1 = 0.9
# a parameter whose reference gradient is under this share of the median
# parameter's takes no part in change_gap
NOUGHT_SHARE = 1e-3


def first_gradient_norms(optimizer, state):
    """``{name: norm}`` of the first step's gradient from the optimizer's
    state after one step from zero state: adagrad's accumulator holds
    g^2, adam's first moment (1 - b1) g."""
    out = {}
    for name, st in state.items():
        if optimizer == "adagrad":
            out[name] = float(st[0].double().sum().sqrt())
        elif optimizer == "adam":
            out[name] = float(st[0].double().norm()) / (1.0 - ADAM_B1)
        else:
            raise ValueError("no gradient reading for %r" % optimizer)
    return out


def _gap(got, want, floor):
    return abs(got - want) / max(abs(want), floor)


def _leaf_gaps(prog, ref):
    """``{"grad": {name: gap}, "change": {name: gap}}``: each parameter's
    gap of norms, against the larger of the reference's norm of it and of
    the median parameter's; the change over the parameters whose
    reference gradient is not nought to rounding."""
    rg, rc = ref["grad_norms"], ref["change_norms"]
    med_g = statistics.median(rg.values())
    moving = [n for n, v in rg.items() if v >= NOUGHT_SHARE * med_g]
    med_c = statistics.median(rc[n] for n in moving)
    return {"grad": {n: _gap(prog["grad_norms"].get(n, float("inf")), v,
                             med_g) for n, v in rg.items()},
            "change": {n: _gap(prog["change_norms"].get(n, float("inf")),
                               rc[n], med_c) for n in moving}}


def worst_leaves(prog, ref):
    """``{"grad_gap": parameter, "change_gap": parameter}``: the
    parameters that set the worst-leaf numbers."""
    gaps = _leaf_gaps(prog, ref)
    return {"%s_gap" % k: max(v, key=v.get) for k, v in gaps.items()}


def training_numbers(prog, ref):
    """``{number: value}`` of the program's readings ``prog`` against the
    reference's ``ref`` (both as ``reference/_train.train`` returns
    them): ``loss_gap``, the worst parameter's ``grad_gap`` and
    ``change_gap``, and the median parameter's ``grad_gap_median`` and
    ``change_gap_median``."""
    loss_gap = max(_gap(a, b, 1e-30)
                   for a, b in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = float("inf")
    gaps = _leaf_gaps(prog, ref)
    out = {"loss_gap": loss_gap}
    for k, v in gaps.items():
        out["%s_gap" % k] = max(v.values())
        out["%s_gap_median" % k] = statistics.median(v.values())
    return out


def judge(numbers, limits):
    """``(correct, [{name, value, limit}])`` over the numbers ``limits``
    names (the cell's compared numbers): every one at or under its limit.
    A number that is missing or not finite (shown as None) fails, and so
    does a cell with no limit at all."""
    rows = []
    for k, limit in limits.items():
        v = numbers.get(k)
        rows.append({"name": k, "limit": limit,
                     "value": v if v is not None and math.isfinite(v)
                     else None})
    ok = bool(rows) and all(r["value"] is not None
                            and r["value"] <= r["limit"] for r in rows)
    return ok, rows
