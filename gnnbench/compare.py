"""The comparison that decides ``correct`` for a training cell.

Both sides give the readings of the first steps from the same parameters
and batches: each step's loss, each leaf's norm of the first gradient and
each leaf's norm of its change after the first step and after the last.
The numbers:

* ``loss_gap``: the largest ``|loss - ref| / |ref|`` over the steps;
* ``grad_gap``: the largest gap of a leaf's gradient norm from the
  reference's, over the larger of that leaf's reference norm and the
  median leaf's;
* ``change_gap``: the median over the leaves of the same gap of the
  change, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf below that moves under Adam by
  rounding alone).  The median, not the worst leaf: a leaf can hold
  elements whose gradient is nought to rounding while the leaf's is not
  (the sender half of the attention vector ``a`` wherever every logit of a
  sender's row lies on one side of the leaky relu's kink, where the
  softmax cannot see it), and Adam moves those elements by the step size
  on rounding alone.  The worst leaf's gap is kept as
  ``change_gap_worst`` and not compared; ``grad_leaf`` and
  ``change_leaf`` name the worst leaves;
* ``grad_gap_median``, ``first_change_gap``: the median leaf's gradient
  gap, and ``change_gap`` of the change after the first step.  A leaf
  whose first gradient is a sum of terms that cancel (an output bias at
  initialisation: terms near +-0.5) is read by float32 to a few 1e-7 at
  best; where that lies within Adam's epsilon of nought, or crosses it,
  the two sides move the leaf apart at the first step, and every later
  loss and change follows; as the worst leaf it reads up to about 0.04
  of the median leaf's norm.  These two depend on the first step alone,
  and on no single leaf.

A cell compares the numbers its configuration gives limits for.

A number that is not finite fails.
"""

from __future__ import annotations

import math
from statistics import median
from typing import Dict

GRAD_FLOOR = 1e-3


def _gap(a: float, b: float, scale: float) -> float:
    v = abs(a - b) / max(scale, 1e-300)
    return v if math.isfinite(v) else math.inf


def _leaf_gaps(got: Dict[str, float], ref: Dict[str, float], keys):
    keys = list(keys)
    scale = median(ref[k] for k in keys)
    return [_gap(got[k], ref[k], max(ref[k], scale)) for k in keys]


def numbers(got: Dict, ref: Dict) -> Dict[str, float]:
    loss_gap = max(_gap(a, b, abs(b))
                   for a, b in zip(got["losses"], ref["losses"]))
    if len(got["losses"]) != len(ref["losses"]):
        loss_gap = math.inf
    g_ref = ref["grad_norms"]
    g_med = median(g_ref.values())
    moved = [k for k in g_ref if g_ref[k] >= GRAD_FLOOR * g_med]
    grad = _leaf_gaps(got["grad_norms"], g_ref, g_ref)
    change = _leaf_gaps(got["change_norms"], ref["change_norms"], moved)
    first = _leaf_gaps(got["first_change_norms"], ref["first_change_norms"],
                       moved)
    return {"loss_gap": loss_gap,
            "grad_gap": max(grad),
            "grad_gap_median": median(grad),
            "change_gap": median(change),
            "change_gap_worst": max(change),
            "first_change_gap": median(first),
            "grad_leaf": list(g_ref)[grad.index(max(grad))],
            "change_leaf": moved[change.index(max(change))]}


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number a cell compares (the keys of its ``limits``) within its
    limit."""
    return all(math.isfinite(nums[k]) and nums[k] <= v
               for k, v in limits.items())
