"""The comparison that decides ``correct``.

Both sides' readings have one structure: the loss and the preds of every
checked step, the first step's gradient norm by leaf, each leaf's change
over the checked steps (its norm), and the first step's AUC bucket
tables (positive and negative counts a prediction bucket). The numbers
read:

- ``loss1_gap``: the first step's relative loss gap;
- ``pred1_gap``: the widest gap of a prediction of the first step;
- ``grad1_gap``: by the worst leaf, the gap between the two sides' norms
  of the first gradient, over the reference's norm of that leaf or of the
  median leaf, whichever is larger. A leaf whose first reference gradient
  is under a thousandth of the median leaf's moves by round-off alone and
  is left out here and below;
- ``embed_grad1_gap``: the same gap of the table's embed_w leaf over its
  own norm (a key's gradient sums its occurrences: a sample left out
  shows there);
- ``change_gap``: by the worst leaf, as ``grad1_gap``, the gap of the
  leaves' change over all the checked steps;
- ``auc1_count_gap``: how many samples the first step's AUC tables count
  as positive, and as negative, other than the reference's (exact);
- ``auc1_hist_gap``: the widest gap, over the buckets and over the two
  classes, between the two sides' cumulative bucket counts, over the
  reference's count of that class: where the AUC state puts the samples.

Later steps and the first step's AUC are recorded beside them: from a
fresh Adam state a step moves every dense weight by about the learning
rate, so the steps after the first amplify rounding, seed by seed
(PERF.md). A cell compares the
numbers its ``bench_port/limits/<cell>.json`` gives a limit, with any
number its loop adds (such as the window's non-finite losses, limit 0);
a number that no control or fault separates from sound runs has no limit
there.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np

from bench_port.reference.common import auc_from_buckets

NUMBERS = ("loss1_gap", "pred1_gap", "grad1_gap", "embed_grad1_gap", "change_gap", "auc1_count_gap",
           "auc1_hist_gap")
NEGLIGIBLE = 1e-3  # of the median leaf's first gradient


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep, median_floor: bool = True) -> Tuple[float, str]:
    """The worst leaf's gap between the two sides' norms, over the
    reference's norm of that leaf or (with ``median_floor``) of the median
    leaf, whichever is larger; and that leaf's name."""
    med = float(np.median([ref[k] for k in keep])) if median_floor else 0.0
    worst, name = 0.0, ""
    for k in keep:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if gap > worst or not name:
            worst, name = gap, k
    return worst, name


def auc_gaps(prog: Tuple[np.ndarray, np.ndarray], ref: Tuple[np.ndarray, np.ndarray]) -> Tuple[float, float]:
    """(``auc1_count_gap``, ``auc1_hist_gap``) of two sides' (positive,
    negative) bucket tables."""
    count = sum(abs(float(p.sum()) - float(r.sum())) for p, r in zip(prog, ref))
    hist = max(float(np.max(np.abs(np.cumsum(p) - np.cumsum(r)))) / max(float(r.sum()), 1.0)
               for p, r in zip(prog, ref))
    return count, hist


def compare(prog: dict, ref: dict) -> Dict[str, object]:
    """The numbers compared, and the leaf each leaf gap comes from."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError(f"{len(prog['losses'])} program steps against {len(ref['losses'])} reference steps")
    g_med = float(np.median(list(ref["grad1"].values())))
    keep = [k for k, v in ref["grad1"].items() if v >= NEGLIGIBLE * g_med]
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
    grad1_gap, grad1_leaf = leaf_gap(prog["grad1"], ref["grad1"], keep)
    # the counters have no gradient: they are held with the leaves that do
    change_keep = keep + [k for k in ref["change"] if k not in ref["grad1"]]
    change_gap, change_leaf = leaf_gap(prog["change"], ref["change"], change_keep)
    auc1_count_gap, auc1_hist_gap = auc_gaps(prog["auc1"], ref["auc1"])
    out = {
        "loss1_gap": rel(prog["losses"][0], ref["losses"][0]),
        "pred1_gap": float(np.max(np.abs(prog["preds"][0] - ref["preds"][0]))),
        "grad1_gap": grad1_gap,
        "embed_grad1_gap": rel(prog["grad1"]["table.embed_w"], ref["grad1"]["table.embed_w"]),
        "change_gap": change_gap,
        "auc1_count_gap": auc1_count_gap,
        "auc1_hist_gap": auc1_hist_gap,
    }
    for n, v in out.items():
        if not np.isfinite(v):
            out[n] = float("inf")
    out["worst_leaves"] = {"grad1": grad1_leaf, "change": change_leaf}
    out["left_out"] = sorted(set(ref["grad1"]) - set(keep))
    out["recorded"] = {  # not compared
        "ref_loss": [float(b) for b in ref["losses"]],
        "loss_gap": [rel(a, b) for a, b in zip(prog["losses"], ref["losses"])],
        "pred_gap": [float(np.max(np.abs(a - b))) for a, b in zip(prog["preds"], ref["preds"])],
        "auc1_gap": abs(auc_from_buckets(*prog["auc1"]) - auc_from_buckets(*ref["auc1"])),
        "grad1_leaf_gap": {k: rel(prog["grad1"][k], ref["grad1"][k]) for k in keep},
    }
    return out


def load_limits(bench_dir: str, cell: str) -> Dict[str, float]:
    """The cell's limits: the numbers it compares, each with its limit."""
    with open(os.path.join(bench_dir, "limits", f"{cell}.json")) as f:
        lim = json.load(f)
    return {n: float(v) for n, v in lim["limits"].items()}


def judge(numbers: Dict[str, object], limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {name: {value, limit}}): every number within its limit.
    A number the run did not produce reads as infinite."""
    shown = {n: {"value": float(numbers.get(n, float("inf"))), "limit": lim} for n, lim in limits.items()}
    return all(v["value"] <= v["limit"] for v in shown.values()), shown
