"""The comparisons that decide ``correct``, and the readings they compare.

Training: the program and the reference each take the same first three
steps from the same state and batches. Compared are the first step's loss
(the later steps' are reported beside it: a (slot, pixel) pair at the
1/255 alpha gate that one side's rounding keeps and the other's drops
turns a zero gradient into a full Adam step, and the steps after carry
it), the norm of each leaf's first gradient as the optimiser got it (the program's
from its Adam first moment after one step), the norm of each leaf's change
over the three steps, and, where an exposure update falls inside them, the
updated exposure scales. Norm gaps are taken by the worst leaf, against the
reference's norm of that leaf or of the median leaf, whichever is larger.
Leaves whose first reference gradient is under a thousandth of the median
leaf's move under Adam by round-off alone and are left out of the change.
After the window, the reference takes the step the program takes next from
a copy of the program's state, at the budgets the window reached; compared
are that step's loss and each leaf's gradient (the program's from its
Adam first moment before and after the step). The budgets of the first
steps are the reference's own (``refmodel.validated_budgets``), and
``budgets_differ`` counts those the program chose differently.

Serving: the worst sampled request's mean absolute pixel difference from
the reference's render of the same camera.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def train_numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers from two sets of readings, each a dict with
    ``losses`` [3], ``grad`` {leaf: norm}, ``change`` {leaf: norm},
    ``expo`` ({view: scale} or None) and, where the reference's has it,
    ``post`` (the step after the window: ``loss``, ``grad`` {leaf: norm})."""
    out = {"loss_gap": loss_gaps(prog, ref)[0], "grad_gap": norm_gap(prog["grad"], ref["grad"])}
    g_med = float(np.median(list(ref["grad"].values())))
    kept = [k for k, v in ref["grad"].items() if v >= 1e-3 * g_med]
    c_med = float(np.median([ref["change"][k] for k in kept]))
    out["change_gap"] = max(abs(prog["change"][k] - ref["change"][k]) / max(ref["change"][k], c_med)
                            for k in kept)
    if ref.get("expo"):
        out["expo_gap"] = max(abs(prog["expo"].get(v, math.inf) - e) / abs(e)
                              for v, e in ref["expo"].items())
    if "post" in ref:
        a, b = prog["post"], ref["post"]
        out["post_loss_gap"] = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        out["post_grad_gap"] = norm_gap(a["grad"], b["grad"])
    return out


def norm_gap(prog: dict, ref: dict) -> float:
    """The worst leaf's gap of norms, against the reference's norm of that
    leaf or of the median leaf, whichever is larger."""
    return max(leaf_gaps(prog, ref).values())


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Each leaf's gap of norms, as ``norm_gap`` takes them."""
    med = float(np.median(list(ref.values())))
    return {k: abs(prog[k] - v) / max(v, med) for k, v in ref.items()}


def worst_leaves(prog: dict, ref: dict) -> dict:
    """The leaf that sets each gradient gap, with its gap and the
    reference's norms of it and of the median leaf."""
    out = {}
    for key, p, r in (("grad_gap", prog["grad"], ref["grad"]),
                      ("post_grad_gap", prog.get("post", {}).get("grad"),
                       ref.get("post", {}).get("grad"))):
        if r:
            gaps = leaf_gaps(p, r)
            k = max(gaps, key=gaps.get)
            out[key] = [k, gaps[k], r[k], float(np.median(list(r.values())))]
    return out


def loss_gaps(prog: dict, ref: dict) -> list:
    """Each step's relative loss gap. Only the first is compared: the
    later steps' losses carry the parameters' divergence of the first
    update (see ``change_gap``), which is no fault."""
    return [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]


def image_gap(prog_imgs, ref_imgs) -> float:
    """The worst request's mean absolute pixel gap. A mean over the image,
    not its largest pixel: a splat whose alpha sits at the 1/255 gate is
    kept by one rounding and dropped by another, which moves a pixel by up
    to ~1e-3 in sound runs as in the TF32 control."""
    return max(float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).mean())
               for a, b in zip(prog_imgs, ref_imgs))


def checks(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}})."""
    out, ok = {}, True
    for k, v in numbers.items():
        lim = limits[k]
        out[k] = {"value": v, "limit": lim}
        ok = ok and math.isfinite(v) and v <= lim
    return ok, out
