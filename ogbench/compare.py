"""The comparison that decides `correct` for a training cell.

The first `check_steps` steps of the run (the window's own call, on the
trainer that the window then drives) are followed by the plain reference
(ogbench/reference.py) from the same start. Three numbers are compared, each
against its own limit (ogbench/limits/<cell>.json):

  * loss_gap: the largest |loss_program - loss_reference| / |loss_reference|
    over the steps;
  * grad_gap: the first step's gradient, as the optimizer got it (the
    program's, from its first moment after one step: m1 = 0.9 m0 + 0.1 g),
    by the worst leaf: |norm_program - norm_reference| over the larger of
    the reference's norm of that leaf and the median leaf's;
  * change_gap: the same for each leaf's change over the steps.

Leaves whose reference gradient is nought to rounding (under a thousandth
of the median of the leaves with a gradient, zero included) are left out of
both: a frozen leaf, or ins_feat in stage 0, moves by round-off alone.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NAMES = ("loss_gap", "grad_gap", "change_gap")


def _norm(x) -> float:
    x = x.detach().to("cpu", torch.float64) if isinstance(x, torch.Tensor) else \
        torch.as_tensor(np.asarray(x), dtype=torch.float64)
    return float(torch.linalg.vector_norm(x))


def leaves_compared(ref_grads: dict) -> tuple[list[str], float]:
    norms = {k: _norm(v) for k, v in ref_grads.items()}
    nonzero = [v for v in norms.values() if v > 0]
    med = float(np.median(nonzero)) if nonzero else 0.0
    return [k for k, v in norms.items() if v > 0 and v >= 1e-3 * med], med


def worst_gap(prog: dict, ref: dict, keys: list[str]) -> tuple[float, str]:
    pn = {k: _norm(prog[k]) for k in keys}
    rn = {k: _norm(ref[k]) for k in keys}
    med = float(np.median(list(rn.values())))
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], med) if max(rn[k], med) > 0 else math.inf
            for k in keys}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def gaps(prog: dict, ref: dict, start: dict) -> dict:
    """prog: {"losses", "first_grads", "params"} of the program after the
    steps; ref: reference.run_steps' result from the same start; start: the
    start's parameters. -> {name: value} with "grad_leaf" and "change_leaf"
    (the worst leaves) beside them."""
    keys, _ = leaves_compared(ref["first_grads"])
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    g, g_leaf = worst_gap(prog["first_grads"], ref["first_grads"], keys)

    def change(params):
        return {k: params[k].detach().cpu() - start[k].detach().cpu() for k in keys}

    c, c_leaf = worst_gap(change(prog["params"]), change(ref["params"]), keys)
    return dict(loss_gap=loss, grad_gap=g, change_gap=c, grad_leaf=g_leaf,
                change_leaf=c_leaf, leaves=keys)


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """-> (every number within its limit, {name: {"value", "limit"}})."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NAMES}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
