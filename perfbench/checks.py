"""The comparisons that decide ``correct``, and the plain training steps
the references follow.

A training cell compares the program's checked steps with the
reference's on the same start and the same rows (``Readings``):

* ``loss_gap``: over the steps whose loss the program reports, the
  largest ``|L_prog - L_ref| / |L_ref|``; ``loss1_gap`` the same of the
  first step alone (its forward, before any update);
* ``grad1_gap``: the first step's gradient as the optimizer got it, by
  the worst leaf: ``| |g_prog| - |g_ref| |`` over the larger of that
  leaf's ``|g_ref|`` and the median leaf's;
* ``change_gap``: the same of each leaf's change ``p_N - p_0`` after the
  steps followed, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf with none moves by round-off
  alone under adam).

Each number has its limit in the cell's file under ``perfbench/limits/``.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from perfbench.precision import dtype_of

# a leaf moves only if its reference gradient is at least this share of
# the median leaf's
MOVING_LEAF_SHARE = 1e-3


@dataclass
class Readings:
    """What one side produced in a training cell's first steps: the loss
    of each step it reports (None where it reports none), the norm of each
    leaf's first gradient, and the norm of each leaf's change after the
    steps followed."""

    losses: List[Optional[float]]
    grad1: List[float]
    change: List[float]


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def _leaf_gap(prog: Sequence[float], ref: Sequence[float],
              keep: Sequence[bool]):
    med = statistics.median(ref)
    worst, at = 0.0, None
    for k, (p, r) in enumerate(zip(prog, ref)):
        if not keep[k]:
            continue
        gap = abs(p - r) / max(r, med) if max(r, med) > 0 else abs(p - r)
        if not math.isfinite(gap):
            gap = math.inf
        if gap > worst or at is None:
            worst, at = gap, k
    return worst, at


def compare_training(prog: Readings, ref: Readings) -> Dict[str, float]:
    """``loss_gap``, ``grad1_gap`` and ``change_gap`` of ``prog`` against
    ``ref`` (a non-finite reading of the program is an infinite gap)."""
    out = {}
    gaps = []
    for p, r in zip(prog.losses, ref.losses):
        if p is None or r is None:
            continue
        g = abs(p - r) / abs(r) if r else abs(p - r)
        gaps.append(g if math.isfinite(g) else math.inf)
    if gaps:
        out["loss1_gap"], out["loss_gap"] = gaps[0], max(gaps)
    out["grad1_gap"] = _leaf_gap(prog.grad1, ref.grad1,
                                 [True] * len(ref.grad1))[0]
    med = statistics.median(ref.grad1)
    moving = [g >= MOVING_LEAF_SHARE * med for g in ref.grad1]
    out["change_gap"] = _leaf_gap(prog.change, ref.change, moving)[0]
    return out


def _adam(hyper):
    b1, b2, eps, lr = (hyper[k] for k in ("b1", "b2", "eps", "lr"))
    state = {"t": 0, "m": None, "v": None}

    def update(leaves, grads):
        if state["m"] is None:
            state["m"] = [torch.zeros_like(p) for p in leaves]
            state["v"] = [torch.zeros_like(p) for p in leaves]
        state["t"] += 1
        t = state["t"]
        for p, g, m, v in zip(leaves, grads, state["m"], state["v"]):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            p.sub_(lr * (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt()
                                              + eps))
    return update


def _sgd(hyper, n_states: int):
    if hyper["kind"] == "dual_sgd":
        rates = (hyper["rate_state"], hyper["rate_param"])
    else:
        rates = (hyper["rate"], hyper["rate"])

    def update(leaves, grads):
        for k, (p, g) in enumerate(zip(leaves, grads)):
            p.sub_(rates[0 if k < n_states else 1] * g)
    return update


def make_update(opt: dict, n_states: int):
    """The plain update ``opt`` names (``perfbench/traffic`` files):
    ``{"kind": "adam", "lr", "b1", "b2", "eps"}``, ``{"kind": "sgd",
    "rate"}`` or ``{"kind": "dual_sgd", "rate_state", "rate_param"}``
    (the first ``n_states`` leaves at the state rate)."""
    if opt["kind"] == "adam":
        return _adam(opt)
    if opt["kind"] in ("sgd", "dual_sgd"):
        return _sgd(opt, n_states)
    raise ValueError(f"no plain update for {opt['kind']!r}")


def first_grad_of(opt: dict, k: int, n_states: int, before, after,
                  adam_m=None) -> torch.Tensor:
    """Leaf ``k``'s first gradient as the optimizer got it, worked out from
    the program's state after one step: adam's first moment over
    ``1 - b1``, or an SGD step's change over its rate."""
    if opt["kind"] == "adam":
        return adam_m.double() / (1 - opt["b1"])
    if opt["kind"] == "dual_sgd":
        rate = opt["rate_state"] if k < n_states else opt["rate_param"]
    else:
        rate = opt["rate"]
    return (before.double() - after.double()) / rate


def reference_steps(ref, cfg, leaves0, batches, opt: dict, prec: str,
                    losses_of: Sequence[int] = ()) -> Readings:
    """Follow the program's steps in the plain reference: from the leaves
    ``leaves0``, one step of ``opt`` on each batch in turn (a batch is
    what ``ref.loss`` takes).  ``losses_of``: the steps (0-based) whose
    loss is read."""
    dt = dtype_of(prec)
    leaves = [p.detach().to(dt).clone().requires_grad_(True)
              for p in leaves0]
    start = [p.detach().clone() for p in leaves]
    update = make_update(opt, ref.n_states(cfg))
    losses, grad1 = [], None
    for k, batch in enumerate(batches):
        L = ref.loss(cfg, leaves, batch, prec)
        grads = torch.autograd.grad(L, leaves)
        if k in losses_of:
            losses.append(float(L.detach()))
        if k == 0:
            grad1 = [_norm(g) for g in grads]
        with torch.no_grad():
            update(leaves, [g.detach() for g in grads])
    change = [_norm(p - s) for p, s in zip(leaves, start)]
    return Readings(losses, grad1, change)


def held(numbers: Dict[str, float], limits: Dict[str, float]):
    """``[(name, value, limit)]`` of every number compared, in the
    limits' order, and whether each is within its limit (a number with
    no reading fails)."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        rows.append((name, math.inf if v is None else float(v), limit))
    return rows, ok
