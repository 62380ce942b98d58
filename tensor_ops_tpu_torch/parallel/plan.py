"""Mesh planning: which ``(dp, pp, tp)`` factorization should this model
train on?  The counterpart of ``tensor_ops_tpu/parallel/plan.py``.

This module enumerates every feasible ``(data, stage, model)``
factorization of a device count for a concrete Network and batch size and
scores each with the analytic quantities the rest of the package exposes:
per-device FLOPs (``ir_pipeline._op_flops``), the pipeline bubble and the
stage balance (``ir_pipeline._balanced_partition``, the partitioner's own
cut), and per-device training-state memory (parameters, gradients and
``optim.moment_footprint``'s moments, with the stage, model and ZeRO
sharding ``fit`` applies), so the operator's comparison is one call:
``plan_meshes(net, 8, batch_size=4096)``.

Scores are analytic, not measured: they rank configurations by arithmetic
intensity and schedule overhead, and ignore the collectives' latency, which
depends on the interconnect.  Measure the top candidates on the cards with
``utils.profiling.profile_step`` / ``utils.profiling.memory_analysis``
before committing hardware (``examples/plan_and_budget.py`` walks the
three); the planner's job is to shrink the search space, stating what it
ignores.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..models.feedforward import Network

__all__ = ["plan_meshes", "describe_plans"]


def _factorizations(n: int):
    """All (dp, pp, tp) with dp*pp*tp == n, each >= 1."""
    out = []
    for pp in range(1, n + 1):
        if n % pp:
            continue
        rest = n // pp
        for tp in range(1, rest + 1):
            if rest % tp:
                continue
            out.append((rest // tp, pp, tp))
    return out


def _itemsize(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.element_size()
    return np.dtype(np.asarray(x).dtype).itemsize


def _tp_shardable(segs, tp: int) -> bool:
    from .ir_pipeline import _tp_local_segment_split

    return all(_tp_local_segment_split(op, tp) is not None for op, _ in segs)


def plan_meshes(net: Network, n_devices: int, batch_size: int,
                optimizer=None, microbatches: int = 4,
                shard_opt_state: bool = False,
                zero_stage: Optional[int] = None,
                dtype_bytes: Optional[int] = None) -> List[dict]:
    """Rank every feasible ``(dp, pp, tp)`` mesh for training ``net`` with
    ``fit(mesh=...)``: dicts sorted by ``analytic_cost`` (lower is better),
    each carrying the mesh shape, feasibility notes, per-device FLOPs a
    step, the bubble fraction and stage balance of pipeline configs, and
    per-device training-state bytes (params + grads + moments, with the
    stage, model and ZeRO sharding applied).

    Feasibility follows ``fit``'s own checks and sharding rules: the batch
    must split over dp (and over the microbatch grid under pp); pp needs at
    least S composition segments.  tp follows the route the config would
    take: under pp the pipeline partitioners' all-or-nothing row split
    (``_tp_local_segment_split``), without pp ``param_specs``' per-weight
    rule (either dimension divisible shards); replicated weights are
    flagged in ``notes``, a wholly idle model axis as ``tp_idle``."""
    from ..models.optim import moment_footprint
    from .ir_pipeline import (_balanced_partition, _op_flops,
                              network_segments)

    if zero_stage is None:
        zero_stage = 1 if shard_opt_state else 0
    shard_opt_state = shard_opt_state or zero_stage >= 1
    segs = network_segments(net)
    per_seg = [_op_flops(op) for op, _ in segs]
    n_seg = len(per_seg)
    # each segment's rank-2 weight (the shardable tensor) and param count
    seg_w = []
    seg_nparam = []
    for op, _ in segs:
        w2 = [s for s in op.in_stack[1:] if len(s) == 2]
        seg_w.append(w2[0] if w2 else None)
        seg_nparam.append(sum(int(np.prod(s, dtype=np.int64)) if s else 1
                              for s in op.in_stack[1:]))
    if dtype_bytes is None:
        dtype_bytes = _itemsize(net.params[0])
    moment_b_per_elem = moment_footprint(optimizer, dtype_bytes)

    plans = []
    for dp, pp, tp in _factorizations(n_devices):
        notes = []
        M = microbatches if pp > 1 else 1
        if batch_size % (dp * M):
            continue  # fit would refuse: the batch cannot grid over dp x M
        if pp > 1 and M < pp:
            notes.append(f"needs microbatches >= {pp} for the circular "
                         f"schedule (GPipe still runs)")
        if pp > n_seg:
            continue  # not enough composition segments to cut
        # per-segment tp division, on the route this config would take
        if tp > 1 and pp > 1:
            # the pipeline partitioners: all-or-nothing row split
            eng = _tp_shardable(segs, tp)
            seg_div = [tp if eng else 1] * n_seg
            if not eng:
                notes.append("tp_idle: a segment doesn't row-shard at "
                             "this width — weights replicate (loud "
                             "warning path)")
        elif tp > 1:
            # fit's tp without a stage axis: param_specs shards each weight
            # on EITHER divisible dim, replicating only no-dim weights
            seg_div = [tp if (w is not None
                              and (w[0] % tp == 0 or w[1] % tp == 0))
                       else 1 for w in seg_w]
            n_repl = sum(1 for d in seg_div if d == 1)
            if all(d == 1 for d in seg_div):
                notes.append("tp_idle: no weight has a tp-divisible "
                             "dim — all replicate (loud warning path)")
            elif n_repl:
                notes.append(f"tp_partial: {n_repl}/{n_seg} segment "
                             f"weight(s) have no tp-divisible dim and "
                             f"replicate")
        else:
            seg_div = [1] * n_seg
        tp_engaged = tp == 1 or any(d > 1 for d in seg_div)
        per_seg_eff = [f / d for f, d in zip(per_seg, seg_div)]

        # per-device compute: the partitioner's min-max cut over the raw
        # per-segment FLOPs; the slowest stage's tp-divided FLOPs set the
        # clock
        if pp > 1:
            bounds = _balanced_partition(per_seg, pp)
            stage_raw = [sum(per_seg[a:b]) for a, b in bounds]
            balance = max(stage_raw) / (sum(stage_raw) / pp)
            bubble = (pp - 1) / (M + pp - 1)
            clock = max(sum(per_seg_eff[a:b]) for a, b in bounds)
        else:
            balance, bubble = 1.0, 0.0
            clock = sum(per_seg_eff)
        flops_dev = clock * (batch_size / dp)
        cost = flops_dev / (1.0 - bubble)

        # per-device training state: each segment's params split over its
        # tp divisor, everything over the pp stages; moments (ZeRO-1),
        # gradients (2) and params (3) also over dp
        p_full = sum(npar * dtype_bytes / d
                     for npar, d in zip(seg_nparam, seg_div)) / pp
        m_dev = (moment_b_per_elem / dtype_bytes
                 * p_full / (dp if (shard_opt_state and dp > 1) else 1))
        g_dev = p_full / (dp if (zero_stage >= 2 and dp > 1) else 1)
        p_dev = p_full / (dp if (zero_stage >= 3 and dp > 1) else 1)
        if zero_stage >= 3 and dp > 1:
            notes.append("zero3: params AND grads AND moments /dp "
                         "(gather-at-use; exact accounting in "
                         "training_memory_report)")
        elif zero_stage >= 2 and dp > 1:
            notes.append("zero2: moments AND grads /dp (reduce-scatter; "
                         "exact accounting in training_memory_report)")
        elif shard_opt_state and dp > 1:
            notes.append("zero1: moments /dp (first free divisible dim; "
                         "exact accounting in training_memory_report)")
        mem_dev = p_dev + g_dev + m_dev  # params + grads + moments
        plans.append({
            "mesh_shape": {"data": dp, "stage": pp, "model": tp},
            "flops_per_device": flops_dev,
            "bubble_fraction": bubble,
            "stage_balance": balance,
            "analytic_cost": cost,
            "training_state_bytes_per_device": int(mem_dev),
            "tp_engaged": tp_engaged,
            "notes": notes,
        })

    # ties on analytic cost break toward less communication: tp gathers per
    # layer per microbatch, pp hands off per tick, dp reduces once a step;
    # memory breaks what is left
    def _key(p):
        m = p["mesh_shape"]
        comm = (2 * (m["model"] > 1 and p["tp_engaged"])
                + (m["stage"] > 1))
        return (p["analytic_cost"], comm,
                p["training_state_bytes_per_device"])

    plans.sort(key=_key)
    return plans


def describe_plans(plans: List[dict], top: int = 8) -> str:
    """``plan_meshes``' output as the operator's table."""
    lines = ["mesh (dp,pp,tp)  cost(flops/dev)  bubble  balance  "
             "state/dev  notes"]
    for p in plans[:top]:
        m = p["mesh_shape"]
        lines.append(
            f"({m['data']},{m['stage']},{m['model']})".ljust(17)
            + f"{p['flops_per_device']:.3e}".ljust(17)
            + f"{p['bubble_fraction']:.2f}".ljust(8)
            + f"{p['stage_balance']:.2f}".ljust(9)
            + f"{p['training_state_bytes_per_device']:>9d}  "
            + ("; ".join(p["notes"]) or "-"))
    if len(plans) > top:
        lines.append(f"... {len(plans) - top} more")
    return "\n".join(lines)
