"""The production training loops, ``fit`` and ``fit_sequences``: the loop
the reference never had (its training is an inline ``foldl'`` over samples
with printf reporting, ``app/MNIST.hs:390-396``, and its recurrent nets
are hand-looped one sequence at a time, ``Recurrent.hs:326-354``).

Composes the staged-IR networks, the native threaded batch loader (or, for
sequences, :class:`_SeqStream`), an optimizer, JSONL metrics, validation
with early stopping, periodic asynchronous checkpoints with exact resume,
a Polyak average (``ema_decay``), gradient accumulation (``accum_steps``)
and the Ctrl-C checkpoint.  A ``fit`` step is the per-sample graph's
transposition-AD gradient mapped over the batch
(``training.make_mean_grads``), its batch mean, the optional global-norm
clip and ``opt.update``; a ``fit_sequences`` step is the same over the
scan-BPTT sequence graph (``training.make_seq_mean_grads``) with the
reference's dual state/param rates.  On the NumPy oracle the samples are
looped, as the JAX package does.

``mixed_precision`` runs the forward and backward in bf16 on f32 masters
(``fit`` through the batched graph of ``models/batched.py`` where it
applies); ``True`` measures the f32 and the bf16 step once and keeps the
faster (:func:`_resolve_mp_route`).  ``chain_steps`` runs each window of
steps between observation boundaries over the dataset resident on the
device (``models/chain.py``): on the card one CUDA graph of one step,
replayed once per step; ``chain_shuffle`` takes the host loader's indices
or computes them on the device (:func:`_device_window_indices`).

Both loops run on :func:`_drive`, the window driver: windows of steps, log
boundary, validation, early stop, checkpoints and the Ctrl-C checkpoint,
independent of what a step computes.

``mesh`` (``parallel.make_mesh``, a ``(data, model)`` grid) trains on both
axes: :func:`_mesh_setup` places the leaves by ``param_specs`` and climbs
the ZeRO ladder (``shard_opt_state`` / ``zero_stage``), and
:func:`_mesh_step` splits each batch over the data ranks, runs each data
rank's rows on its model group (``parallel.tp``'s executor when the model
axis is larger than 1), and reduces and gathers through kernel 9's
collectives; ``offload_opt_state`` keeps the optimizer state in pinned
host memory between steps.  A mesh with a ``stage`` axis trains
pipeline-parallel over the staged IR (``parallel.ir_pipeline``: the
partition's leaves on the stage axis, and on a ``(data, stage, model)``
mesh row-split over the model axis too, each data group's microbatches
through the schedule, the same ZeRO ladder and step).  A mesh or an
offloaded state runs unchained.  In several processes
(``parallel.distributed``) the mesh spans them: each process loads its
shard of every batch (a stage-only mesh: the whole stream), and process 0
writes the checkpoints, which every process resumes from.
``profile_dir`` (item 8) raises ``ValueError`` naming its ROADMAP item.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..backend.base import Backend
from ..ops import ir
from ..ops.ir import TOp
from ..utils.metrics import MetricsLogger
from ..utils.native import DevicePrefetcher, NativeLoader
from . import chain as C
from .feedforward import Network
from .optim import Optimizer, clip_by_global_norm, sgd
from .recurrent import RecurrentNetwork, dual_rate_sgd
from .training import (accuracy, batch_loss, make_mean_grads,
                       make_seq_mean_grads, make_vmapped_grads,
                       seq_batch_loss)


@dataclass
class FitResult:
    net: Network
    history: list
    steps: int
    ema_net: Optional[Network] = None  # Polyak average (ema_decay=...)


@dataclass
class FitSeqResult:
    net: RecurrentNetwork
    history: list
    steps: int
    ema_net: Optional[RecurrentNetwork] = None  # Polyak average


class _CheckpointWrites:
    """Bounded async checkpoint-write tracker.

    Writes run on the checkpoint module's one-worker pool (files never
    interleave); ``add`` joins the oldest futures once more than two
    checkpoint boundaries are in flight, surfacing write errors promptly;
    ``join`` drains everything and RETURNS the first error, which the
    caller raises only when no exception is already unwinding."""

    def __init__(self):
        self._futures = []

    def add(self, *futures) -> None:
        self._futures.extend(futures)
        while len(self._futures) > 4:
            self._futures.pop(0).result()

    def join(self) -> Optional[Exception]:
        err = None
        for f in self._futures:
            try:
                f.result()
            except Exception as e:  # noqa: BLE001 — returned to caller
                err = err or e
        self._futures = []
        return err


def _accum(vag: Callable, xb, yb, accum_steps: int):
    """Gradient accumulation (the JAX package's ``_accum_scan``): split the
    batch into ``accum_steps`` equal chunks (a ragged remainder is
    dropped, as there; ``fit`` validates divisibility), sum the chunks'
    ``vag(x_chunk, y_chunk) -> (mean loss, mean grads)`` in order and
    divide the sums by the chunk count: the batch mean for equal chunks."""
    micro = xb.shape[0] // accum_steps
    vsum, gsum = vag(xb[:micro], yb[:micro])
    for i in range(1, accum_steps):
        v, gs = vag(xb[i * micro:(i + 1) * micro],
                    yb[i * micro:(i + 1) * micro])
        vsum = vsum + v
        gsum = tuple(a + g for a, g in zip(gsum, gs))
    return vsum / accum_steps, tuple(g / accum_steps for g in gsum)


def _normalize_mp(mixed_precision) -> str:
    """``'off' | 'auto' | 'bf16'`` from the ``mixed_precision`` knob (the
    JAX package's).  ``True`` (or ``"auto"``) measures the f32 and the bf16
    step once and keeps the faster (:func:`_resolve_mp_route`): a "go
    faster" switch must never go slower.  ``"bf16"`` forces the bf16 path.
    Other truthy or falsy values (ints, numpy bools) keep their truthiness;
    an unknown string raises."""
    if mixed_precision is False or mixed_precision is None:
        return "off"
    if mixed_precision is True or mixed_precision == "auto":
        return "auto"
    if mixed_precision == "bf16":
        return "bf16"
    if not isinstance(mixed_precision, str):
        return "auto" if mixed_precision else "off"
    raise ValueError(
        f"mixed_precision must be False, True/'auto' (measure f32 vs "
        f"bf16 once and take the faster), or 'bf16' (force the bf16 "
        f"path), got {mixed_precision!r}")


def _measure_mp_route(step_f32, step_bf16, args, carry_from: int = 3,
                      rounds: int = 3, steps: int = 20, graphs: bool = True):
    """``(f32_us, bf16_us)``: the device time of one step of each compiled
    route on the same ``args``, the training state ``args[carry_from:]``
    carried from step to step so no step repeats another's work.  On the
    card each route is captured in a CUDA graph that updates its own copy
    of the state, and ``steps`` replays are timed by CUDA events, the two
    routes in turns, the minimum of ``rounds``; elsewhere the same loops
    on the host clock.  ``graphs=False`` (a mesh step, an offloaded state:
    the loop runs them eagerly) times the eager steps as the loop runs
    them, on the host clock between two synchronises."""
    head, carry0 = tuple(args[:carry_from]), tuple(args[carry_from:])
    if not graphs:
        return _measure_eager(step_f32, step_bf16, head, carry0, rounds,
                              steps)
    leaves0 = C.flatten(carry0)
    dev = next((x.device for x in leaves0 if isinstance(x, torch.Tensor)),
               torch.device("cpu"))
    runs = []
    for step in (step_f32, step_bf16):
        bufs = [x.clone() for x in leaves0]

        def once(commit=True, step=step, bufs=bufs):
            out = step(*head, *C.unflatten(carry0, bufs))
            if commit:
                for b, n in zip(bufs, C.flatten(out[1:])):
                    b.copy_(n)

        if C.uses_graphs(dev):
            runs.append(C.capture(once, dev).replay)
        else:
            runs.append(once)
    best = [float("inf"), float("inf")]
    for _ in range(rounds):
        for i, run in enumerate(runs):
            run()  # the state carried in, the caches warm
            if C.uses_graphs(dev):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(steps):
                    run()
                e1.record()
                e1.synchronize()
                us = e0.elapsed_time(e1) * 1e3 / steps
            else:
                t0 = time.perf_counter()
                for _ in range(steps):
                    run()
                us = (time.perf_counter() - t0) * 1e6 / steps
            best[i] = min(best[i], us)
    return best[0], best[1]


def _measure_eager(step_f32, step_bf16, head, carry0, rounds: int,
                   steps: int):
    """:func:`_measure_mp_route` of steps that run eagerly: each route
    carries its own state from call to call; ``steps`` calls between two
    synchronises of every card, the routes in turns, the minimum of
    ``rounds``."""
    from ..parallel.mesh import Sharded

    devices = [t.device for x in C.flatten(carry0)
               for t in (x.shards if isinstance(x, Sharded) else (x,))
               if isinstance(t, torch.Tensor)]

    def sync():
        _sync_cards(devices)

    carries = [carry0, carry0]
    best = [float("inf"), float("inf")]
    for _ in range(rounds):
        for i, step in enumerate((step_f32, step_bf16)):
            carries[i] = tuple(step(*head, *carries[i])[1:])  # caches warm
            sync()
            t0 = time.perf_counter()
            for _ in range(steps):
                carries[i] = tuple(step(*head, *carries[i])[1:])
            sync()
            best[i] = min(best[i], (time.perf_counter() - t0) * 1e6 / steps)
    return best[0], best[1]


def _decide_mp_route(build_step, make_args, carry_from: int = 3,
                     graphs: bool = True):
    """Measure-once routing for ``mixed_precision=True``: build both steps,
    time them on a dummy batch (:func:`_measure_mp_route`) and keep bf16
    only when it is more than 3% faster (near-ties stay on f32, so
    repeated runs of one configuration do not flip routes on timing
    noise).  Under several processes every process measures the same
    global step, but process 0's verdict is broadcast (the JAX package's
    rule): per-process verdicts could differ on a near-tie, and processes
    running different steps would wait on each other's collectives for
    ever.  Returns ``(use_bf16, {"mp_f32_us", "mp_bf16_us"})``."""
    from ..parallel.distributed import broadcast_object, process_count

    f32_us, bf16_us = _measure_mp_route(build_step(False), build_step(True),
                                        make_args(), carry_from=carry_from,
                                        graphs=graphs)
    use_bf16 = bf16_us < 0.97 * f32_us
    if process_count() > 1:
        use_bf16 = bool(broadcast_object(use_bf16, src=0))
    return use_bf16, {"mp_f32_us": round(f32_us, 2),
                      "mp_bf16_us": round(bf16_us, 2)}


def _resolve_mp_route(net, build_step, dummy_args, route_key, *, resume,
                      state_path, carry_from, verbose, graphs: bool = True):
    """The routing ladder both loops share (the JAX package's): the route
    recorded in the checkpoint being resumed (the resumed chain re-takes
    the saving run's numerics exactly) > a resumed checkpoint with no
    ``mp_route`` (saved where ``mixed_precision=True`` forced bf16) adopts
    bf16 with a warning > the measurement cached in-process on the network
    op > measure both steps now.  Returns ``(mp_active, mp_rec)``."""
    mp_rec = None
    stored = legacy = None
    if resume and state_path and os.path.exists(state_path):
        from ..utils.checkpoint import load_meta

        stored = load_meta(state_path).get("mp_route")
        legacy = stored is None
    if stored in ("f32", "bf16"):
        mp_active = stored == "bf16"
        mp_src = f"route recorded in {state_path}"
    elif legacy:
        warnings.warn(
            f"resuming {state_path} which records no mp_route (saved "
            "by a pre-auto-routing build, where mixed_precision=True "
            "forced bf16) — adopting bf16 to preserve the saving "
            "run's numerics; pass mixed_precision='bf16' or False to "
            "choose explicitly", stacklevel=3)
        mp_active = True
        mp_src = "legacy checkpoint (no recorded route): bf16 adopted"
    elif net.op._compiled.get(route_key) is not None:
        mp_active, mp_rec = net.op._compiled.get(route_key)
        mp_src = (f"cached measurement: f32 {mp_rec['mp_f32_us']}us "
                  f"vs bf16 {mp_rec['mp_bf16_us']}us")
    else:
        mp_active, mp_rec = _decide_mp_route(build_step, dummy_args,
                                             carry_from=carry_from,
                                             graphs=graphs)
        net.op._compiled[route_key] = (mp_active, mp_rec)
        mp_src = (f"measured f32 {mp_rec['mp_f32_us']}us vs "
                  f"bf16 {mp_rec['mp_bf16_us']}us")
    if verbose:
        print(f"mixed_precision auto-routed to "
              f"{'bf16' if mp_active else 'f32'} ({mp_src})")
    return mp_active, mp_rec


# sibling streams of one seed: each epoch's rows ("device"), each epoch's
# slot order and the once-per-run rows ("device_fixed")
_ROW_SALT, _SLOT_SALT, _FIXED_SALT = 0x524F57, 0x534C4F54, 0x464958


def _epoch_perm(seed: int, salt: int, epoch: int, n: int, device):
    """A permutation of ``n`` drawn on ``device`` by a ``torch.Generator``
    seeded from (salt, seed, epoch) alone: a pure function of its
    arguments, so any window and any resumed run draws it again."""
    word = np.random.SeedSequence((salt, int(seed), int(epoch)))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(word.generate_state(1, np.uint64)[0]) >> 1)
    return torch.randperm(n, generator=gen, device=device)


def _device_window_indices(seed: int, n_rows: int, batch: int, spe: int,
                           step0: int, k: int, device="cpu"):
    """``(k, batch)`` int64 row indices on ``device`` for global steps
    ``step0 .. step0+k-1`` (``chain_shuffle="device"``): epoch ``e``'s
    batches are consecutive ``batch``-sized slices of its permutation
    (:func:`_epoch_perm`), so every epoch visits every row once.  A pure
    function of (seed, absolute step): every window partition and every
    crash/resume chain replays the same batches, and no index byte comes
    from the host.  The JAX package draws its permutations from threefry;
    these are torch's, held by the same properties, not by equal bits.
    Requires ``n_rows % batch == 0`` (``spe = n_rows // batch``)."""
    e0 = step0 // spe
    E = (k - 1) // spe + 2  # the most epochs k steps can touch
    perms = torch.stack([_epoch_perm(seed, _ROW_SALT, e0 + j, n_rows, device)
                         for j in range(E)])
    s = torch.arange(step0, step0 + k, device=device)
    cols = (s % spe * batch).unsqueeze(1) + torch.arange(batch,
                                                         device=device)
    return perms[(s // spe - e0).unsqueeze(1), cols]


def _device_window_offsets(seed: int, batch: int, spe: int, step0: int,
                           k: int, device="cpu"):
    """``(k,)`` int64 row offsets into the once-shuffled resident dataset
    for global steps ``step0 .. step0+k-1`` (``chain_shuffle=
    "device_fixed"``): epoch ``e`` visits the ``spe`` fixed batch slots in
    the order of its slot permutation, a sibling stream of
    :func:`_device_fixed_perm`'s; step ``s`` reads ``batch`` consecutive
    rows from ``slot * batch``.  The same purity as
    :func:`_device_window_indices`."""
    e0 = step0 // spe
    E = (k - 1) // spe + 2
    sperm = torch.stack([_epoch_perm(seed, _SLOT_SALT, e0 + j, spe, device)
                         for j in range(E)])
    s = torch.arange(step0, step0 + k, device=device)
    return sperm[s // spe - e0, s % spe] * batch


def _device_fixed_perm(seed: int, n_rows: int, device="cpu"):
    """The once-per-run row permutation ``chain_shuffle="device_fixed"``
    applies to the resident dataset before training."""
    return _epoch_perm(seed, _FIXED_SALT, 0, n_rows, device)


def _window_rows(chain_spec, step0: int, k: int, device):
    """The ``(k, batch)`` row table of a device-shuffled window from the
    absolute step ``step0``, ``chain_spec=(n_rows, batch, spe, seed,
    mode)`` (``mode="fixed"``: each step's consecutive rows from its
    offset into the once-shuffled dataset)."""
    n_rows, batch, spe, seed, mode = chain_spec
    if mode == "fixed":
        offs = _device_window_offsets(seed, batch, spe, step0, k, device)
        return offs.unsqueeze(1) + torch.arange(batch, device=device)
    return _device_window_indices(seed, n_rows, batch, spe, step0, k, device)


def _scalars(xs, like):
    """A step's step-varying scalars ``xs`` (a sequence of floats) as one
    tensor in ``like``'s dtype on its device, rounded from float64 as a
    chained window's table is, and copied to the card from pinned memory:
    the host does not wait for the card (it unpacks into 0-d views).  On
    the NumPy oracle ``xs`` itself."""
    if not isinstance(like, torch.Tensor):
        return xs
    t = torch.tensor(xs, dtype=torch.float64).to(like.dtype)
    if like.device.type == "cpu":
        return t
    return t.pin_memory().to(like.device, non_blocking=True)


# the optimizers whose state is step counters and moments of their leaves'
# shapes, in leaf order, and whose update is elementwise: each rank updates
# its shards alone (ZeRO's shard-local update)
_ELEMENTWISE = ("sgd", "momentum", "adam", "adamw")


def _moment_slots(state_leaves, leaves) -> Optional[list]:
    """For each flattened optimizer-state leaf, the index of the training
    leaf whose moment it is (moments come in groups of the leaves' shapes,
    in leaf order), or None for a step counter; ``None`` when an array
    leaf does not fit that pattern."""
    slots, cursor, n = [], 0, len(leaves)
    for x in state_leaves:
        shape = tuple(getattr(x, "shape", ()))
        if not shape:
            slots.append(None)
        elif n and shape == tuple(leaves[cursor % n].shape):
            slots.append(cursor % n)
            cursor += 1
        else:
            return None
    return slots


def _mesh_opt_init(opt: Optimizer, placed, resident, mesh):
    """The optimizer state of ``placed`` (:class:`Sharded` leaves on their
    ``param_specs``, replicated over the data axis) on the mesh: for an
    elementwise optimizer ``opt.init`` of each rank's blocks, every moment
    on its leaf's ``resident`` spec (the JAX package's moments inherit
    their params' shardings); for any other (``adam8bit``, whose blocks
    ravel the whole leaf) ``opt.init`` of the whole leaves, gathered over
    the model axis, on every rank.  Every other state leaf is replicated."""
    from ..parallel.mesh import Sharded, _tree_leaves, _tree_unflatten, reshard

    elementwise = opt.name in _ELEMENTWISE
    if not elementwise:
        placed = [reshard(x, (None,) * x.ndim) for x in placed]
    per_rank = {r: opt.init(tuple(x.shards[r] for x in placed))
                for r in mesh.local_ranks}
    flat = {r: _tree_leaves(st) for r, st in per_rank.items()}
    f0 = flat[mesh.local_ranks[0]]
    slots = (_moment_slots(f0, [x.local for x in placed])
             if elementwise else None) or [None] * len(f0)
    out = []
    for j, slot in enumerate(slots):
        shards = [flat[r][j] if r in flat else mesh.remote(r)
                  for r in range(mesh.size)]
        if slot is None:
            out.append(Sharded((), shards, mesh))
        else:
            out.append(reshard(Sharded(placed[slot].spec, shards, mesh,
                                       placed[slot].shape),
                               resident[slot].spec, own=True))
    return _tree_unflatten(per_rank[mesh.local_ranks[0]], out)


def _clip_mesh(grads, max_norm: float):
    """:func:`clip_by_global_norm` over :class:`Sharded` gradients: with
    every gradient whole on every rank, that function on each rank's
    copies.  Otherwise each rank's squared sums of its blocks are reduced
    over the axes that shard them (kernel 9, one all-reduce per group):
    over each data group the sums of the leaves on the data axis (and,
    apart, of those on both it and another axis), then over each group of
    the other axes (the model axis, or the stage axis) the sums of the
    leaves on those axes alone plus the data groups' sums of those on
    both, each block there from the first rank of the group that holds it
    (a leaf of a 3-D mesh may lie on the stage axis and whole over the
    model axis); each rank adds the whole gradients' sums, so every block
    counts once however many ranks hold it."""
    from ..parallel.mesh import (DATA_AXIS, Sharded, _local_groups,
                                 ring_all_reduce_bidir)

    mesh = grads[0].mesh
    n = len(grads[0].shards)
    mine = mesh.local_ranks
    inner = tuple(a for a in mesh.axis_names if a != DATA_AXIS)

    def kind(g):
        return g.dim is not None, any(a in g.spec and mesh.shape[a] > 1
                                      for a in inner)

    def holds(g, r):
        # rank r is the first of its inner group to hold its block of g
        return all(mesh.coord(r, a) == 0 for a in inner if a not in g.spec)

    kinds = {kind(g) for g in grads}
    if kinds == {(False, False)}:
        per_rank = {r: clip_by_global_norm(tuple(g.shards[r] for g in grads),
                                           max_norm) for r in mine}
    else:
        def sq(r, k):
            x = grads[0].shards[r]
            part = torch.zeros((), dtype=x.dtype, device=x.device)
            for g in grads:
                if kind(g) == k and (not k[1] or holds(g, r)):
                    part = part + (g.shards[r] * g.shards[r]).sum()
            return part

        def each(group, part):
            return [part(r) if mesh.is_local(r) else mesh.remote(r)
                    for r in group]

        both = (True, True) in kinds
        data = model = None
        if (True, False) in kinds or both:
            data = [None] * n
            for group in _local_groups(mesh, DATA_AXIS):
                parts = each(group, lambda r: torch.stack(
                    [sq(r, (True, False))] + [sq(r, (True, True))] * both))
                for r, y in zip(group, ring_all_reduce_bidir(parts)):
                    data[r] = y
        if (False, True) in kinds or both:
            model = [None] * n
            for group in _local_groups(mesh, inner):
                parts = each(group, lambda r: (
                    sq(r, (False, True))
                    + (data[r][1] if both else 0.0)).reshape(1))
                for r, y in zip(group, ring_all_reduce_bidir(parts)):
                    model[r] = y
        per_rank = {}
        for r in mine:
            total = None
            for red in (data, model):
                if red is not None:
                    total = red[r][0] if total is None else total + red[r][0]
            for g in grads:
                if kind(g) == (False, False):
                    total = total + (g.shards[r] * g.shards[r]).sum()
            scale = torch.clamp(max_norm / (total ** 0.5 + 1e-12), max=1.0)
            per_rank[r] = tuple(g.shards[r] * scale for g in grads)
    return tuple(Sharded(g.spec, [per_rank[r][i] if r in per_rank
                                  else mesh.remote(r) for r in range(n)],
                         g.mesh, g.shape)
                 for i, g in enumerate(grads))


def _offload_out(state):
    """``offload_opt_state``: every tensor of an optimizer state (the shards
    of a :class:`Sharded` leaf) copied into new pinned host memory, the
    copies queued on the current stream of each tensor's card (the next
    step's copy in is queued after them; a host read first waits on every
    rank's card with :func:`_sync_cards`).  CPU tensors
    are host memory already and stay."""
    from ..parallel.mesh import Sharded

    def host(x):
        if not isinstance(x, torch.Tensor) or not x.is_cuda:
            return x
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return out.copy_(x, non_blocking=True)

    def leaf(x):
        if isinstance(x, Sharded):
            return Sharded(x.spec, [host(s) for s in x.shards], x.mesh,
                           x.shape)
        return host(x)

    return C.unflatten(state, [leaf(x) for x in C.flatten(state)])


def _offload_in(state, devices):
    """The offloaded optimizer state back on the card at a step's start:
    each leaf (each rank's shard) copied to ``devices`` (one per rank, or
    one for a single device) from pinned memory, without waiting."""
    from ..parallel.mesh import Remote, Sharded

    def leaf(x):
        if isinstance(x, Sharded):
            return Sharded(x.spec, [s if type(s) is Remote else
                                    s.to(d, non_blocking=True)
                                    for s, d in zip(x.shards, devices)],
                           x.mesh, x.shape)
        if isinstance(x, torch.Tensor):
            return x.to(devices[0], non_blocking=True)
        return x

    return C.unflatten(state, [leaf(x) for x in C.flatten(state)])


def _sync_cards(devices) -> None:
    """Wait for the work queued on each distinct card of ``devices``: a
    mesh's ranks may lie on several cards, each with its own queue (the
    CPU needs no wait)."""
    for d in dict.fromkeys(torch.device(d) for d in devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _offload_state(opt_state, label: str):
    """Place an optimizer state in pinned host memory between steps
    (``offload_opt_state=True``), each leaf keeping its spec; warns when
    the state holds no arrays (sgd is stateless: nothing to offload)."""
    if not any(getattr(x, "shape", ()) for x in C.flatten(opt_state)):
        warnings.warn(
            f"{label}: offload_opt_state=True but the optimizer state "
            f"holds no arrays (sgd is stateless) — nothing to offload",
            stacklevel=3)
        return opt_state
    return _offload_out(opt_state)


def _mesh_step(mesh, group_vags, update: Callable, *, accum_steps: int,
               clip_norm, elementwise: bool, grad_constrain=None,
               param_unshard=None, offload: bool = False,
               chunks: Optional[int] = None) -> Callable:
    """The step on a ``(data, model)`` mesh (or a pipeline's ``(data,
    stage)`` one, whose stage axis takes the model axis's place here):
    ``step(scalars, xb, yb, opt_state, leaves) -> (loss, opt_state,
    leaves)``, ``leaves`` and the state's arrays :class:`Sharded`, the
    batch whole (split here over the data ranks: each rank takes its part
    of each of ``chunks`` equal chunks, by default the accumulation
    chunks; a pipeline's are its microbatches), the loss a 0-d tensor on
    rank 0's device.

    Each data rank d takes its rows' mean loss and gradients with
    ``group_vags[d](x, y, ps)``, ``ps`` its group's blocks of the leaves
    in rank-major order (rank d * tp's leaves, then the next model rank's;
    on a model axis of 1 the rank's whole copies), the
    gradients in the same order, on the leaves whole over the data axis
    (ZeRO-3: gathered at use by ``param_unshard``, one all-gather per data
    group each).  The loss reduces to its mean over the data ranks of model
    rank 0, each gradient over each data group (kernel 9: an all-reduce, or
    a reduce-scatter onto ``grad_constrain``'s spec at ZeRO-2/3);
    ``clip_norm`` clips them (:func:`_clip_mesh`).  Then each rank runs
    ``update(scalars, state, leaves, grads) -> (state, leaves)`` on its
    layout of them: for an ``elementwise`` update each leaf on the spec of
    any of its data-sharded forms (param, gradient or moments: one rule
    gives them all the same), its model blocks kept, every rank its block
    alone; otherwise on whole leaves, gathered over both axes first.  The
    results go back to the specs the state and leaves came in with: a leaf
    updated in blocks it does not keep is all-gathered, a leaf updated
    whole is sliced to its blocks.  ``offload`` copies the state in from
    pinned host memory at the start and out to new pinned memory at the
    end."""
    from ..parallel.mesh import (DATA_AXIS, Sharded, _split_rows,
                                 _tree_leaves, _tree_unflatten, first_local,
                                 reduce_mean, reshard, ring_all_reduce_bidir)

    dp = mesh.shape.get(DATA_AXIS, 1)
    groups = mesh.groups(tuple(a for a in mesh.axis_names if a != DATA_AXIS))
    devs = mesh.rank_devices
    chunks = chunks or accum_steps

    def base(spec):
        if not elementwise:
            return (None,) * len(spec)
        return tuple(None if a == DATA_AXIS else a for a in spec)

    def step(scalars, xb, yb, opt_state, leaves):
        leaves = tuple(leaves)
        n = len(leaves)
        if offload:
            opt_state = _offload_in(opt_state, devs)
        full = param_unshard(leaves) if param_unshard is not None else leaves
        vals, grads = [], [None] * len(devs)
        for d, ranks in enumerate(groups):
            mine = [r for r in ranks if mesh.is_local(r)]
            if not mine:  # another process's data rank
                vals.append(mesh.remote(ranks[0]))
                for r in ranks:
                    grads[r] = (mesh.remote(r),) * n
                continue
            x_d = _split_rows(xb, dp, d, devs[mine[0]], chunks)
            y_d = _split_rows(yb, dp, d, devs[mine[0]], chunks)
            ps = tuple(p.shards[r] for r in ranks for p in full)
            if accum_steps > 1:
                v, g = _accum(lambda x, y: group_vags[d](x, y, ps), x_d, y_d,
                              accum_steps)
            else:
                v, g = group_vags[d](x_d, y_d, ps)
            vals.append(v.reshape(1))
            for m, r in enumerate(ranks):
                grads[r] = g[m * n:(m + 1) * n]
        v = first_local(ring_all_reduce_bidir(vals, scale=1.0 / dp)).reshape(())
        gspecs = (grad_constrain.specs if grad_constrain is not None
                  else (None,) * n)
        mean = tuple(reduce_mean([g[i] for g in grads], gs or full[i].spec,
                                 mesh)
                     for i, gs in enumerate(gspecs))
        if clip_norm:
            mean = _clip_mesh(mean, clip_norm)
        st_leaves = _tree_leaves(opt_state)
        slots = _moment_slots(st_leaves, leaves) if elementwise else None
        work = []
        for i, p in enumerate(leaves):
            spec = base(p.spec)
            if slots is not None:
                forms = [p, mean[i]] + [x for x, s in zip(st_leaves, slots)
                                        if s == i]
                spec = next((f.spec for f in forms if f.dim is not None),
                            spec)
            work.append(spec)
        slots = slots or [None] * len(st_leaves)
        st_work = [reshard(x, work[s] if s is not None else base(x.spec))
                   for x, s in zip(st_leaves, slots)]
        p_work = [reshard(full[i] if DATA_AXIS not in w else leaves[i], w)
                  for i, w in enumerate(work)]
        g_work = [reshard(g, w) for g, w in zip(mean, work)]
        new_st, new_ps = {}, {}
        for r in mesh.local_ranks:
            dev = devs[r]
            sc = tuple(s.to(dev) if isinstance(s, torch.Tensor) else s
                       for s in scalars)
            st_r = _tree_unflatten(opt_state, [x.shards[r] for x in st_work])
            st_r, ps_r = update(sc, st_r, tuple(p.shards[r] for p in p_work),
                                tuple(g.shards[r] for g in g_work))
            new_st[r] = _tree_leaves(st_r)
            new_ps[r] = tuple(ps_r)

        def ranked(per, j):
            return [per[r][j] if r in per else mesh.remote(r)
                    for r in range(len(devs))]

        state = _tree_unflatten(opt_state, [
            reshard(Sharded(w.spec, ranked(new_st, j), mesh, w.shape),
                    x.spec, own=True)
            for j, (x, w) in enumerate(zip(st_leaves, st_work))])
        out = tuple(
            reshard(Sharded(w, ranked(new_ps, i), mesh, p.shape),
                    p.spec, own=True)
            for i, (p, w) in enumerate(zip(leaves, work)))
        if offload:
            state = _offload_out(state)
        return v, state, out

    return step


def _offload_step(step: Callable, device, n_head: int) -> Callable:
    """``offload_opt_state`` on one device: ``step(*head, opt_state, *rest)``
    with the state copied in from pinned host memory at the start and out
    to new pinned memory at the end (``n_head`` arguments before it)."""
    def run(*args):
        head, o, rest = args[:n_head], args[n_head], args[n_head + 1:]
        out = step(*head, _offload_in(o, (device,)), *rest)
        return (out[0], _offload_out(out[1])) + tuple(out[2:])

    return run


def make_opt_step(net: Network, loss: TOp, be: Backend, opt: Optimizer,
                  accum_steps: int = 1,
                  clip_norm: Optional[float] = None,
                  mixed_precision: bool = False,
                  mesh=None, grad_constrain=None, param_unshard=None,
                  offload: bool = False, pipeline=None) -> Callable:
    """``(lr, xb, yb, opt_state, params) -> (loss, opt_state, params)``:
    one optimizer step on a batch.  ``lr`` is a float or a 0-d tensor;
    ``loss`` comes back as a 0-d tensor on the device (no synchronise), or
    a float on the NumPy oracle.  ``accum_steps > 1`` takes the batch mean
    as the sum of equal chunks' means over their count (:func:`_accum`);
    the NumPy oracle loops over the whole batch's samples whatever
    ``accum_steps``, as the JAX package's numpy branch does (the same
    mean).  Cached on the network's op by the loss's and optimizer's
    structural keys.

    ``mixed_precision=True`` (torch only) runs the forward and backward in
    bf16 on a ``TorchBackend(bfloat16)`` on the same device: through
    :func:`~tensor_ops_tpu_torch.models.batched.batched_loss_graph` where
    the network is in its family (the weight gradients one contraction
    over the batch each), else the vmapped per-sample graph.  The
    parameters are cast to bf16 for it only, the masters the optimizer
    carries keep their dtype, and the values and gradients are upcast to
    f32 BEFORE the batch mean.  :class:`_ChainedStep` chains it.

    ``mesh`` (a :class:`~tensor_ops_tpu_torch.parallel.mesh.Mesh`; torch
    only) makes it the step of :func:`_mesh_step`: ``params`` and the
    state's arrays are :class:`~tensor_ops_tpu_torch.parallel.mesh.Sharded`
    leaves, the batch is split over the data ranks, each data rank's rows
    run on its model group (a model axis > 1: the tensor-parallel executor
    ``parallel.tp.TpNetwork``, its bf16 form under ``mixed_precision``) and
    the gradients are reduced over the data axis by kernel 9.  The ZeRO
    pins come from ``parallel.mesh``: ``grad_constrain``
    (``zero2_grad_constrain``, or the ZeRO-3 gradient pin) reduce-scatters
    the gradients onto its specs, ``param_unshard`` (``zero3_param_place``)
    gathers sharded params at use.  The updated state and params keep the
    specs they came in with.  ``pipeline=(partition, M, schedule)`` on a
    mesh with a stage axis takes each data group's gradients through the
    staged-IR pipeline (``parallel.ir_pipeline.make_ir_pipeline_loss``:
    ``params`` are the partition's flat leaves, each accumulation chunk
    flows through the M-microbatch grid, the data axis splitting each
    microbatch).

    ``offload=True`` keeps the optimizer state in pinned host memory
    between steps: the step copies it to the device at its start and to
    new pinned memory at its end (:func:`_offload_in`,
    :func:`_offload_out`); the update is the same, bit for bit."""
    if mixed_precision and be.name != "torch":
        raise ValueError("mixed_precision requires the torch backend — fit "
                         "gates this itself")
    if (mesh is not None or offload) and be.name != "torch":
        raise ValueError("mesh sharding and offload require the torch "
                         "backend — fit gates this itself")

    def specs(pin):
        return None if pin is None else pin.specs

    key = ("optstep", loss.struct_key(), opt.struct_key(), int(accum_steps),
           clip_norm, bool(mixed_precision), mesh, specs(grad_constrain),
           specs(param_unshard), bool(offload),
           None if pipeline is None else (
               type(pipeline[0]).__name__, pipeline[1], pipeline[2],
               getattr(pipeline[0], "n_chunks", 1))) + be.cache_key()
    fn = net.op._compiled.get(key)
    if fn is not None:
        return fn
    if mesh is not None:
        from ..parallel.mesh import MODEL_AXIS, _rank_backend, group_executors

        chunks = None
        if pipeline is not None:
            from ..backend.torch_backend import TorchBackend
            from ..parallel.ir_pipeline import make_ir_pipeline_loss

            part, M, schedule = pipeline
            # bf16 compute on the masters (the JAX package's recipe)
            be_c = (TorchBackend(torch.bfloat16, be.device)
                    if mixed_precision else be)
            ploss, _ = make_ir_pipeline_loss(net, loss, be_c, mesh, M,
                                             pnet=part, schedule=schedule)
            group_vags = [ploss.group_vag(d) for d in range(len(ploss.groups))]
            chunks = accum_steps * M
        elif mesh.shape.get(MODEL_AXIS, 1) > 1:
            from ..parallel.tp import group_vag

            group_vags = [group_vag(t, loss) for t in group_executors(
                net, be, mesh, torch.bfloat16 if mixed_precision else None)]
        else:
            group_vags = []
            for dev in mesh.data_devices:
                be_r = _rank_backend(be, dev)
                if mixed_precision:
                    group_vags.append(_bf16_vag(net, loss, be_r))
                else:
                    mg = make_mean_grads(net, loss, be_r)
                    group_vags.append(lambda x, y, ps, mg=mg: mg(x, y, *ps))
        inner = _mesh_step(
            mesh, group_vags,
            lambda sc, st, ps, gs: opt.update(st, ps, gs, sc[0]),
            accum_steps=accum_steps, clip_norm=clip_norm,
            elementwise=opt.name in _ELEMENTWISE,
            grad_constrain=grad_constrain, param_unshard=param_unshard,
            offload=offload, chunks=chunks)

        def mesh_step(lr, xb, yb, opt_state, params):
            return inner((lr,), xb, yb, opt_state, params)

        net.op._compiled[key] = mesh_step
        return mesh_step
    if mixed_precision:
        batch_vag = _bf16_vag(net, loss, be)
    else:
        mean_grads = make_mean_grads(net, loss, be)

        def batch_vag(xb, yb, params):
            return mean_grads(xb, yb, *params)

    def step(lr, xb, yb, opt_state, params):
        params = tuple(params)
        if accum_steps > 1 and be.name != "numpy":
            v, grads = _accum(lambda x, y: batch_vag(x, y, params), xb, yb,
                              accum_steps)
        else:
            v, grads = batch_vag(xb, yb, params)
        if clip_norm:
            grads = clip_by_global_norm(grads, clip_norm)
        opt_state, params = opt.update(opt_state, params, grads, lr)
        return v, opt_state, params

    if offload:
        step = _offload_step(step, be.device, 3)
    net.op._compiled[key] = step
    return step


def _bf16_vag(net: Network, loss: TOp, be: Backend) -> Callable:
    """``(xb, yb, params) -> (mean loss, mean grads)`` in f32 from a bf16
    forward and backward (``make_opt_step(mixed_precision=True)``)."""
    from ..backend.torch_backend import TorchBackend
    from .batched import batched_loss_graph

    bf16 = torch.bfloat16
    be_c = TorchBackend(bf16, be.device)
    vmapped = make_vmapped_grads(net, loss, be_c)

    def vag(xb, yb, params):
        lp = tuple(p.to(bf16) for p in params)
        g = batched_loss_graph(net, loss, int(xb.shape[0]))
        if g is not None:
            v, grads = ir.value_and_grad(
                g, be_c, (xb.to(bf16),) + lp + (yb.to(bf16),))
            return v.float(), tuple(gg.float() for gg in grads[1:-1])
        vals, grads = vmapped(xb.to(bf16), yb.to(bf16), *lp)
        # upcast BEFORE the mean: the batch mean carries more precision
        # than any single bf16 sample
        return (vals.float().mean(),
                tuple(gg.float().mean(dim=0) for gg in grads))

    return vag


class _ChainedStep(C.StepChain):
    """The chained step of either loop over its dataset held on the device
    ``(Xd, Yd)``: ``step(*scalars, xb, yb, *state)`` is the loop's
    unchained step (:func:`make_opt_step`, :func:`_seq_train_step`), its
    ``n_scalars`` step-varying scalars read from the window's table;
    ``ema_update`` is the Polyak update (or None) and ``ema_of(new_state)``
    the leaves it follows.

    A call ``(table, sel, *state, ema) -> (loss_last, *state, ema)`` runs
    ``k = len(table)`` steps in one window (:class:`chain.StepChain`): step
    ``i`` takes the table's row ``i`` (``fit``'s lr; ``fit_sequences``'
    two rates) and gathers its batch by row ``i`` of the row table, then
    the EMA updates with the same ``d*e + (1-d)*p`` (``ema`` is ``()``
    without one).  ``sel`` is the ``(k, batch)`` table of the host
    stream's indices, or, with ``chain_spec=(n_rows, batch,
    steps_per_epoch, seed, mode)``, the window's absolute start step, whose
    rows the device streams give (``mode`` ``"perm"``:
    :func:`_device_window_indices`; ``"fixed"``:
    :func:`_device_window_offsets` into the once-shuffled dataset).  The
    math is the unchained step's on the same tensors, so a chained run
    equals the unchained one bit for bit in host mode.  Each holds its own
    CUDA graph and buffers; ``reserve(cap)`` sizes them for windows of up
    to ``cap`` steps, and ``close()`` releases the graph."""

    def __init__(self, step: Callable, ema_update: Optional[Callable],
                 ema_of: Callable, n_scalars: int, Xd: torch.Tensor,
                 Yd: torch.Tensor, batch: int, dtype: torch.dtype,
                 chain_spec=None):
        super().__init__(self._body, Xd, Yd, n_scalars, batch, dtype)
        self.step, self.ema_update, self.ema_of = step, ema_update, ema_of
        self.chain_spec = chain_spec

    def __call__(self, scalars, sel, *state):
        scalars = np.asarray(scalars, dtype=np.float64).reshape(
            -1, self.n_scalars)
        k = scalars.shape[0]
        rows = (sel if self.chain_spec is None
                else _window_rows(self.chain_spec, int(sel), k, self.device))
        self._tmpl = tuple(state[:-1]) + ((state[-1] or None),)
        v, leaves = self.run(scalars, rows, C.flatten(self._tmpl))
        *out, ema = C.unflatten(self._tmpl, leaves)
        return (v,) + tuple(out) + (ema or (),)

    def _body(self, sc, xb, yb, leaves):
        *st, ema = C.unflatten(self._tmpl, leaves)
        out = self.step(*sc, xb, yb, *st)
        v, new = out[0], tuple(out[1:])
        if ema is not None:
            ema = self.ema_update(ema, self.ema_of(new))
        return v, C.flatten(new + (ema,))


def _chained(be: Backend, X, Y, step_fn: Callable, n_scalars: int,
             ema_of: Callable, dtype: torch.dtype, *, ema_decay, chain_steps,
             chain_shuffle: str, seed: int, batch: int, steps_per_epoch: int,
             step: int, total_steps: int, log_every: int,
             checkpoint_every: int, ragged: bool):
    """``(chain_fn, window_len)`` of a chained run of either loop from
    global step ``step``: ``step_fn`` chained (:class:`_ChainedStep`) over
    ``(X, Y)`` put on the device once (its rows shuffled once for
    ``"device_fixed"``), and the window planner (:func:`_window_planner`),
    the graph sized for the run's longest window."""
    Xd, Yd = be.asarray(X), be.asarray(Y)
    spec = None
    if chain_shuffle != "host":
        mode = "perm"
        if chain_shuffle == "device_fixed":
            perm = _device_fixed_perm(seed, X.shape[0], be.device)
            Xd, Yd, mode = Xd[perm], Yd[perm], "fixed"
        spec = (X.shape[0], batch, steps_per_epoch, seed, mode)
    chain_fn = _ChainedStep(
        step_fn, None if ema_decay is None else _ema_update(ema_decay),
        ema_of, n_scalars, Xd, Yd, batch, dtype, spec)
    window_len = _window_planner(
        first_step=step + 1, total_steps=total_steps, log_every=log_every,
        checkpoint_every=checkpoint_every, steps_per_epoch=steps_per_epoch,
        chain_steps=chain_steps, batch=batch, ragged=ragged)
    chain_fn.reserve(_longest_window(window_len, step, total_steps))
    return chain_fn, window_len


class _sigint_shield:
    """Defer Ctrl-C to the end of one training step.

    Inside ``with _sigint_shield():`` the first SIGINT only sets
    ``pending``; the shield raises ``KeyboardInterrupt`` at ``__exit__``,
    after the loop's snapshot names the finished step, so the Ctrl-C
    checkpoint holds the step in flight instead of losing it.  A second
    press while shielded restores the previous handler and raises at once
    (the snapshot then still names the step before).  If the step itself
    raises while a Ctrl-C is pending, the interrupt is raised chained onto
    that exception.  No-op off the main thread, where CPython never
    delivers signals."""

    def __enter__(self):
        self._armed = False
        self.pending = False
        if threading.current_thread() is not threading.main_thread():
            return self

        def handler(signum, frame):
            if self.pending:
                signal.signal(signal.SIGINT, self._prev)
                raise KeyboardInterrupt
            self.pending = True

        try:
            self._prev = signal.signal(signal.SIGINT, handler)
            self._armed = True
        except ValueError:  # the main-thread check raced an interpreter edge
            pass
        return self

    def __exit__(self, et, ev, tb):
        if self._armed:
            signal.signal(signal.SIGINT, self._prev)
            if self.pending:
                if et is None:
                    raise KeyboardInterrupt
                raise KeyboardInterrupt from ev
        return False


def _ema_update(decay: float) -> Callable:
    """The Polyak update ``e' = d*e + (1-d)*p`` over a tuple of leaves,
    after every step of both loops (the JAX package's
    ``_make_ema_update``)."""
    d = float(decay)
    return lambda e, p: tuple(d * ei + (1 - d) * pi for ei, pi in zip(e, p))


def _ema_init(r_ema, leaves, be: Backend, resumed_step: int, label: str):
    """The EMA leaves at loop entry (the JAX package's ``_ema_init``): the
    checkpoint's EMA section, or, with a warning when a resumed checkpoint
    carries none (the saving run had ``ema_decay`` off), an average
    started from the restored leaves.  Nothing updates a leaf in place, so
    the average may start on the parameters' own tensors."""
    if r_ema is not None:
        if len(r_ema) != len(leaves):
            raise ValueError(
                f"checkpoint EMA holds {len(r_ema)} leaves but this "
                f"configuration expects {len(leaves)} — resume with the "
                f"same model")
        from ..parallel.mesh import Sharded, place

        # on a mesh each leaf back on its template's spec
        return tuple(place(e, t.spec, t.mesh, t.dtype)
                     if isinstance(t, Sharded) else be.asarray(e)
                     for e, t in zip(r_ema, leaves))
    if resumed_step > 0:
        warnings.warn(
            f"{label}: the resumed checkpoint carries no EMA (the saving "
            f"run had ema_decay off) — the Polyak average restarts from "
            f"the restored params at step {resumed_step}", stacklevel=3)
    return tuple(leaves)


def _drive(state, run_window: Callable, *, step: int, total_steps: int,
           steps_per_epoch: int, log_every: int, logger: MetricsLogger,
           window_len: Optional[Callable[[int], int]] = None,
           evaluate: Optional[Callable] = None,
           early_stop_patience: int = 0, save: Optional[Callable] = None,
           checkpoint_every: int = 0, verbose: bool = True,
           torn: Optional[Callable[[], bool]] = None,
           interrupt_save: bool = True):
    """The window driver of both loops: run from global step ``step`` to
    ``total_steps`` and return ``(state, history, step)``.

    Each window is ``v, state = run_window(step, k, state)``, the ``k =
    window_len(step)`` steps from ``step`` (1 without ``window_len``: the
    unchained loop), ``v`` the last step's loss, under
    :class:`_sigint_shield`: a Ctrl-C waits for the window's edge.  A
    snapshot ``(state, step)`` replaced by one assignment after each window
    is what a Ctrl-C saves.  Windows end at the observation boundaries
    (``window_len`` guarantees it), so what follows a window sees the same
    steps as an unchained run: a log boundary (every ``log_every`` steps,
    and the run's first step) reads the loss (one synchronise), calls
    ``evaluate(state) -> (name, value, score)`` when given (higher score is
    better; ``early_stop_patience`` evaluations without a gain stop the
    run), and appends the record ``logger.log`` makes (its ``t`` is the
    host clock after that synchronise and the evaluation) to the history.
    A boundary without ``evaluate`` reads its loss at once too, where the
    JAX package's ``fit`` defers that read a few windows: the host waits
    there for the card.  Every ``checkpoint_every`` steps ``save(state,
    step)`` returns futures of asynchronous writes, joined before the
    driver returns; a write error is raised unless another exception is
    already unwinding.  On ``KeyboardInterrupt`` with ``save`` given and a
    step taken, the snapshot is saved (after the writes in flight) before
    it propagates, whatever ``checkpoint_every``: resuming from it
    continues exactly.  ``torn()`` true means a second Ctrl-C escaped in
    the middle of a window whose state is updated in place (a CUDA graph's
    buffers): then nothing is saved and the last checkpoint stands.
    ``interrupt_save=False`` (several processes: the checkpoint's gather
    is a collective no lone process may enter) skips the Ctrl-C save."""
    history = []
    saves = _CheckpointWrites()
    best, since_best = float("-inf"), 0
    first = step + 1  # a resumed run logs its first step too
    snap = (state, step)
    try:
        while step < total_steps:
            k = window_len(step) if window_len is not None else 1
            with _sigint_shield():
                v, new_state = run_window(step, k, state)
                snap = (new_state, step + k)
                state, step = snap
            epoch = (step - 1) // steps_per_epoch
            stop = False
            if step % log_every == 0 or step == first:
                rec = {"epoch": epoch, "loss": float(v)}
                if evaluate is not None:
                    name, value, score = evaluate(state)
                    rec[name] = value
                    if early_stop_patience:
                        if score > best + 1e-12:
                            best, since_best = score, 0
                        else:
                            since_best += 1
                            stop = since_best >= early_stop_patience
                history.append(logger.log(step, **rec))
                if verbose:
                    msg = f"[epoch {epoch}] step {step}: loss {rec['loss']:.4f}"
                    if "val_acc" in rec:
                        msg += f"  val_acc {rec['val_acc']:.3f}"
                    if "val_loss" in rec:
                        msg += f"  val_loss {rec['val_loss']:.4f}"
                    print(msg)
            if save is not None and checkpoint_every and \
                    step % checkpoint_every == 0:
                saves.add(*save(state, step))
            if stop:
                if verbose:
                    print(f"early stop at step {step}: {name} has not "
                          f"improved over {early_stop_patience} "
                          f"evaluations (best {abs(best):.4f})")
                break
    except KeyboardInterrupt:
        # the reference trains until Ctrl-C (MNIST.hs:297-313); here
        # Ctrl-C leaves an exact-resume checkpoint at the snapshot's step
        s_state, s_step = snap
        if save is not None and s_step > 0 and interrupt_save:
            if torn is not None and torn():
                if verbose:
                    print("interrupt landed inside a window (double Ctrl-C): "
                          "its state is torn; no checkpoint written")
                raise
            saves.join()  # the writes in flight land first
            for f in save(s_state, s_step):
                f.result()
            if verbose:
                print(f"interrupted at step {s_step}: checkpoint saved — "
                      f"resume=True continues exactly here")
        raise
    finally:
        err = saves.join()
        if err is not None and sys.exc_info()[0] is None:
            raise err
    return state, history, step


def _window_planner(*, first_step: int, total_steps: int, log_every: int,
                    checkpoint_every: int, steps_per_epoch: int,
                    chain_steps, batch: int, ragged: bool):
    """``window_len(s)`` of a chained run (the JAX package's
    ``_window_len``): the steps from ``s`` to the next observation
    boundary (each ``log_every``, each ``checkpoint_every`` (0: none), the
    run's first step, the budget), capped by an int ``chain_steps``;
    with a ``ragged`` last batch each epoch's final step is a window of
    its own.  Boundaries are absolute step positions, so a resumed run
    cuts the same windows."""
    kcap = max(1, (1 << 25) // max(batch, 1))
    if isinstance(chain_steps, int):
        kcap = min(kcap, chain_steps)

    def window_len(s: int) -> int:
        nb = total_steps
        if s < first_step:
            nb = min(nb, first_step)
        nb = min(nb, (s // log_every + 1) * log_every)
        if checkpoint_every:
            nb = min(nb, (s // checkpoint_every + 1) * checkpoint_every)
        if ragged:
            rag = ((s // steps_per_epoch) * steps_per_epoch
                   + steps_per_epoch - 1)
            if s == rag:
                return 1
            nb = min(nb, rag)
        return max(1, min(nb - s, kcap))

    return window_len


def _longest_window(window_len: Callable, step: int, total: int) -> int:
    """The longest window a run from ``step`` to ``total`` will cut."""
    longest = 1
    while step < total:
        k = window_len(step)
        longest, step = max(longest, k), step + k
    return longest


def _refuse(caller: str, what: str, item: str) -> None:
    raise ValueError(
        f"{caller}: {what} is not ported to the PyTorch package yet "
        f"(ROADMAP.md, Queue 1 item {item})")


def _check_process_data_alignment(mesh, n_proc: int) -> None:
    """Multi-process batch assembly (each process's loader shard feeds the
    data ranks it holds) requires every data-axis row of the mesh to live
    on ONE process: a row spanning processes cannot be fed from any single
    rank's local rows.  Raise a clear error with the fix (the JAX
    package's check and text)."""
    from ..parallel.mesh import DATA_AXIS

    axis = mesh.axis_names.index(DATA_AXIS)
    procs = np.asarray(mesh.rank_procs).reshape(tuple(mesh.shape.values()))
    rows = np.moveaxis(procs, axis, 0)
    bad = []
    for i in range(rows.shape[0]):
        held = {int(p) for p in rows[i].flat}
        if len(held) != 1:
            bad.append((i, sorted(held)))
    if bad:
        raise ValueError(
            f"multi-process fit needs the mesh's data axis aligned to "
            f"process boundaries, but data row(s) {bad} span multiple "
            f"processes — each rank's loader shard can only fill rows "
            f"its own devices hold.  Pick a mesh shape whose data-axis "
            f"size is a multiple of the process count with "
            f"process-contiguous rows, e.g. "
            f"make_mesh(n, shape=({n_proc}*k, tp)).")


def _global_host_tree(tree, mesh=None):
    """Host numpy copies of every leaf of a (possibly sharded, possibly
    multi-process) tree of tuples: a :class:`~..parallel.mesh.Sharded`
    leaf is gathered whole (a collective when the mesh spans processes —
    ALL processes must call this together), a tensor copied to the host,
    anything else kept.  What multi-process checkpointing needs before
    process 0 writes."""
    from ..parallel.mesh import Sharded, _tree_leaves, _tree_unflatten

    def fetch(x):
        if isinstance(x, Sharded):
            return x.numpy()
        if isinstance(x, torch.Tensor):
            x = x.detach()
            return (x.float() if x.dtype == torch.bfloat16 else x).cpu() \
                .numpy().copy()
        return x

    return _tree_unflatten(tree, [fetch(x) for x in _tree_leaves(tree)])


def _check_later(caller: str, profile_dir: Optional[str]) -> None:
    """Refuse the option of the JAX package's loop ``caller`` that this
    package does not run yet, naming the ROADMAP item that will port it:
    ``profile_dir`` (item 8).  None is silently ignored."""
    if profile_dir:
        _refuse(caller, "profile_dir", "8")


def _normalize_zero_stage(shard_opt_state: bool, zero_stage):
    """One ladder, two spellings (the JAX package's): ``shard_opt_state=
    True`` is ZeRO-1; ``zero_stage=1|2|3`` names the rung (1: moments
    shard, 2: + gradients reduce-scatter, 3: + params shard between steps,
    gathered at use).  Returns ``(shard_opt_state, stage)``; an explicit
    ``zero_stage=0`` beside ``shard_opt_state=True`` is refused."""
    if zero_stage is None:
        return shard_opt_state, (1 if shard_opt_state else 0)
    if zero_stage not in (0, 1, 2, 3):
        raise ValueError(
            f"zero_stage must be 0, 1, 2, or 3, got {zero_stage!r}")
    if zero_stage == 0 and shard_opt_state:
        raise ValueError(
            "zero_stage=0 contradicts shard_opt_state=True — drop one "
            "(shard_opt_state=True is exactly zero_stage=1)")
    return zero_stage >= 1, int(zero_stage)


def _check_mesh_options(caller: str, be: Backend, mesh, shard_opt_state,
                        zstage: int, offload_opt_state: bool, batch_size: int,
                        chain_steps) -> int:
    """The JAX package's eager checks of the mesh, ZeRO and offload options
    both loops share (``fit_sequences`` refuses a stage axis before this),
    and those of several processes: a run without a mesh is refused with
    the JAX package's reason, so is an int ``chain_steps > 1`` (a captured
    CUDA graph cannot hold the host barriers that order the processes'
    collectives), and ``"auto"`` backs off to unchained steps with a
    warning.  Returns the data-axis size (1 without a mesh or data axis).
    A pipeline's batch is checked by its microbatch grid instead
    (``fit``)."""
    if shard_opt_state and mesh is None:
        raise ValueError(
            f"ZeRO-{zstage} (shard_opt_state/zero_stage) shards over "
            f"the mesh's data axis — pass mesh=make_mesh(...)")
    if offload_opt_state and be.name != "torch":
        raise ValueError(
            "offload_opt_state keeps optimizer state in pinned host "
            "memory and requires the torch backend (numpy state already "
            "lives on the host)")
    if (isinstance(chain_steps, int) and chain_steps > 1
            and offload_opt_state):
        raise ValueError(
            "chain_steps > 1 cannot combine with offload_opt_state: the "
            "moments' host copies cannot ride inside a captured step — "
            "use chain_steps='auto' (which backs off) or chain_steps=1")
    from ..parallel.distributed import process_count

    n_proc = process_count()
    if n_proc > 1 and mesh is None:
        raise ValueError(
            f"{caller} without a mesh under a multi-process runtime would "
            f"train an independent (divergent) replica per process on the "
            f"full dataset; pass mesh=make_mesh() so the batch shards "
            f"globally")
    if n_proc > 1 and isinstance(chain_steps, int) and chain_steps > 1:
        raise ValueError(
            f"chain_steps > 1 cannot run in {n_proc} processes: a captured "
            f"step (one CUDA graph) cannot hold the host barriers and "
            f"exchanges that order the processes' collectives — use "
            f"chain_steps='auto' (which backs off) or chain_steps=1")
    if n_proc > 1 and chain_steps == "auto":
        warnings.warn(
            f"{caller}: {n_proc} processes run unchained "
            f"(chain_steps='auto' backs off): a captured step cannot hold "
            f"the host barriers that order the processes' collectives",
            stacklevel=3)
    if n_proc > 1 and batch_size % n_proc:
        raise ValueError(
            f"batch_size ({batch_size}) must be divisible by the process "
            f"count ({n_proc}): each process loads its share of a batch")
    if mesh is None:
        return 1
    from ..parallel.mesh import DATA_AXIS, STAGE_AXIS, check_mesh

    if be.name != "torch":
        raise ValueError("mesh sharding requires the torch backend")
    check_mesh(mesh, caller)
    dp = dict(mesh.shape).get(DATA_AXIS, 1)
    if STAGE_AXIS not in mesh.axis_names and batch_size % dp != 0:
        raise ValueError(
            f"batch_size ({batch_size}) must be divisible by the "
            f"data-axis size ({dp})")
    return dp


def _zero2_grads(leaves, mesh, exact: bool = False):
    """ZeRO-2 gradient pin over the placed training leaves
    (``parallel.mesh.zero2_grad_constrain``), warning loudly when nothing
    can shard: the run continues as ZeRO-1, never silently.
    ``exact=True`` (``adam8bit(exact_reduction=True)``) returns None
    without the warning: the gradients keep the replicated run's
    all-reduce, bit for bit its order, instead of a reduce-scatter whose
    different grouping perturbs them by an epsilon that int8 block
    quantization amplifies; moments (and at stage 3 params) stay
    sharded."""
    if exact:
        return None
    from ..parallel.mesh import zero2_grad_constrain

    cons = zero2_grad_constrain(leaves, mesh)
    if cons is None:
        warnings.warn(
            "zero_stage=2: no gradient leaf can shard over the data "
            "axis (no data axis in the mesh, dp == 1, or no dp-divisible "
            "dimension) — continuing with replicated gradients (ZeRO-1)",
            stacklevel=4)
    return cons


def _zero3_params(leaves, mesh):
    """ZeRO-3 placement over the training leaves
    (``parallel.mesh.zero3_param_place``); warns loudly when nothing can
    shard (the run continues as ZeRO-2)."""
    from ..parallel.mesh import zero3_param_place

    placed, unshard, _, shs = zero3_param_place(leaves, mesh)
    if unshard is None:
        warnings.warn(
            "zero_stage=3: no parameter leaf can shard over the data "
            "axis (no data axis in the mesh, dp == 1, or no dp-divisible "
            "dimension) — continuing with replicated params (ZeRO-2)",
            stacklevel=4)
    return placed, unshard, shs


def _zero3_opt_init(opt: Optimizer, whole, params, mesh):
    """ZeRO-3 optimizer state: moments of an elementwise optimizer inherit
    their sharded params' specs (:func:`_mesh_opt_init`), as ``opt.init``
    on sharded params does in the JAX package; the ZeRO-1 rule extends
    the rest (``adam8bit``'s blocks, whose specs the JAX package leaves
    to XLA's propagation)."""
    from ..parallel.mesh import zero1_place

    return zero1_place(_mesh_opt_init(opt, whole, params, mesh), mesh)[0]


def _zero1_wrap(opt_state, mesh):
    """The optimizer state on its ZeRO-1 specs
    (``parallel.mesh.zero1_place``); warns loudly when nothing shards (no
    data axis, dp == 1, a stateless optimizer, or no divisible
    dimension): the moments then stay replicated, never silently."""
    from ..parallel.mesh import zero1_place

    opt_state, zero_cons = zero1_place(opt_state, mesh)
    if zero_cons is None:
        warnings.warn(
            "shard_opt_state: no optimizer-state leaf can shard over "
            "the data axis (no data axis in the mesh, dp == 1, a "
            "stateless optimizer, or no dp-divisible dimension) — "
            "continuing with replicated moments", stacklevel=4)
    return opt_state


def _mesh_setup(leaves, specs, opt: Optional[Optimizer], mesh, be: Backend,
                zstage: int):
    """The one mesh setup of both loops: the training ``leaves`` placed on
    ``mesh`` by ``specs`` (replicated over the data ranks), then up the
    ZeRO ladder to ``zstage``: 3 shards the leaves (:func:`_zero3_params`),
    1 and up the optimizer state (:func:`_zero3_opt_init` /
    :func:`_zero1_wrap`), 2 and up the gradients (:func:`_zero2_grads`, or
    the ZeRO-3 leaves' specs; none under ``exact_reduction``).  Returns
    ``(placed, opt_state, pins)``, ``pins`` the keyword arguments of the
    step (``make_opt_step``, ``_seq_train_step``)."""
    from ..parallel.mesh import pin_shardings, place

    whole = tuple(place(be.asarray(x), s, mesh) for x, s in zip(leaves, specs))
    placed = whole
    pins = dict(grad_constrain=None, param_unshard=None)
    if zstage >= 3:
        placed, pins["param_unshard"], z3 = _zero3_params(whole, mesh)
    if opt is None:
        return placed, (), pins
    exact = opt.exact_reduction
    if zstage >= 3 and pins["param_unshard"] is not None:
        opt_state = _zero3_opt_init(opt, whole, placed, mesh)
        if not exact:
            pins["grad_constrain"] = pin_shardings(
                z3, what="zero_stage=3 gradient shards")
        return placed, opt_state, pins
    opt_state = _mesh_opt_init(opt, whole, placed, mesh)
    if zstage >= 1:
        opt_state = _zero1_wrap(opt_state, mesh)
        if zstage >= 2:
            pins["grad_constrain"] = _zero2_grads(placed, mesh, exact=exact)
    return placed, opt_state, pins


def _padded_rows(x, dp: int):
    """``x`` with zero rows appended up to a multiple of ``dp`` (the rows
    split evenly over the data ranks), and its own row count."""
    n = x.shape[0]
    if n % dp:
        x = torch.cat([x, x.new_zeros((dp - n % dp,) + tuple(x.shape[1:]))])
    return x, n


def _mesh_evaluate(net: Network, loss: TOp, be: Backend, mesh, unshard,
                   val, val_metric: str) -> Callable:
    """``evaluate(state)`` of a mesh ``fit``: the validation rows through
    the mesh's forward (``parallel.mesh.sharded_forward``: each data rank
    its rows, on a model axis > 1 the tensor-parallel executor) on the
    leaves as they train (a ZeRO-3 leaf gathered over the data axis at use,
    as the step gathers it); only the outputs come to rank 0, where the
    accuracy or the per-sample losses are taken."""
    from ..parallel.mesh import DATA_AXIS, sharded_forward

    fwd = sharded_forward(net, be, mesh)
    xv, n = _padded_rows(be.asarray(val[0]), mesh.shape[DATA_AXIS])

    def outputs(state):
        ps = state[0] if unshard is None else unshard(state[0])
        return fwd(xv, *ps)[:n]

    if val_metric == "accuracy":
        labels = np.asarray(val[1])

        def evaluate(state):
            a = float((outputs(state).argmax(dim=1).cpu().numpy()
                       == labels).mean())
            return "val_acc", a, a
    else:
        yv = be.asarray(val[1])
        per_sample = torch.func.vmap(lambda o, y: loss.apply(be, (o, y))[0])

        def evaluate(state):
            v = float(per_sample(outputs(state), yv).mean())
            return "val_loss", v, -v
    return evaluate


def _staged_evaluate(net: Network, loss: TOp, be: Backend, as_network,
                     val, val_metric: str) -> Callable:
    """``evaluate(state)`` of a pipeline ``fit``: the validation rows
    through the network's segments in chain order, each on the rank of the
    stage that holds its leaves (``parallel.ir_pipeline.staged_forward``);
    only the activations move, and the accuracy or the per-sample losses
    are taken where the last segment ran."""
    from ..parallel.ir_pipeline import staged_forward
    from ..parallel.mesh import _rank_backend

    xv = be.asarray(val[0])

    def outputs(state):
        return staged_forward(as_network(state[0]), be)(xv)

    if val_metric == "accuracy":
        labels = np.asarray(val[1])

        def evaluate(state):
            a = float((outputs(state).argmax(dim=1).cpu().numpy()
                       == labels).mean())
            return "val_acc", a, a
    else:
        def evaluate(state):
            out = outputs(state)
            be_o = _rank_backend(be, out.device)
            yv = be_o.asarray(val[1])
            v = float(torch.func.vmap(
                lambda o, y: loss.apply(be_o, (o, y))[0])(out, yv).mean())
            return "val_loss", v, -v
    return evaluate


def _seq_mesh_evaluate(rnet: RecurrentNetwork, loss: TOp, be: Backend,
                       mesh, unshard, k: int, val) -> Callable:
    """``evaluate(state)`` of a mesh ``fit_sequences``: each data rank's
    validation sequences through the scan on its model rank 0 (on a model
    axis > 1 the leaves all-gathered over the model group, as the step
    runs the cell; a ZeRO-3 leaf gathered over the data axis first, as the
    step gathers it); the per-sequence losses come to rank 0 (kernel 9's
    ``ag`` over the data ranks) for their mean."""
    from ..parallel.collective_kernels import ring_all_gather
    from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, _all_gather,
                                 _rank_backend, _split_rows, first_local)
    from .training import seq_losses

    dp = mesh.shape[DATA_AXIS]
    XS, n = _padded_rows(be.asarray(val[0]), dp)
    TS, _ = _padded_rows(be.asarray(val[1]), dp)
    groups = mesh.groups(MODEL_AXIS)
    devs = [mesh.rank_devices[g[0]] for g in groups]
    bes = [_rank_backend(be, d) for d in devs]

    def evaluate(state):
        ls = state[0] if unshard is None else unshard(state[0])
        per = []
        for d, (group, dev) in enumerate(zip(groups, devs)):
            if not mesh.is_local(group[0]):  # another process's data rank
                per.append(mesh.remote(group[0]))
                continue
            whole = tuple(
                x.shards[group[0]] if x.mdim is None else
                _all_gather([x.shards[r] for r in group], x.mdim)[0]
                for x in ls)
            r = RecurrentNetwork(rnet.op, whole[:k], whole[k:], rnet.arch)
            per.append(seq_losses(r, loss, bes[d],
                                  _split_rows(XS, dp, d, dev),
                                  _split_rows(TS, dp, d, dev)))
        if dp > 1:
            per = ring_all_gather(per)
        v = float(first_local(per)[:n].mean())
        return "val_loss", v, -v

    return evaluate


def _like(leaves):
    """A tensor of the training leaves' dtype and device (this process's
    first rank's: rank 0's in one process)."""
    from ..parallel.mesh import Sharded

    x = leaves[0] if len(leaves) else None
    return x.local if isinstance(x, Sharded) else x


def _memory_line(net, opt, batch_size: int, mesh, shard_opt_state: bool,
                 zstage: int, mp_active: bool, offload: bool) -> str:
    """``fit``'s verbose line of the training state per device
    (:func:`~tensor_ops_tpu_torch.utils.profiling.training_memory_report`)."""
    from ..utils.profiling import training_memory_report

    rep = training_memory_report(
        net, optimizer=opt, batch_size=batch_size, mesh=mesh,
        shard_opt_state=shard_opt_state, zero_stage=zstage,
        mixed_precision=mp_active, offload_opt_state=offload)["per_device"]
    return (f"training state/device: "
            f"params {rep['params_bytes'] / 1e6:.2f} MB + "
            f"grads {rep['grads_bytes'] / 1e6:.2f} MB + "
            f"moments {rep['optimizer_bytes'] / 1e6:.2f} MB"
            + (f" (zero{zstage})" if shard_opt_state else "")
            + (f" (+{rep['optimizer_host_bytes'] / 1e6:.2f} MB "
               f"host-offloaded)" if offload else "")
            + f" + batch {rep['batch_bytes'] / 1e6:.2f} MB")


def _check_chain(chain_steps, chain_shuffle: str, n_rows: int,
                 batch_size: int, ragged_msg: str) -> None:
    """The JAX package's eager checks of ``chain_steps`` and
    ``chain_shuffle`` (``ragged_msg`` ends the device modes' message about
    a dataset that does not divide into batches)."""
    if chain_steps != "auto" and (not isinstance(chain_steps, int)
                                  or chain_steps < 1):
        raise ValueError(f"chain_steps must be 'auto' or an int >= 1, got "
                         f"{chain_steps!r}")
    if chain_shuffle not in ("host", "device", "device_fixed"):
        raise ValueError(
            f"chain_shuffle must be 'host', 'device', or "
            f"'device_fixed', got {chain_shuffle!r}")
    if chain_shuffle != "host" and n_rows % batch_size != 0:
        raise ValueError(f"chain_shuffle={chain_shuffle!r} computes the "
                         f"batch stream on the device {ragged_msg}")


def _use_chain(be: Backend, chain_steps, chain_shuffle: str,
               n_values: int, what: str, allowed: bool = True) -> bool:
    """Whether the run chains: ``allowed``, a torch backend and
    ``chain_steps != 1``, and for ``"auto"`` a dataset of at most 1 GiB on
    the device (the JAX package's gate: a mesh, a pipeline's included, and
    an offloaded state come with ``allowed=False``).  A device
    ``chain_shuffle`` without chaining raises, as there."""
    use = False
    if allowed and be.name == "torch" and chain_steps != 1:
        use = (chain_steps != "auto"
               or n_values * be.dtype.itemsize <= (1 << 30))
    if chain_shuffle != "host" and not use:
        raise ValueError(
            f"chain_shuffle={chain_shuffle!r} needs step chaining to "
            f"engage: the torch backend, chain_steps != 1, and (in auto "
            f"mode) a dataset small enough to stay on the device — this "
            f"configuration fell back to unchained steps, where the host "
            f"{what} already owns the shuffle")
    return use


def _check_mp(mixed_precision, be: Backend) -> str:
    mp_mode = _normalize_mp(mixed_precision)
    if mp_mode != "off" and be.name != "torch":
        raise ValueError("mixed_precision requires the torch backend (the "
                         "numpy oracle has no bf16 compute path)")
    return mp_mode


def _check_knobs(accum_steps: int, ema_decay, batch_size: int,
                 what: str) -> None:
    """The JAX package's eager checks of ``accum_steps`` and ``ema_decay``
    (a remainder would silently drop samples of every batch)."""
    if ema_decay is not None and not (0.0 < ema_decay < 1.0):
        raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if accum_steps > 1 and batch_size % accum_steps != 0:
        raise ValueError(
            f"batch_size ({batch_size}) must be divisible by accum_steps "
            f"({accum_steps}): the step would silently drop the remainder "
            f"{batch_size % accum_steps} {what} of every batch")


def _processes(mesh, pipeline_mode: bool = False):
    """``(n_proc, proc_idx, mp_replicated)`` of a run: the process count
    and index, and whether its mesh spans processes without a data axis
    (a stage-only pipeline: every process loads the full stream).  A mesh
    with a data axis (or any mesh of a non-pipeline run) must have its
    data rows on one process each (:func:`_check_process_data_alignment`)."""
    from ..parallel.distributed import process_count, process_index

    n_proc = process_count()
    if n_proc == 1:
        return 1, 0, False
    has_data = "data" in mesh.axis_names
    if has_data or not pipeline_mode:
        _check_process_data_alignment(mesh, n_proc)
    return n_proc, process_index(), not has_data


def fit(
    net: Network,
    loss: TOp,
    be: Backend,
    X: np.ndarray,
    Y: np.ndarray,
    *,
    epochs: int = 1,
    batch_size: int = 128,
    lr: float = 0.01,
    optimizer: Optional[Optimizer] = None,
    accum_steps: int = 1,
    clip_norm: Optional[float] = None,
    lr_schedule: Optional[Callable[[int], float]] = None,
    mixed_precision=False,
    shard_opt_state: bool = False,
    zero_stage: Optional[int] = None,
    offload_opt_state: bool = False,
    ema_decay: Optional[float] = None,
    early_stop_patience: int = 0,
    val_metric: str = "accuracy",
    profile_dir: Optional[str] = None,
    mesh=None,
    pipeline_microbatches: int = 4,
    pipeline_schedule: str = "gpipe",
    pipeline_chunks: int = 2,
    prefetch: int = 2,
    chain_steps="auto",
    chain_shuffle: str = "host",
    seed: int = 0,
    val: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    metrics_path: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    log_every: int = 50,
    verbose: bool = True,
) -> FitResult:
    """Minibatch-train ``net`` on (X, Y) arrays; the JAX package's ``fit``
    (``tensor_ops_tpu/models/trainer.py``), single-device.

    Batches come from :class:`NativeLoader` (C++ shuffle and assembly when
    g++ is there, its NumPy fallback otherwise), seeded by ``seed``, in
    float32 rows; one epoch is ``ceil(len(X) / batch_size)`` steps, the
    last one ragged.  ``lr_schedule`` maps the global step to a learning
    rate (``optim.cosine_schedule``, ``optim.exponential_schedule``);
    ``clip_norm`` clips the mean gradient by its global L2 norm.  On a
    ``TorchBackend``, ``prefetch > 1`` keeps that many batches in flight
    to the device (:class:`DevicePrefetcher`) in an unchained run (a
    chained one gathers its batches on the device); the batches and the
    result are the same as with ``prefetch=0``.

    Every ``log_every`` steps (and at the run's first step) the loss goes
    to the history, to ``metrics_path`` (JSONL) and, with ``verbose``, to
    stdout, each record's ``t`` in host seconds since ``fit`` began;
    with ``val`` the validation metric is evaluated there too:
    ``val_metric="accuracy"`` takes ``val=(Xv, class labels)``, ``"loss"``
    takes ``val=(Xv, targets)`` through the training loss.
    ``early_stop_patience=k`` stops once k evaluations in a row have not
    improved it.

    ``accum_steps > 1`` takes each batch's gradient as the mean of that
    many equal chunks (the batch must divide into them); ``ema_decay``
    (e.g. 0.999) keeps a Polyak average ``ema = d*ema + (1-d)*params``
    after every step, returned as ``FitResult.ema_net``.

    ``checkpoint_path`` + ``checkpoint_every`` save the servable network
    and a sibling ``<path>.state`` holding the parameters, the optimizer
    state, the EMA and the global step (atomic writes, off the training
    thread); ``resume=True`` restores them and requires the same optimizer
    and hyperparameters (its stored ``struct_key``); a checkpoint without
    an EMA resumed with ``ema_decay`` warns and restarts the average from
    the restored parameters.  ``epochs`` is the TOTAL budget: a resumed
    run executes only the remaining steps, and the data stream is
    fast-forwarded to the restored step, so a crash/resume chain equals
    the uninterrupted run bit for bit.  Ctrl-C (``KeyboardInterrupt``)
    during a run with ``checkpoint_path`` saves an exact-resume checkpoint
    at the last finished step before it propagates, even with
    ``checkpoint_every=0``; a press inside a step waits for the step's end
    (a second one raises at once).  The ``.state`` format is the JAX
    package's: a file of either package resumes in the other.

    ``chain_steps`` (the JAX package's): between observation boundaries
    (``log_every``, ``checkpoint_every``, the run's first step, the
    budget, and each epoch's ragged last batch) a chained run takes each
    window of steps from the dataset held on the device (``models/
    chain.py``): on the card one CUDA graph of one step, replayed once a
    step; on the CPU the same step run eagerly.  The math is the unchained
    step's, so results, EMA, exact resume and Ctrl-C are unchanged (an
    interrupt waits for the window's edge).  ``"auto"`` (the default)
    chains on a ``TorchBackend`` whose float copy of ``(X, Y)`` fits in
    1 GiB; an int >= 2 forces chaining with that window cap; ``1`` runs
    one step at a time.  A step that cannot be captured raises
    (``chain.CaptureError``), naming the operation; pass
    ``chain_steps=1``.  ``chain_shuffle``: ``"host"`` (the default) takes
    the loader's indices, bit for bit the batches of an unchained run;
    ``"device"`` draws each epoch's permutation on the device
    (:func:`_device_window_indices`) and ``"device_fixed"`` shuffles the
    rows once and each epoch only the order of the batch slots
    (:func:`_device_window_offsets`): no index byte from the host, every
    row once an epoch, a pure function of (seed, step); their order is
    not the host loader's.  The device modes need chaining and a dataset
    that divides into batches.

    ``mixed_precision`` (torch only): ``"bf16"`` runs the forward and
    backward in bf16 (through the batched graph where the network allows,
    :func:`make_opt_step`) on masters of the backend's dtype; ``True`` /
    ``"auto"`` measures the f32 and the bf16 step once and keeps bf16 only
    when it is more than 3% faster, prints the decision, writes it to the
    metrics JSONL (``mp_route``, ``mp_f32_us``, ``mp_bf16_us``), caches it
    on the network and records it in every ``.state`` checkpoint, so
    ``resume=True`` re-takes it without measuring.

    ``mesh`` (torch only; ``parallel.make_mesh``, a ``(data, model)`` grid
    whose ranks may share a card) trains on both axes: the parameters are
    placed by ``param_specs`` (Megatron's row- and column-parallel layers
    over the model axis, replicated over the data axis), each batch
    (``batch_size`` divisible by the data-axis size dp, accumulation chunks
    too) splits over the data ranks, each data rank's rows run through the
    tensor-parallel executor on its model group (``parallel.tp``; a
    segment it cannot split runs on gathered weights, with a warning), and
    each rank's mean gradient is reduced to the global mean over the data
    axis by kernel 9 (an all-reduce, scale 1/dp); every rank steps its own
    blocks.  The returned net's leaves (and ``ema_net``'s) stay
    :class:`~tensor_ops_tpu_torch.parallel.Sharded`, each with the spec it
    trained on (a ZeRO-3 leaf its data blocks), as the JAX package returns
    sharded arrays: ``np.asarray`` of a leaf gathers it to the host and
    ``save_network`` writes whole arrays.  ``val`` runs through the mesh's
    forward (``parallel.sharded_forward``); only its outputs reach rank 0.
    ``shard_opt_state=True`` (ZeRO-1, ``zero_stage=1``) shards the
    optimizer moments over the data axis (the first free dimension dp
    divides): each rank updates its blocks and an all-gather rebuilds the
    parameters; ``zero_stage=2`` also reduce-scatters the gradients;
    ``zero_stage=3`` also keeps the parameters sharded between steps,
    gathered at use.  ``adam8bit(exact_reduction=True)`` keeps the
    all-reduce at stages 2 and 3 (bit-equal to the replicated run).  A
    stage with nothing to shard warns and continues one rung down.
    ``offload_opt_state=True`` keeps the optimizer state in pinned host
    memory between steps (the same numbers, bit for bit).  Checkpoints
    gather sharded leaves to the JAX package's ``.state`` format; a resume
    on a mesh places them by their specs.  A mesh or offload runs
    unchained (an int ``chain_steps > 1`` with offload raises); with
    ``verbose`` a mesh run prints ``training_memory_report``'s line.

    A mesh with a ``stage`` axis (``parallel.make_pipeline_mesh(S)`` /
    ``make_dp_pipeline_mesh(D, S)`` / ``make_3d_pipeline_mesh(D, S, T)``)
    trains PIPELINE-parallel over the
    staged IR: the network is cut at its composition points
    (``parallel.partition_network``, or ``partition_network_circular``
    under ``pipeline_schedule="circular"`` with ``pipeline_chunks`` chunks
    a stage rank; ``verbose`` prints ``describe_partition``), each stage
    rank runs its segments' sub-graphs with their own transposition as
    the backward (on a model axis > 1 each model rank its row block of
    each segment, between segments kernel 9's all-gather, when the
    partition row-splits; else the model axis sits idle, with a warning),
    and each accumulation chunk flows through the schedule
    as ``pipeline_microbatches`` microbatches (each split over the data
    axis), with the same optimizer, clip, schedule, ZeRO ladder, offload,
    EMA and checkpoint surface.  Ragged last batches are dropped (an
    epoch is ``len(X) // batch_size`` steps).  The flat partitioned leaves
    train and go into the ``.state`` file, whose layout string
    (``pipeline:{schedule}:S{S}[:V{V}][:P{shape}]``) a resume checks; the
    servable checkpoint and the returned nets hold the ordinary parameter
    stack, each layer's leaves on the card of the stage that trained them
    (``val`` runs each segment there).  Without a stage axis the
    ``pipeline_*`` options are unused, as in the JAX package.

    ``profile_dir`` (item 8) raises ``ValueError`` naming its ROADMAP
    item."""
    mp_mode = _check_mp(mixed_precision, be)
    _check_later("fit", profile_dir)
    shard_opt_state, zstage = _normalize_zero_stage(shard_opt_state,
                                                    zero_stage)
    pipeline_mode = mesh is not None and "stage" in tuple(
        getattr(mesh, "axis_names", ()))
    dp = _check_mesh_options("fit", be, mesh, shard_opt_state, zstage,
                             offload_opt_state, batch_size, chain_steps)
    n_proc, proc_idx, mp_replicated = _processes(mesh, pipeline_mode)
    _check_knobs(accum_steps, ema_decay, batch_size, "samples")
    if early_stop_patience and val is None:
        raise ValueError(
            "early_stop_patience watches the validation metric — pass "
            "val=(Xv, labels_or_targets) (evaluated every log_every "
            "steps)")
    if val_metric not in ("accuracy", "loss"):
        raise ValueError(
            f"val_metric must be 'accuracy' (val=(Xv, class labels)) or "
            f"'loss' (val=(Xv, targets) through the training loss — for "
            f"regression/reconstruction objectives), got {val_metric!r}")
    _check_chain(chain_steps, chain_shuffle, X.shape[0], batch_size,
                 f"and needs the dataset ({X.shape[0]} rows) to divide "
                 f"evenly into batches ({batch_size}): a ragged tail batch "
                 f"cannot ride the fixed-shape index window — trim the "
                 f"dataset or use chain_shuffle='host'")
    if pipeline_mode:
        # each accumulation chunk flows through the microbatch grid
        M = pipeline_microbatches
        chunk = batch_size // accum_steps
        if chunk % M != 0:
            raise ValueError(
                f"batch rows per accumulation chunk ({chunk}) must be "
                f"divisible by pipeline_microbatches ({M})")
        if (chunk // M) % dp != 0:
            raise ValueError(
                f"microbatch rows ({chunk // M}) must be divisible by the "
                f"data-axis size ({dp})")
        if pipeline_schedule not in ("gpipe", "circular"):
            raise ValueError(
                f"pipeline_schedule must be 'gpipe' or 'circular', got "
                f"{pipeline_schedule!r}")
        if X.shape[0] < batch_size:
            raise ValueError(
                f"pipeline training drops ragged batches (the microbatch "
                f"grid needs full ones): dataset ({X.shape[0]} rows) must "
                f"hold at least one batch ({batch_size})")
    elif mesh is not None:
        tail = X.shape[0] % batch_size
        if tail and (tail // accum_steps) % dp:
            raise ValueError(
                f"the epoch's last batch of {tail} rows (dataset "
                f"{X.shape[0]}, batch_size {batch_size}) does not split "
                f"evenly over the {dp} data ranks — trim the dataset")
        if (batch_size // accum_steps) % dp:
            raise ValueError(
                f"each accumulation chunk ({batch_size // accum_steps} "
                f"rows) must split evenly over the {dp} data ranks")
    # a mesh or an offloaded state runs unchained (the JAX package's gate)
    use_chain = _use_chain(be, chain_steps, chain_shuffle, X.size + Y.size,
                           "loader",
                           allowed=mesh is None and not offload_opt_state)
    chain_dev = use_chain and chain_shuffle != "host"
    opt = optimizer or sgd()
    if pipeline_mode:
        # ragged final batches cannot flow through the fixed microbatch
        # grid: the loader reshuffles instead (drop_last)
        steps_per_epoch = X.shape[0] // batch_size
    else:
        steps_per_epoch = (X.shape[0] + batch_size - 1) // batch_size
    total_steps = epochs * steps_per_epoch
    params = tuple(net.params)
    pins, part, layout = {}, None, "flat"
    if pipeline_mode:
        from ..parallel import ir_pipeline as IP
        from ..parallel.mesh import place

        S = mesh.shape["stage"]
        if pipeline_schedule == "circular":
            part = IP.partition_network_circular(net, S, pipeline_chunks,
                                                 mesh)
        else:
            part = IP.partition_network(net, S, mesh)
        if verbose:
            print(IP.describe_partition(part))
        params, opt_state, pins = _mesh_setup(
            part.flat_params(), IP.pipelined_specs(part, mesh), opt, mesh,
            be, zstage if shard_opt_state else 0)
        # the flat .state leaves' layout: the schedules reorder same-shaped
        # stacks and a packed leaf hides its rows, so a resume across
        # layouts is refused by name
        layout = f"pipeline:{pipeline_schedule}:S{S}"
        if pipeline_schedule == "circular":
            layout += f":V{pipeline_chunks}"
        packed = getattr(part, "packed", None)
        if packed is not None:
            layout += ":P" + "x".join(str(int(d)) for d in packed.shape)
        part = part.skeleton()
    elif mesh is not None:
        from ..parallel.mesh import param_specs, place

        params, opt_state, pins = _mesh_setup(
            params, param_specs(net.param_stack, mesh), opt, mesh, be,
            zstage if shard_opt_state else 0)
    else:
        opt_state = opt.init(params)
    if offload_opt_state:
        opt_state = _offload_state(opt_state, "fit")
    state_path = (checkpoint_path + ".state") if checkpoint_path else None
    # id-based struct keys (custom optimizers without `hyper`) do not
    # survive process restarts: only factory-made optimizers are checked
    opt_key = opt.struct_key() if opt.hyper is not None else None

    def as_network(ps) -> Network:
        # on a mesh the leaves stay Sharded, on the specs they trained on;
        # a pipeline's go back to the parameter stack, each layer's on its
        # stage's rank (ZeRO-3 blocks gathered over the data axis first);
        # in several processes whole on this process's device (a gather
        # of the host copies, which every process calls)
        if pipeline_mode and n_proc > 1:
            ps = tuple(be.asarray(p) for p in _global_host_tree(tuple(ps)))
            ps = part.unflatten(ps).to_network_params()
        elif pipeline_mode:
            if pins["param_unshard"] is not None:
                ps = pins["param_unshard"](ps)
            ps = part.unflatten(tuple(ps)).to_network_params()
        return Network(net.op, tuple(ps), net.act_names)

    def build_step(mp_active: bool):
        return make_opt_step(net, loss, be, opt, accum_steps=accum_steps,
                             clip_norm=clip_norm, mixed_precision=mp_active,
                             mesh=mesh, offload=offload_opt_state,
                             pipeline=(part, pipeline_microbatches,
                                       pipeline_schedule)
                             if pipeline_mode else None, **pins)

    # the records' `t` counts from here, so the first one holds the
    # loader's build and its first copies as well as the first step
    logger = MetricsLogger(metrics_path)
    loader = chain_fn = None
    try:
        if mp_replicated:
            # a stage-only mesh across processes: every process loads the
            # identical full stream (same seed); batches replicate
            loader = NativeLoader(X, Y, batch=batch_size, seed=seed,
                                  drop_last=True)
        elif n_proc > 1:
            # each process loads only its disjoint shard: its rows of the
            # global batch (assembled in next_batch)
            loader = NativeLoader(X, Y, batch=batch_size // n_proc,
                                  seed=seed, shard=(proc_idx, n_proc),
                                  drop_last=pipeline_mode)
        else:
            loader = NativeLoader(X, Y, batch=batch_size, seed=seed,
                                  drop_last=pipeline_mode,
                                  index_mode=use_chain and not chain_dev)
        mp_active, mp_rec = mp_mode == "bf16", None
        if mp_mode == "auto":
            def dummy_args():
                rows = min(batch_size, X.shape[0])
                xb = be.zeros((rows,) + tuple(X.shape[1:]))
                yb = be.zeros((rows,) + tuple(Y.shape[1:]))
                return (_scalars([lr], _like(params))[0], xb, yb, opt_state,
                        params)

            # the ZeRO rung changes the step's collectives: a verdict
            # measured at one must not be reused at another
            route_key = ("mproute", loss.struct_key(), opt.struct_key(),
                         clip_norm, int(accum_steps), int(batch_size), mesh,
                         layout, pipeline_microbatches if pipeline_mode
                         else None, zstage if shard_opt_state else 0,
                         bool(offload_opt_state), tuple(X.shape[1:]),
                         tuple(Y.shape[1:])) + be.cache_key()
            mp_active, mp_rec = _resolve_mp_route(
                net, build_step, dummy_args, route_key, resume=resume,
                state_path=state_path, carry_from=3, verbose=verbose,
                graphs=mesh is None and not offload_opt_state)
        step_fn = build_step(mp_active)
        # the route travels with every .state checkpoint, so resume
        # re-takes it without measuring
        state_meta = {"layout": layout}
        if mp_mode != "off":
            state_meta["mp_route"] = "bf16" if mp_active else "f32"
        step = 0
        r_ema = None
        if resume and state_path and os.path.exists(state_path):
            from ..utils.checkpoint import load_train_state

            rparams, opt_state, step, r_ema = load_train_state(
                state_path, opt_state, opt_key=opt_key,
                expect_meta={"layout": layout}, with_ema=True)
            if len(rparams) != len(params):
                raise ValueError(
                    f"checkpoint holds {len(rparams)} parameter leaves but "
                    f"this configuration expects {len(params)} -- resume "
                    f"with the same model/pipeline configuration")
            if mesh is not None:
                # each leaf back on the spec it trains on (ZeRO-3: its
                # block); the moments came back on their templates' specs
                params = tuple(place(p, t.spec, mesh, be.dtype)
                               for p, t in zip(rparams, params))
            else:
                params = tuple(be.asarray(p) for p in rparams)
            # stream position == global step: the resumed run continues
            # the epoch's shuffle where the saving run stopped (the device
            # streams are a function of the step: nothing to skip)
            if step < total_steps and not chain_dev:
                loader.skip(step)
            if verbose:
                print(f"resumed from {state_path} at step {step} "
                      f"({max(total_steps - step, 0)} of {total_steps} "
                      f"steps remaining)")
        if mp_mode != "off":
            # the decision lands in the metrics JSONL too
            logger.log(step, mp_route=state_meta["mp_route"],
                       **(mp_rec or {}))
        ema = None
        if ema_decay is not None:
            ema = _ema_init(r_ema, params, be, step, "fit")
            ema_step = _ema_update(ema_decay)
        lr_at = lr_schedule or (lambda s: lr)
        window_len = torn = None

        if use_chain:
            # the loader's own float32 rows are the chained path's data:
            # gathering them on the device gives bit for bit the rows the
            # loader assembles on the host
            chain_fn, window_len = _chained(
                be, loader.X, loader.Y, step_fn, 1, lambda new: tuple(new[-1]),
                params[0].dtype, ema_decay=ema_decay,
                chain_steps=chain_steps, chain_shuffle=chain_shuffle,
                seed=seed, batch=batch_size, steps_per_epoch=steps_per_epoch,
                step=step, total_steps=total_steps, log_every=log_every,
                checkpoint_every=checkpoint_every if checkpoint_path else 0,
                ragged=X.shape[0] % batch_size != 0)
            torn = lambda: chain_fn.busy  # noqa: E731

            def run_window(s, k, state):
                ps, o, e = state
                sel = (s if chain_dev else
                       np.stack([loader.next_indices() for _ in range(k)]))
                lrs = [lr_at(i) for i in range(s, s + k)]
                v, o, ps, e = chain_fn(lrs, sel, o, ps, e or ())
                return v, (ps, o, e or None)
        else:
            if (prefetch > 1 and be.name == "torch" and step < total_steps
                    and n_proc == 1):
                next_batch = DevicePrefetcher(loader, be.device, be.dtype,
                                              depth=prefetch).next
            else:
                from ..parallel.mesh import global_batch

                chunks = accum_steps * (pipeline_microbatches
                                        if pipeline_mode else 1)

                def next_batch():
                    xb, yb = loader.next()
                    xb, yb = be.asarray(xb), be.asarray(yb)
                    if n_proc > 1 and not mp_replicated:
                        xb = global_batch(xb, mesh, chunks)
                        yb = global_batch(yb, mesh, chunks)
                    return xb, yb

            def run_window(s, k, state):
                ps, o, e = state
                (lr_now,) = _scalars([lr_at(s)], _like(ps))
                xb, yb = next_batch()
                v, o, ps = step_fn(lr_now, xb, yb, o, ps)
                return v, (ps, o, None if e is None else ema_step(e, ps))

        if verbose and mesh is not None and not pipeline_mode:
            print(_memory_line(net, opt, batch_size, mesh, shard_opt_state,
                               zstage, mp_active, offload_opt_state))

        evaluate = None
        if val is not None and pipeline_mode:
            evaluate = _staged_evaluate(net, loss, be, as_network, val,
                                        val_metric)
        elif val is not None and mesh is not None:
            evaluate = _mesh_evaluate(net, loss, be, mesh,
                                      pins["param_unshard"], val, val_metric)
        elif val is not None:
            if val_metric == "accuracy":
                xv, labels = be.asarray(val[0]), np.asarray(val[1])

                def evaluate(state):
                    a = accuracy(as_network(state[0]), be, xv, labels)
                    return "val_acc", a, a
            else:
                def evaluate(state):
                    v = batch_loss(as_network(state[0]), loss, be, val[0],
                                   val[1])
                    return "val_loss", v, -v

        save = None
        if checkpoint_path:
            from ..utils.checkpoint import (save_network_async,
                                            save_train_state_async)

            def save(state, at):
                if offload_opt_state:  # the copies out, on every rank's card
                    _sync_cards(mesh.rank_devices if mesh is not None
                                else (be.device,))
                if n_proc > 1:
                    # leaves across processes: every process joins the
                    # gather of the host copies, process 0 writes
                    host = _global_host_tree(tuple(state), mesh)
                    if proc_idx != 0:
                        return ()
                    ps = host[0]
                    if pipeline_mode:
                        ps = part.unflatten(tuple(ps)).to_network_params()
                    return (save_network_async(
                                checkpoint_path,
                                Network(net.op, tuple(ps), net.act_names)),
                            save_train_state_async(
                                state_path, host[0], host[1], at,
                                opt_key=opt_key, ema=host[2],
                                extra_meta=state_meta))
                # sharded leaves gather to the host in the checkpoint writer
                return (save_network_async(checkpoint_path,
                                           as_network(state[0])),
                        save_train_state_async(state_path, state[0],
                                               state[1], at, opt_key=opt_key,
                                               ema=state[2],
                                               extra_meta=state_meta))

        (params, _, ema), history, step = _drive(
            (params, opt_state, ema), run_window, step=step,
            total_steps=total_steps, steps_per_epoch=steps_per_epoch,
            window_len=window_len, log_every=log_every, logger=logger,
            evaluate=evaluate, early_stop_patience=early_stop_patience,
            save=save, checkpoint_every=checkpoint_every, verbose=verbose,
            torn=torn, interrupt_save=n_proc == 1)
        if n_proc > 1:  # process 0's checkpoint writes are on disk
            from ..parallel.distributed import barrier

            barrier(mesh.procs)
    finally:
        if loader is not None:
            loader.close()
        if chain_fn is not None:
            chain_fn.close()
        logger.close()
    return FitResult(as_network(params), history, step,
                     ema_net=None if ema is None else as_network(ema))


def _seq_train_step(rnet: RecurrentNetwork, loss: TOp, be: Backend, n: int,
                    opt: Optional[Optimizer] = None,
                    clip_norm: Optional[float] = None, remat_every=None,
                    accum_steps: int = 1, offload_tape: bool = False,
                    mixed_precision: bool = False, mesh=None,
                    grad_constrain=None, param_unshard=None,
                    offload: bool = False) -> Callable:
    """One sequence-batch step: the scan-BPTT mean loss and gradients
    (``training.make_seq_mean_grads``, the step ``train_batch`` takes) and
    the update, the logged loss from the same pass.

    Without ``opt``: ``fn(rs, rp, xb, tb, states, params) -> (mean_loss,
    new_states, new_params)``, the reference's dual-rate SGD
    (:func:`~tensor_ops_tpu_torch.models.recurrent.dual_rate_sgd`).  With
    ``opt``: ``fn(ratio, rp, xb, tb, opt_state, states, params) ->
    (mean_loss, opt_state, new_states, new_params)``: states and params
    update through the optimizer at rate ``rp``, the state gradients
    scaled first by ``ratio`` = rate_state / rate_param, an explicit
    argument: a warmup schedule reaches rp == 0, where rs / rp taken
    inside the step would be 0/0.  The rates are floats or 0-d tensors.
    ``clip_norm`` clips the joint state+param gradient; ``remat_every``
    and ``offload_tape`` go to the scan (``ScanOp``); ``accum_steps > 1``
    accumulates equal chunks (:func:`_accum`), torch only.
    ``mixed_precision`` runs the scan-BPTT forward and backward in bf16 on
    full-precision master states and params, the values and gradients
    upcast to f32 before the batch mean (as :func:`make_opt_step`).
    Cached on the step op.  :class:`_ChainedStep` chains it (a table row a
    step: ``(rs, rp)``, or with ``opt`` ``(ratio, rp)``), the EMA over the
    states and params.

    ``mesh`` and the ZeRO pins (``grad_constrain``, ``param_unshard``)
    make it the data-parallel step (:func:`_mesh_step`, as
    ``make_opt_step``'s): states and params are
    :class:`~tensor_ops_tpu_torch.parallel.mesh.Sharded` leaves (ZeRO over
    the joint states + params); ``offload`` keeps the optimizer state in
    pinned host memory between steps."""
    if mixed_precision and be.name != "torch":
        raise ValueError("mixed_precision requires the torch backend — "
                         "fit_sequences gates this itself")
    k = len(rnet.states)

    def specs(pin):
        return None if pin is None else pin.specs

    key = ("seq_fit_step", loss.struct_key(), n,
           opt.struct_key() if opt is not None else None, clip_norm,
           remat_every, int(accum_steps), bool(offload_tape), mesh,
           specs(grad_constrain), specs(param_unshard), bool(offload),
           bool(mixed_precision)) + be.cache_key()
    fn = rnet.op._compiled.get(key)
    if fn is not None:
        return fn

    def grads_on(be_d):
        if not mixed_precision:
            return make_seq_mean_grads(rnet, loss, be_d, n,
                                       remat_every=remat_every,
                                       offload_tape=offload_tape)
        from ..backend.torch_backend import TorchBackend

        bf16 = torch.bfloat16
        lp_grads = make_seq_mean_grads(
            rnet, loss, TorchBackend(bf16, be_d.device), n,
            remat_every=remat_every, offload_tape=offload_tape,
            upcast=torch.float32)

        def mean_grads(xb, tb, leaves):
            return lp_grads(xb.to(bf16), tb.to(bf16),
                            tuple(x.to(bf16) for x in leaves))

        return mean_grads

    if mesh is not None:
        if opt is None:
            def update(sc, st, ls, gs):
                new_s, new_p = dual_rate_sgd(sc[0], sc[1], ls[:k], ls[k:],
                                             gs[:k], gs[k:])
                return st, new_s + new_p
        else:
            def update(sc, st, ls, gs):
                scaled = tuple(sc[0] * g for g in gs[:k]) + tuple(gs[k:])
                return opt.update(st, ls, scaled, sc[1])

        inner = _mesh_step(
            mesh, _seq_group_vags(rnet, mesh, be, grads_on), update,
            accum_steps=accum_steps, clip_norm=clip_norm,
            elementwise=opt is None or opt.name in _ELEMENTWISE,
            grad_constrain=grad_constrain, param_unshard=param_unshard,
            offload=offload)
        if opt is None:
            def fn(rs, rp, xb, tb, states, params):
                v, _, ls = inner((rs, rp), xb, tb, (),
                                 tuple(states) + tuple(params))
                return v, ls[:k], ls[k:]
        else:
            def fn(ratio, rp, xb, tb, opt_state, states, params):
                v, o, ls = inner((ratio, rp), xb, tb, opt_state,
                                 tuple(states) + tuple(params))
                return v, o, ls[:k], ls[k:]
        rnet.op._compiled[key] = fn
        return fn
    mean_grads = grads_on(be)

    def grads_of(xb, tb, states, params):
        leaves = tuple(states) + tuple(params)
        if accum_steps > 1:
            v, mean = _accum(lambda x, t: mean_grads(x, t, leaves), xb, tb,
                             accum_steps)
        else:
            v, mean = mean_grads(xb, tb, leaves)
        if clip_norm:
            mean = clip_by_global_norm(mean, clip_norm)
        return v, leaves, mean

    if opt is None:
        def fn(rs, rp, xb, tb, states, params):
            v, _, mean = grads_of(xb, tb, states, params)
            return (v,) + dual_rate_sgd(rs, rp, states, params, mean[:k],
                                        mean[k:])
    else:
        def fn(ratio, rp, xb, tb, opt_state, states, params):
            v, leaves, mean = grads_of(xb, tb, states, params)
            scaled = tuple(ratio * g for g in mean[:k]) + mean[k:]
            opt_state, leaves = opt.update(opt_state, leaves, scaled, rp)
            return v, opt_state, tuple(leaves[:k]), tuple(leaves[k:])

        if offload:
            fn = _offload_step(fn, be.device, 4)
    rnet.op._compiled[key] = fn
    return fn


def _seq_group_vags(rnet: RecurrentNetwork, mesh, be: Backend,
                    grads_on: Callable) -> list:
    """The sequence step's gradient function of each data rank for
    :func:`_mesh_step`: ``grads_on(be_r)`` on the rank's card; on a model
    axis > 1 the scan runs on each model rank on its leaves all-gathered
    over the model axis (``parallel.tp.gathered_vag``, one warning per
    network): the cell is no ffLayer segment the executor can split."""
    from ..parallel.mesh import MODEL_AXIS, _rank_backend, param_specs

    tp = mesh.shape[MODEL_AXIS]
    if tp == 1:
        return [grads_on(_rank_backend(be, d)) for d in mesh.data_devices]
    from ..parallel.tp import gathered_vag, warn_gathered

    warn_gathered(rnet.op, [f"the recurrent cell {rnet.op!r} (its "
                            f"sequence scan)"], tp)
    specs = (tuple((None,) * s.dim() for s in rnet.states)
             + param_specs(rnet.param_stack, mesh))
    return [gathered_vag([grads_on(_rank_backend(be, d)) for d in row],
                         specs, row) for row in mesh.devices]


class _SeqStream:
    """The shuffled sequence-minibatch stream (the JAX package's): one
    ``np.random.default_rng(seed)`` permutation per epoch, ragged tails
    dropped, and stream position == global step, rebuilt from
    ``start_step`` alone, so a crash/resume chain draws the same batches."""

    def __init__(self, XS, TS, batch: int, seed: int, start_step: int,
                 steps_per_epoch: int, shard=None):
        self.XS, self.TS, self.batch = XS, TS, batch
        self.spe = steps_per_epoch
        # several processes: every process draws the SAME global
        # permutation (same seed) and takes its contiguous row block of
        # each batch; together they assemble the one-process batch
        self.shard = shard
        self._rng = np.random.default_rng(seed)
        self._perm = self._rng.permutation(XS.shape[0])
        for _ in range(start_step // steps_per_epoch):
            self._perm = self._rng.permutation(XS.shape[0])
        self._b = start_step % steps_per_epoch

    def next(self):
        idx = self.next_indices()
        return self.XS[idx], self.TS[idx]

    def next_indices(self) -> np.ndarray:
        """The next batch's sequence indices, advancing the same stream
        position as :meth:`next`: chained host-mode windows consume it."""
        idx = self._perm[self._b * self.batch:(self._b + 1) * self.batch]
        self._b += 1
        if self._b == self.spe:
            self._b = 0
            self._perm = self._rng.permutation(self.XS.shape[0])
        if self.shard is not None:
            rank, n = self.shard
            local = self.batch // n
            idx = idx[rank * local:(rank + 1) * local]
        return idx


def fit_sequences(
    rnet: RecurrentNetwork,
    loss: TOp,
    be: Backend,
    XS: np.ndarray,
    TS: np.ndarray,
    *,
    epochs: int = 1,
    batch_size: int = 16,
    rate_state: float = 0.01,
    rate_param: float = 0.05,
    optimizer: Optional[Optimizer] = None,
    accum_steps: int = 1,
    clip_norm: Optional[float] = None,
    lr_schedule: Optional[Callable[[int], float]] = None,
    mixed_precision=False,
    shard_opt_state: bool = False,
    zero_stage: Optional[int] = None,
    offload_opt_state: bool = False,
    offload_activations: bool = False,
    ema_decay: Optional[float] = None,
    val: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    early_stop_patience: int = 0,
    remat_every=None,
    mesh=None,
    seed: int = 0,
    metrics_path: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    prefetch: int = 2,
    chain_steps="auto",
    chain_shuffle: str = "host",
    log_every: int = 10,
    verbose: bool = True,
) -> FitSeqResult:
    """The production loop of the recurrent family, the JAX package's
    ``fit_sequences`` single-device: ``fit``'s surface over scan-BPTT
    sequence minibatches with the reference's dual state/param rates
    (``trainNetwork'``, ``Recurrent.hs:326-354``), on ``fit``'s window
    driver (:func:`_drive`).

    ``XS``: ``(N, n, *in_shape)`` sequences, ``TS`` their targets; one
    epoch is ``N // batch_size`` steps of the :class:`_SeqStream` shuffle
    (ragged tails dropped).  ``epochs`` is the TOTAL budget: a resumed run
    executes only the remaining steps and fast-forwards the shuffle to the
    restored step, so a crash/resume chain equals the uninterrupted run.
    On a ``TorchBackend``, ``prefetch > 1`` keeps that many batches in
    flight to the device.  Checkpoints: ``checkpoint_path`` saves the
    servable recurrent net (``save_recurrent``) and a sibling ``.state``
    with the states and params (one leaf list, states first), the
    optimizer state, the EMA and the step; Ctrl-C saves one at the last
    finished step, as in ``fit``.

    ``optimizer`` (e.g. ``adam()``) replaces dual-rate SGD: states and
    params update through it at ``rate_param``, the state gradients
    scaled by ``rate_state / rate_param``.  ``lr_schedule`` maps the
    global step to the param rate (the state rate keeps its ratio);
    ``clip_norm`` clips the joint gradient by its global L2 norm;
    ``remat_every`` checkpoints the scan-BPTT backward;
    ``offload_activations=True`` streams its taped carries through pinned
    host memory (``ScanOp(offload_tape=True)``; on CPU tensors it changes
    nothing); ``accum_steps`` accumulates that many equal chunks of a
    batch (torch only); ``ema_decay`` keeps a Polyak average of the states
    and params (``FitSeqResult.ema_net``); ``val=(XSv, TSv)`` logs the
    held-out mean sequence loss (``val_loss``) every ``log_every`` steps
    and ``early_stop_patience=k`` stops once it has not improved over k
    evaluations in a row.  The ``.state`` format is the JAX package's.

    ``chain_steps`` / ``chain_shuffle`` chain the windows between
    observation boundaries exactly as ``fit``'s do (no ragged batches
    here: the stream drops them), over the sequences held on the device;
    ``"host"`` consumes :class:`_SeqStream`'s indices, bit for bit the
    unchained run; ``"auto"`` backs off with ``offload_activations``
    (whose host copies cannot ride a graph; an int ``chain_steps > 1``
    with it raises).  ``mixed_precision`` runs the scan-BPTT step in bf16
    on full-precision masters, routed as in ``fit`` (``True`` measures
    once, records ``mp_route``).  ``mesh``, ZeRO and ``offload_opt_state``
    as in ``fit``, over the joint states + params: the states replicate,
    the params take ``param_specs``; ZeRO and offload need ``optimizer``
    (dual-rate SGD has no state); a mesh with a ``stage`` axis is refused
    (the scan is sequential over time).  On a model axis > 1 the states
    replicate, the params take ``param_specs`` and the scan runs on the
    leaves all-gathered over the model axis at each step (one warning):
    the cell is no ffLayer segment the tensor-parallel executor splits.
    The returned leaves stay ``Sharded``, and ``val`` runs on the mesh, as
    in ``fit``."""
    mp_mode = _check_mp(mixed_precision, be)
    shard_opt_state, zstage = _normalize_zero_stage(shard_opt_state,
                                                    zero_stage)
    if mesh is not None and "stage" in tuple(getattr(mesh, "axis_names",
                                                     ())):
        raise ValueError(
            "fit_sequences has no pipeline mode (the recurrent scan is "
            "sequential over time, so S-1 stages would idle); pass a "
            "(data, model) mesh from make_mesh")
    dp = _check_mesh_options("fit_sequences", be, mesh, shard_opt_state,
                             zstage, offload_opt_state, batch_size,
                             chain_steps)
    n_proc, proc_idx, _ = _processes(mesh)
    if shard_opt_state and optimizer is None:
        raise ValueError(
            "shard_opt_state needs optimizer state to shard — dual-rate "
            "SGD is stateless; pass optimizer=adam() (or momentum())")
    if offload_opt_state and optimizer is None:
        raise ValueError(
            "offload_opt_state needs optimizer state to offload — "
            "dual-rate SGD is stateless; pass optimizer=adam() (or "
            "momentum())")
    if mesh is not None and (batch_size // accum_steps) % dp:
        raise ValueError(
            f"each accumulation chunk ({batch_size // accum_steps} "
            f"sequences) must split evenly over the {dp} data ranks")
    if offload_activations and be.name == "numpy":
        raise ValueError(
            "offload_activations streams the scan-BPTT carry tape "
            "through pinned host memory and requires the torch backend "
            "(the numpy oracle's tape is host-resident already)")
    if early_stop_patience and val is None:
        raise ValueError(
            "early_stop_patience watches the held-out sequence loss — "
            "pass val=(XSv, TSv) (evaluated every log_every steps)")
    _check_knobs(accum_steps, ema_decay, batch_size, "sequences")
    if accum_steps > 1 and be.name == "numpy":
        raise ValueError("accum_steps > 1 requires the torch backend (the "
                         "numpy oracle's per-sequence loop has no batched "
                         "activations to amortize)")
    _check_chain(chain_steps, chain_shuffle, XS.shape[0], batch_size,
                 f"over {XS.shape[0]} sequences, which must divide into "
                 f"whole batches of {batch_size} — trim the dataset or use "
                 f"chain_shuffle='host'")
    if (isinstance(chain_steps, int) and chain_steps > 1
            and offload_activations):
        raise ValueError(
            "chain_steps > 1 cannot combine with offload_activations: the "
            "host copies of the carry tape cannot ride a captured step — "
            "use chain_steps='auto' (which backs off) or chain_steps=1")
    N = XS.shape[0]
    if N < batch_size:
        raise ValueError(
            f"dataset ({N} sequences) must hold at least one batch "
            f"({batch_size}); ragged batches are dropped")
    use_chain = _use_chain(be, chain_steps, chain_shuffle,
                           XS.size + TS.size, "stream",
                           allowed=not (offload_activations or offload_opt_state
                                        or mesh is not None))
    chain_dev = use_chain and chain_shuffle != "host"
    opt = optimizer
    steps_per_epoch = N // batch_size
    total_steps = epochs * steps_per_epoch
    k = len(rnet.states)
    leaves = tuple(rnet.states) + tuple(rnet.params)
    pins = {}
    if mesh is not None:
        from ..parallel.mesh import param_specs, place

        # states replicate (they are the network's, not a layer's)
        specs = (tuple((None,) * s.dim() if isinstance(s, torch.Tensor)
                       else (None,) * np.ndim(s) for s in rnet.states)
                 + param_specs(rnet.param_stack, mesh))
        leaves, opt_state, pins = _mesh_setup(
            leaves, specs, opt, mesh, be, zstage if shard_opt_state else 0)
    else:
        opt_state = opt.init(leaves) if opt is not None else ()
    if offload_opt_state:
        opt_state = _offload_state(opt_state, "fit_sequences")
    state_path = (checkpoint_path + ".state") if checkpoint_path else None
    opt_key = (opt.struct_key()
               if opt is not None and opt.hyper is not None else None)
    ratio = rate_state / rate_param if opt is not None else None

    def as_rnet(ls) -> RecurrentNetwork:
        # on a mesh the leaves stay Sharded, on the specs they trained on
        ls = tuple(ls)
        return RecurrentNetwork(rnet.op, ls[:k], ls[k:], rnet.arch)

    def build_step(mp_active: bool):
        return _seq_train_step(rnet, loss, be, XS.shape[1], opt=opt,
                               clip_norm=clip_norm, remat_every=remat_every,
                               accum_steps=accum_steps,
                               offload_tape=offload_activations,
                               mixed_precision=mp_active, mesh=mesh,
                               offload=offload_opt_state, **pins)

    logger = MetricsLogger(metrics_path)
    chain_fn = None
    try:
        mp_active, mp_rec = mp_mode == "bf16", None
        if mp_mode == "auto":
            def dummy_args():
                xb = be.zeros((batch_size,) + tuple(XS.shape[1:]))
                tb = be.zeros((batch_size,) + tuple(TS.shape[1:]))
                rs, rp = _scalars((rate_state, rate_param), _like(leaves))
                if opt is None:
                    return (rs, rp, xb, tb, leaves[:k], leaves[k:])
                return (ratio, rp, xb, tb, opt_state, leaves[:k], leaves[k:])

            route_key = ("mproute_seq", loss.struct_key(),
                         opt.struct_key() if opt is not None else None,
                         clip_norm, int(accum_steps), int(batch_size),
                         remat_every, bool(offload_activations), mesh,
                         zstage if shard_opt_state else 0,
                         bool(offload_opt_state), tuple(XS.shape[1:]),
                         tuple(TS.shape[1:])) + be.cache_key()
            mp_active, mp_rec = _resolve_mp_route(
                rnet, build_step, dummy_args, route_key, resume=resume,
                state_path=state_path, carry_from=4, verbose=verbose,
                graphs=mesh is None and not offload_opt_state)
        step_fn = build_step(mp_active)
        state_meta = ({"mp_route": "bf16" if mp_active else "f32"}
                      if mp_mode != "off" else None)
        step = 0
        r_ema = None
        if resume and state_path and os.path.exists(state_path):
            from ..utils.checkpoint import load_train_state

            # the .state "params" slot holds the states, then the params
            flat, opt_state, step, r_ema = load_train_state(
                state_path, opt_state, opt_key=opt_key, with_ema=True)
            if len(flat) != len(leaves):
                raise ValueError(
                    f"checkpoint has {len(flat)} leaves, the network needs "
                    f"{k} states + {len(rnet.params)} params")
            if mesh is not None:
                leaves = tuple(place(x, t.spec, mesh, be.dtype)
                               for x, t in zip(flat, leaves))
            else:
                leaves = tuple(be.asarray(x) for x in flat)
            if verbose:
                print(f"resumed from {state_path} at step {step} "
                      f"({max(total_steps - step, 0)} of {total_steps} "
                      f"steps remaining)")
        if mp_mode != "off":
            logger.log(step, mp_route=state_meta["mp_route"],
                       **(mp_rec or {}))
        ema = None
        if ema_decay is not None:
            ema = _ema_init(r_ema, leaves, be, step, "fit_sequences")
            ema_step = _ema_update(ema_decay)

        stream = _SeqStream(XS, TS, batch_size, seed, step, steps_per_epoch,
                            shard=(proc_idx, n_proc) if n_proc > 1 else None)

        def rates_at(s):
            if lr_schedule is None:
                return rate_state, rate_param
            rp = lr_schedule(s)
            return rate_state * (rp / rate_param), rp

        window_len = torn = None
        if use_chain:
            # the whole dataset cast once: gathering rows of the cast copy
            # is bit for bit the unchained path's cast of gathered rows
            chain_fn, window_len = _chained(
                be, XS, TS, step_fn, 2,
                lambda new: tuple(new[-2]) + tuple(new[-1]),
                leaves[-1].dtype, ema_decay=ema_decay,
                chain_steps=chain_steps, chain_shuffle=chain_shuffle,
                seed=seed, batch=batch_size, steps_per_epoch=steps_per_epoch,
                step=step, total_steps=total_steps, log_every=log_every,
                checkpoint_every=checkpoint_every if checkpoint_path else 0,
                ragged=False)
            torn = lambda: chain_fn.busy  # noqa: E731

            def run_window(s, kw, state):
                ls, o, e = state
                sel = (s if chain_dev else
                       np.stack([stream.next_indices() for _ in range(kw)]))
                rates = [rates_at(i) for i in range(s, s + kw)]
                opt_part = ()
                if opt is not None:
                    # the ratio rides the scalar table beside rp
                    rates = [(ratio, rp) for _, rp in rates]
                    opt_part = (o,)
                v, *out, e = chain_fn(rates, sel, *opt_part, ls[:k], ls[k:],
                                      e or ())
                if opt is not None:
                    o = out[0]
                return v, (out[-2] + out[-1], o, e or None)
        else:
            if (prefetch > 1 and be.name == "torch" and step < total_steps
                    and n_proc == 1):
                next_batch = DevicePrefetcher(stream, be.device, be.dtype,
                                              depth=prefetch).next
            else:
                from ..parallel.mesh import global_batch

                def next_batch():
                    xb, tb = stream.next()
                    xb, tb = be.asarray(xb), be.asarray(tb)
                    if n_proc > 1:
                        xb = global_batch(xb, mesh, accum_steps)
                        tb = global_batch(tb, mesh, accum_steps)
                    return xb, tb

            def run_window(s, kw, state):
                ls, o, e = state
                rs, rp = _scalars(rates_at(s), _like(ls))
                xb, tb = next_batch()
                if opt is None:
                    v, new_s, new_p = step_fn(rs, rp, xb, tb, ls[:k], ls[k:])
                else:
                    # the ratio is schedule-invariant (rs and rp scale
                    # together); passed explicitly, a warmup rp == 0 stays
                    # finite
                    v, o, new_s, new_p = step_fn(ratio, rp, xb, tb, o,
                                                 ls[:k], ls[k:])
                ls = new_s + new_p
                return v, (ls, o, None if e is None else ema_step(e, ls))

        evaluate = None
        if val is not None and mesh is not None:
            evaluate = _seq_mesh_evaluate(rnet, loss, be, mesh,
                                          pins["param_unshard"], k, val)
        elif val is not None:
            def evaluate(state):
                v = seq_batch_loss(as_rnet(state[0]), loss, be, val[0],
                                   val[1])
                return "val_loss", v, -v

        save = None
        if checkpoint_path:
            from ..utils.checkpoint import (save_recurrent_async,
                                            save_train_state_async)

            def save(state, at):
                if offload_opt_state:  # the copies out, on every rank's card
                    _sync_cards(mesh.rank_devices if mesh is not None
                                else (be.device,))
                if n_proc > 1:
                    # leaves across processes: every process joins the
                    # gather of the host copies, process 0 writes
                    state = _global_host_tree(tuple(state), mesh)
                    if proc_idx != 0:
                        return ()
                ls = tuple(state[0])
                return (save_recurrent_async(checkpoint_path,
                                             RecurrentNetwork(
                                                 rnet.op, ls[:k], ls[k:],
                                                 rnet.arch)),
                        save_train_state_async(state_path, state[0],
                                               state[1], at, opt_key=opt_key,
                                               ema=state[2],
                                               extra_meta=state_meta))

        (leaves, _, ema), history, step = _drive(
            (leaves, opt_state, ema), run_window, step=step,
            total_steps=total_steps, steps_per_epoch=steps_per_epoch,
            window_len=window_len, log_every=log_every, logger=logger,
            evaluate=evaluate, early_stop_patience=early_stop_patience,
            save=save, checkpoint_every=checkpoint_every, verbose=verbose,
            torn=torn, interrupt_save=n_proc == 1)
        if n_proc > 1:  # process 0's checkpoint writes are on disk
            from ..parallel.distributed import barrier

            barrier(mesh.procs)
    finally:
        if chain_fn is not None:
            chain_fn.close()
        logger.close()
    return FitSeqResult(as_rnet(leaves), history, step,
                        ema_net=None if ema is None else as_rnet(ema))
