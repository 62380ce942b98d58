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

Both loops run on :func:`_drive`, the window driver: step, log boundary,
validation, early stop, checkpoints and the Ctrl-C checkpoint, independent
of what a step computes.  This slice runs single-device and unchained;
the options of the JAX package's loops that need the rest of the port
raise ``ValueError`` naming their ROADMAP item.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np

from ..backend.base import Backend
from ..ops.ir import TOp
from ..utils.metrics import MetricsLogger
from ..utils.native import DevicePrefetcher, NativeLoader
from .feedforward import Network
from .optim import Optimizer, clip_by_global_norm, sgd
from .recurrent import RecurrentNetwork, dual_rate_sgd
from .training import (accuracy, batch_loss, make_mean_grads,
                       make_seq_mean_grads, seq_batch_loss)


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


def make_opt_step(net: Network, loss: TOp, be: Backend, opt: Optimizer,
                  accum_steps: int = 1,
                  clip_norm: Optional[float] = None) -> Callable:
    """``(lr, xb, yb, opt_state, params) -> (loss, opt_state, params)``:
    one optimizer step on a batch.  ``loss`` comes back as a 0-d tensor on
    the device (no synchronise), or a float on the NumPy oracle.
    ``accum_steps > 1`` takes the batch mean as the sum of equal chunks'
    means over their count (:func:`_accum`); the NumPy oracle loops over
    the whole batch's samples whatever ``accum_steps``, as the JAX
    package's numpy branch does (the same mean).  Cached on the network's
    op by the loss's and optimizer's structural keys."""
    key = ("optstep", loss.struct_key(), opt.struct_key(), int(accum_steps),
           clip_norm) + be.cache_key()
    fn = net.op._compiled.get(key)
    if fn is not None:
        return fn
    mean_grads = make_mean_grads(net, loss, be)

    def step(lr, xb, yb, opt_state, params):
        if accum_steps > 1 and be.name != "numpy":
            v, grads = _accum(lambda x, y: mean_grads(x, y, *params), xb, yb,
                              accum_steps)
        else:
            v, grads = mean_grads(xb, yb, *params)
        if clip_norm:
            grads = clip_by_global_norm(grads, clip_norm)
        opt_state, params = opt.update(opt_state, tuple(params), grads, lr)
        return v, opt_state, params

    net.op._compiled[key] = step
    return step


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
        return tuple(be.asarray(e) for e in r_ema)
    if resumed_step > 0:
        warnings.warn(
            f"{label}: the resumed checkpoint carries no EMA (the saving "
            f"run had ema_decay off) — the Polyak average restarts from "
            f"the restored params at step {resumed_step}", stacklevel=3)
    return tuple(leaves)


def _drive(state, step_fn: Callable, next_batch: Callable, *, step: int,
           total_steps: int, steps_per_epoch: int,
           lr_at: Callable[[int], Any], log_every: int,
           logger: MetricsLogger, evaluate: Optional[Callable] = None,
           early_stop_patience: int = 0, save: Optional[Callable] = None,
           checkpoint_every: int = 0, verbose: bool = True):
    """The window driver of both loops: run ``step_fn`` from global step
    ``step`` to ``total_steps`` and return ``(state, history, step)``.

    Each step is ``v, state = step_fn(lr_at(step), *next_batch(), state)``
    under :class:`_sigint_shield`; a snapshot ``(state, step)`` replaced
    by one assignment after each step is what a Ctrl-C saves.  A log
    boundary (every ``log_every`` steps, and the run's first step) reads
    the loss (one synchronise), calls ``evaluate(state) -> (name, value,
    score)`` when given (higher score is better; ``early_stop_patience``
    evaluations without a gain stop the run), and appends the record
    ``logger.log`` makes (its ``t`` is the host clock after that
    synchronise and the evaluation) to the history.  A boundary without
    ``evaluate`` reads its loss at once too, where the JAX package's
    ``fit`` defers that read a few windows: the host waits there for the
    card.  Every ``checkpoint_every`` steps ``save(state, step)`` returns
    futures of asynchronous writes, joined before the driver returns; a
    write error is raised unless another exception is already unwinding.
    On ``KeyboardInterrupt`` with ``save`` given and a step taken, the
    snapshot is saved (after the writes in flight) before it propagates,
    whatever ``checkpoint_every``: resuming from it continues exactly."""
    history = []
    saves = _CheckpointWrites()
    best, since_best = float("-inf"), 0
    first = step + 1  # a resumed run logs its first step too
    snap = (state, step)
    try:
        while step < total_steps:
            epoch = step // steps_per_epoch
            lr_now = lr_at(step)
            xb, yb = next_batch()
            with _sigint_shield():
                v, new_state = step_fn(lr_now, xb, yb, state)
                snap = (new_state, step + 1)
                state, step = snap
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
        if save is not None and s_step > 0:
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


def _refuse(caller: str, what: str, item: int) -> None:
    raise ValueError(
        f"{caller}: {what} is not ported to the PyTorch package yet "
        f"(ROADMAP.md, Queue 1 item {item})")


def _check_ported(caller: str, *, mixed_precision, chain_steps,
                  chain_shuffle, mesh, shard_opt_state, zero_stage,
                  offload_opt_state, **later) -> None:
    """Refuse every option of the JAX package's loop ``caller`` that this
    package does not run yet, naming the ROADMAP item that will port it:
    none is silently ignored.  ``later`` holds ``fit``'s ``profile_dir``
    (item 8) and ``pipeline_*`` options (item 9)."""
    if mixed_precision not in (False, None, "off"):
        _refuse(caller, "mixed_precision", 5)
    if chain_steps != "auto" and (not isinstance(chain_steps, int)
                                  or chain_steps < 1):
        raise ValueError(f"chain_steps must be 'auto' or an int >= 1, got "
                         f"{chain_steps!r}")
    if isinstance(chain_steps, int) and chain_steps > 1:
        _refuse(caller, "chain_steps > 1", 6)
    if chain_shuffle != "host":
        _refuse(caller, f"chain_shuffle={chain_shuffle!r}", 6)
    if later.pop("profile_dir", None):
        _refuse(caller, "profile_dir", 8)
    for name, value in (("mesh", mesh), ("zero_stage", zero_stage),
                        *later.items()):
        if value is not None:
            _refuse(caller, name, 9)
    if shard_opt_state:
        _refuse(caller, "shard_opt_state", 9)
    if offload_opt_state:
        _refuse(caller, "offload_opt_state", 9)


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
    mixed_precision: bool = False,
    shard_opt_state: bool = False,
    zero_stage: Optional[int] = None,
    offload_opt_state: bool = False,
    ema_decay: Optional[float] = None,
    early_stop_patience: int = 0,
    val_metric: str = "accuracy",
    profile_dir: Optional[str] = None,
    mesh=None,
    pipeline_microbatches: Optional[int] = None,
    pipeline_schedule: Optional[str] = None,
    pipeline_chunks: Optional[int] = None,
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
    to the device (:class:`DevicePrefetcher`); the batches and the result
    are the same as with ``prefetch=0``.

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

    ``chain_steps`` takes ``"auto"`` or 1; both run one step at a time.
    ``mixed_precision``, ``chain_steps > 1``, a ``chain_shuffle`` other
    than ``"host"``, ``profile_dir``, ``mesh``, ZeRO (``shard_opt_state``,
    ``zero_stage``), ``offload_opt_state`` and the ``pipeline_*`` options
    raise ``ValueError`` naming the ROADMAP item that ports them."""
    _check_ported("fit", mixed_precision=mixed_precision,
                  chain_steps=chain_steps, chain_shuffle=chain_shuffle,
                  mesh=mesh, shard_opt_state=shard_opt_state,
                  zero_stage=zero_stage, offload_opt_state=offload_opt_state,
                  profile_dir=profile_dir,
                  pipeline_microbatches=pipeline_microbatches,
                  pipeline_schedule=pipeline_schedule,
                  pipeline_chunks=pipeline_chunks)
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
    opt = optimizer or sgd()
    step_fn = make_opt_step(net, loss, be, opt, accum_steps=accum_steps,
                            clip_norm=clip_norm)
    steps_per_epoch = (X.shape[0] + batch_size - 1) // batch_size
    total_steps = epochs * steps_per_epoch
    params = tuple(net.params)
    opt_state = opt.init(params)
    state_path = (checkpoint_path + ".state") if checkpoint_path else None
    # id-based struct keys (custom optimizers without `hyper`) do not
    # survive process restarts: only factory-made optimizers are checked
    opt_key = opt.struct_key() if opt.hyper is not None else None
    state_meta = {"layout": "flat"}

    def as_network(ps) -> Network:
        return Network(net.op, tuple(ps), net.act_names)

    # the records' `t` counts from here, so the first one holds the
    # loader's build and its first copies as well as the first step
    logger = MetricsLogger(metrics_path)
    loader = None
    try:
        loader = NativeLoader(X, Y, batch=batch_size, seed=seed)
        step = 0
        r_ema = None
        if resume and state_path and os.path.exists(state_path):
            from ..utils.checkpoint import load_train_state

            rparams, opt_state, step, r_ema = load_train_state(
                state_path, opt_state, opt_key=opt_key,
                expect_meta=state_meta, with_ema=True)
            if len(rparams) != len(params):
                raise ValueError(
                    f"checkpoint holds {len(rparams)} parameter leaves but "
                    f"this network has {len(params)} -- resume with the "
                    f"same model")
            params = tuple(be.asarray(p) for p in rparams)
            # stream position == global step: the resumed run continues
            # the epoch's shuffle where the saving run stopped
            if step < total_steps:
                loader.skip(step)
            if verbose:
                print(f"resumed from {state_path} at step {step} "
                      f"({max(total_steps - step, 0)} of {total_steps} "
                      f"steps remaining)")
        ema = None
        if ema_decay is not None:
            ema = _ema_init(r_ema, params, be, step, "fit")
            ema_step = _ema_update(ema_decay)

        if prefetch > 1 and be.name == "torch" and step < total_steps:
            next_batch = DevicePrefetcher(loader, be.device, be.dtype,
                                          depth=prefetch).next
        else:
            def next_batch():
                xb, yb = loader.next()
                return be.asarray(xb), be.asarray(yb)

        def train_step(lr_now, xb, yb, state):
            ps, o, e = state
            v, o, ps = step_fn(lr_now, xb, yb, o, ps)
            return v, (ps, o, None if e is None else ema_step(e, ps))

        evaluate = None
        if val is not None:
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
                return (save_network_async(checkpoint_path,
                                           as_network(state[0])),
                        save_train_state_async(state_path, state[0],
                                               state[1], at, opt_key=opt_key,
                                               ema=state[2],
                                               extra_meta=state_meta))

        (params, _, ema), history, step = _drive(
            (params, opt_state, ema), train_step, next_batch, step=step,
            total_steps=total_steps, steps_per_epoch=steps_per_epoch,
            lr_at=lr_schedule or (lambda s: lr), log_every=log_every,
            logger=logger, evaluate=evaluate,
            early_stop_patience=early_stop_patience, save=save,
            checkpoint_every=checkpoint_every, verbose=verbose)
    finally:
        if loader is not None:
            loader.close()
        logger.close()
    return FitResult(as_network(params), history, step,
                     ema_net=None if ema is None else as_network(ema))


def _seq_train_step(rnet: RecurrentNetwork, loss: TOp, be: Backend, n: int,
                    opt: Optional[Optimizer] = None,
                    clip_norm: Optional[float] = None, remat_every=None,
                    accum_steps: int = 1, offload_tape: bool = False
                    ) -> Callable:
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
    inside the step would be 0/0.  ``clip_norm`` clips the joint
    state+param gradient; ``remat_every`` and ``offload_tape`` go to the
    scan (``ScanOp``); ``accum_steps > 1`` accumulates equal chunks
    (:func:`_accum`), torch only.  Cached on the step op."""
    k = len(rnet.states)
    key = ("seq_fit_step", loss.struct_key(), n,
           opt.struct_key() if opt is not None else None, clip_norm,
           remat_every, int(accum_steps), bool(offload_tape)) + be.cache_key()
    fn = rnet.op._compiled.get(key)
    if fn is not None:
        return fn
    mean_grads = make_seq_mean_grads(rnet, loss, be, n,
                                     remat_every=remat_every,
                                     offload_tape=offload_tape)

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

    rnet.op._compiled[key] = fn
    return fn


class _SeqStream:
    """The shuffled sequence-minibatch stream (the JAX package's): one
    ``np.random.default_rng(seed)`` permutation per epoch, ragged tails
    dropped, and stream position == global step, rebuilt from
    ``start_step`` alone, so a crash/resume chain draws the same batches."""

    def __init__(self, XS, TS, batch: int, seed: int, start_step: int,
                 steps_per_epoch: int):
        self.XS, self.TS, self.batch = XS, TS, batch
        self.spe = steps_per_epoch
        self._rng = np.random.default_rng(seed)
        self._perm = self._rng.permutation(XS.shape[0])
        for _ in range(start_step // steps_per_epoch):
            self._perm = self._rng.permutation(XS.shape[0])
        self._b = start_step % steps_per_epoch

    def next(self):
        idx = self._perm[self._b * self.batch:(self._b + 1) * self.batch]
        self._b += 1
        if self._b == self.spe:
            self._b = 0
            self._perm = self._rng.permutation(self.XS.shape[0])
        return self.XS[idx], self.TS[idx]


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
    mixed_precision: bool = False,
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

    ``chain_steps`` takes ``"auto"`` or 1; both run one step at a time.
    ``mixed_precision``, ``chain_steps > 1``, a ``chain_shuffle`` other
    than ``"host"``, ``mesh``, ZeRO (``shard_opt_state``, ``zero_stage``)
    and ``offload_opt_state`` raise ``ValueError`` naming the ROADMAP item
    that ports them."""
    _check_ported("fit_sequences", mixed_precision=mixed_precision,
                  chain_steps=chain_steps, chain_shuffle=chain_shuffle,
                  mesh=mesh, shard_opt_state=shard_opt_state,
                  zero_stage=zero_stage, offload_opt_state=offload_opt_state)
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
    N = XS.shape[0]
    if N < batch_size:
        raise ValueError(
            f"dataset ({N} sequences) must hold at least one batch "
            f"({batch_size}); ragged batches are dropped")
    opt = optimizer
    steps_per_epoch = N // batch_size
    total_steps = epochs * steps_per_epoch
    k = len(rnet.states)
    leaves = tuple(rnet.states) + tuple(rnet.params)
    opt_state = opt.init(leaves) if opt is not None else ()
    state_path = (checkpoint_path + ".state") if checkpoint_path else None
    opt_key = (opt.struct_key()
               if opt is not None and opt.hyper is not None else None)

    def as_rnet(ls) -> RecurrentNetwork:
        return RecurrentNetwork(rnet.op, tuple(ls[:k]), tuple(ls[k:]),
                                rnet.arch)

    logger = MetricsLogger(metrics_path)
    try:
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
            leaves = tuple(be.asarray(x) for x in flat)
            if verbose:
                print(f"resumed from {state_path} at step {step} "
                      f"({max(total_steps - step, 0)} of {total_steps} "
                      f"steps remaining)")
        ema = None
        if ema_decay is not None:
            ema = _ema_init(r_ema, leaves, be, step, "fit_sequences")
            ema_step = _ema_update(ema_decay)

        stream = _SeqStream(XS, TS, batch_size, seed, step, steps_per_epoch)
        if prefetch > 1 and be.name == "torch" and step < total_steps:
            next_batch = DevicePrefetcher(stream, be.device, be.dtype,
                                          depth=prefetch).next
        else:
            def next_batch():
                xb, tb = stream.next()
                return be.asarray(xb), be.asarray(tb)

        step_fn = _seq_train_step(rnet, loss, be, XS.shape[1], opt=opt,
                                  clip_norm=clip_norm,
                                  remat_every=remat_every,
                                  accum_steps=accum_steps,
                                  offload_tape=offload_activations)

        def rates_at(s):
            if lr_schedule is None:
                return rate_state, rate_param
            rp = lr_schedule(s)
            return rate_state * (rp / rate_param), rp

        def train_step(rates, xb, tb, state):
            ls, o, e = state
            rs, rp = rates
            if opt is None:
                v, new_s, new_p = step_fn(rs, rp, xb, tb, ls[:k], ls[k:])
            else:
                # the ratio is schedule-invariant (rs and rp scale
                # together); passed explicitly, a warmup rp == 0 stays
                # finite
                v, o, new_s, new_p = step_fn(rate_state / rate_param, rp, xb,
                                             tb, o, ls[:k], ls[k:])
            ls = new_s + new_p
            return v, (ls, o, None if e is None else ema_step(e, ls))

        evaluate = None
        if val is not None:
            def evaluate(state):
                v = seq_batch_loss(as_rnet(state[0]), loss, be, val[0],
                                   val[1])
                return "val_loss", v, -v

        save = None
        if checkpoint_path:
            from ..utils.checkpoint import (save_recurrent_async,
                                            save_train_state_async)

            def save(state, at):
                return (save_recurrent_async(checkpoint_path,
                                             as_rnet(state[0])),
                        save_train_state_async(state_path, state[0],
                                               state[1], at, opt_key=opt_key,
                                               ema=state[2]))

        (leaves, _, ema), history, step = _drive(
            (leaves, opt_state, ema), train_step, next_batch, step=step,
            total_steps=total_steps, steps_per_epoch=steps_per_epoch,
            lr_at=rates_at, log_every=log_every, logger=logger,
            evaluate=evaluate, early_stop_patience=early_stop_patience,
            save=save, checkpoint_every=checkpoint_every, verbose=verbose)
    finally:
        logger.close()
    return FitSeqResult(as_rnet(leaves), history, step,
                        ema_net=None if ema is None else as_rnet(ema))
