"""The production training loop, ``fit``: the loop the reference never had
(its training is an inline ``foldl'`` over samples with printf reporting,
``app/MNIST.hs:390-396``).

Composes the staged-IR network, the native threaded batch loader, an
optimizer, JSONL metrics, validation with early stopping, and periodic
asynchronous checkpoints with exact resume.  A step is the per-sample
graph's transposition-AD gradient mapped over the batch
(``training.make_mean_grads``), its batch mean, the optional global-norm clip and
``opt.update``; on the NumPy oracle the samples are looped, as the JAX
package does.

The loop itself is :func:`_drive`, the window driver: step, log boundary,
validation, early stop and checkpoints, independent of what a step
computes, so that ``fit_sequences`` (ROADMAP.md, Queue 1 item 2) reuses it.
This slice runs single-device and unchained; the options of the JAX
package's ``fit`` that need the rest of the port raise ``ValueError``
naming their ROADMAP item.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np

from ..backend.base import Backend
from ..ops.ir import TOp
from ..utils.metrics import MetricsLogger
from ..utils.native import DevicePrefetcher, NativeLoader
from .feedforward import Network
from .optim import Optimizer, clip_by_global_norm, sgd
from .training import accuracy, batch_loss, make_mean_grads


@dataclass
class FitResult:
    net: Network
    history: list
    steps: int


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


def make_opt_step(net: Network, loss: TOp, be: Backend, opt: Optimizer,
                  clip_norm: Optional[float] = None) -> Callable:
    """``(lr, xb, yb, opt_state, params) -> (loss, opt_state, params)``:
    one optimizer step on a batch.  ``loss`` comes back as a 0-d tensor on
    the device (no synchronise), or a float on the NumPy oracle.  Cached
    on the network's op by the loss's and optimizer's structural keys."""
    key = ("optstep", loss.struct_key(), opt.struct_key(),
           clip_norm) + be.cache_key()
    fn = net.op._compiled.get(key)
    if fn is not None:
        return fn
    mean_grads = make_mean_grads(net, loss, be)

    def step(lr, xb, yb, opt_state, params):
        v, grads = mean_grads(xb, yb, *params)
        if clip_norm:
            grads = clip_by_global_norm(grads, clip_norm)
        opt_state, params = opt.update(opt_state, tuple(params), grads, lr)
        return v, opt_state, params

    net.op._compiled[key] = step
    return step


def _drive(state, step_fn: Callable, next_batch: Callable, *, step: int,
           total_steps: int, steps_per_epoch: int,
           lr_at: Callable[[int], float], log_every: int,
           logger: MetricsLogger, evaluate: Optional[Callable] = None,
           early_stop_patience: int = 0, save: Optional[Callable] = None,
           checkpoint_every: int = 0, verbose: bool = True):
    """The window driver: run ``step_fn`` from global step ``step`` to
    ``total_steps`` and return ``(state, history, step)``.

    Each step is ``v, state = step_fn(lr_at(step), *next_batch(), state)``.
    A log boundary (every ``log_every`` steps, and the run's first step)
    reads the loss (one synchronise), calls ``evaluate(state) -> (name,
    value, score)`` when given (higher score is better; ``early_stop_
    patience`` evaluations without a gain stop the run), and appends the
    record ``logger.log`` makes (its ``t`` is the host clock after that
    synchronise and the evaluation) to the history.  A boundary without
    ``evaluate`` reads its loss at once too, where the JAX package defers
    that read a few windows: the host waits there for the card.  Every ``checkpoint_every`` steps
    ``save(state, step)`` returns futures of asynchronous writes, joined
    before the driver returns; a write error is raised unless another
    exception is already unwinding."""
    history = []
    saves = _CheckpointWrites()
    best, since_best = float("-inf"), 0
    first = step + 1  # a resumed run logs its first step too
    try:
        while step < total_steps:
            epoch = step // steps_per_epoch
            v, state = step_fn(lr_at(step), *next_batch(), state)
            step += 1
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
    finally:
        err = saves.join()
        if err is not None and sys.exc_info()[0] is None:
            raise err
    return state, history, step


def _refuse(what: str, item: int) -> None:
    raise ValueError(
        f"fit: {what} is not ported to the PyTorch package yet (ROADMAP.md, "
        f"Queue 1 item {item})")


def _check_ported(*, accum_steps, mixed_precision, ema_decay, chain_steps,
                  chain_shuffle, profile_dir, mesh, shard_opt_state,
                  zero_stage, offload_opt_state, pipeline_microbatches,
                  pipeline_schedule, pipeline_chunks) -> None:
    """Refuse every option of the JAX package's ``fit`` that this package
    does not run yet, naming the ROADMAP item that will port it: none is
    silently ignored."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if accum_steps > 1:
        _refuse("accum_steps > 1", 5)
    if mixed_precision not in (False, None, "off"):
        _refuse("mixed_precision", 5)
    if ema_decay is not None:
        _refuse("ema_decay", 5)
    if chain_steps != "auto" and (not isinstance(chain_steps, int)
                                  or chain_steps < 1):
        raise ValueError(f"chain_steps must be 'auto' or an int >= 1, got "
                         f"{chain_steps!r}")
    if isinstance(chain_steps, int) and chain_steps > 1:
        _refuse("chain_steps > 1", 6)
    if chain_shuffle != "host":
        _refuse(f"chain_shuffle={chain_shuffle!r}", 6)
    if profile_dir:
        _refuse("profile_dir", 8)
    for name, value in (("mesh", mesh), ("zero_stage", zero_stage),
                        ("pipeline_microbatches", pipeline_microbatches),
                        ("pipeline_schedule", pipeline_schedule),
                        ("pipeline_chunks", pipeline_chunks)):
        if value is not None:
            _refuse(name, 9)
    if shard_opt_state:
        _refuse("shard_opt_state", 9)
    if offload_opt_state:
        _refuse("offload_opt_state", 9)


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

    ``checkpoint_path`` + ``checkpoint_every`` save the servable network
    and a sibling ``<path>.state`` holding the parameters, the optimizer
    state and the global step (atomic writes, off the training thread);
    ``resume=True`` restores them and requires the same optimizer and
    hyperparameters (its stored ``struct_key``).  ``epochs`` is the TOTAL
    budget: a resumed run executes only the remaining steps, and the data
    stream is fast-forwarded to the restored step, so a crash/resume chain
    equals the uninterrupted run bit for bit.  The ``.state`` format is
    the JAX package's: a file of either package resumes in the other.

    ``chain_steps`` takes ``"auto"`` or 1; both run one step at a time.
    ``accum_steps > 1``, ``mixed_precision``, ``ema_decay``,
    ``chain_steps > 1``, a ``chain_shuffle`` other than ``"host"``,
    ``profile_dir``, ``mesh``, ZeRO (``shard_opt_state``, ``zero_stage``),
    ``offload_opt_state`` and the ``pipeline_*`` options raise
    ``ValueError`` naming the ROADMAP item that ports them."""
    _check_ported(accum_steps=accum_steps, mixed_precision=mixed_precision,
                  ema_decay=ema_decay, chain_steps=chain_steps,
                  chain_shuffle=chain_shuffle, profile_dir=profile_dir,
                  mesh=mesh, shard_opt_state=shard_opt_state,
                  zero_stage=zero_stage, offload_opt_state=offload_opt_state,
                  pipeline_microbatches=pipeline_microbatches,
                  pipeline_schedule=pipeline_schedule,
                  pipeline_chunks=pipeline_chunks)
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
    step_fn = make_opt_step(net, loss, be, opt, clip_norm=clip_norm)
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
        if resume and state_path and os.path.exists(state_path):
            from ..utils.checkpoint import load_train_state

            rparams, opt_state, step = load_train_state(
                state_path, opt_state, opt_key=opt_key,
                expect_meta=state_meta)
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

        if prefetch > 1 and be.name == "torch" and step < total_steps:
            next_batch = DevicePrefetcher(loader, be.device, be.dtype,
                                          depth=prefetch).next
        else:
            def next_batch():
                xb, yb = loader.next()
                return be.asarray(xb), be.asarray(yb)

        def train_step(lr_now, xb, yb, state):
            v, o, p = step_fn(lr_now, xb, yb, state[1], state[0])
            return v, (p, o)

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
                                               extra_meta=state_meta))

        (params, _), history, step = _drive(
            (params, opt_state), train_step, next_batch, step=step,
            total_steps=total_steps, steps_per_epoch=steps_per_epoch,
            lr_at=lr_schedule or (lambda s: lr), log_every=log_every,
            logger=logger, evaluate=evaluate,
            early_stop_patience=early_stop_patience, save=save,
            checkpoint_every=checkpoint_every, verbose=verbose)
    finally:
        if loader is not None:
            loader.close()
        logger.close()
    return FitResult(as_network(params), history, step)
