"""Measured kernel plans with a persistent on-disk cache (the JAX package's
``ops/autotune.py``, over the port's plans instead of TPU tiles).

Each hand-written kernel runs a plan that a fixed rule picks from the shape
(:func:`~.kernels.linear_plan`, :func:`~.kernels.mlp_forward_plan`,
:func:`~.kernels.train_grid`, :func:`~.kernels.w8_plan`,
:func:`~.kernels.w8a8_plan`, :func:`~.kernels.mlp_w8a8_plan`,
:func:`~.kernels.rnn_seq_plan`), written from one card's runs.  This module
measures instead, on the card in use: it enumerates the plans that pass the
plan's own checks (each kernel's ``*_candidates``, the rule's plan always
among them), times the kernel on each (its device time in a CUDA graph,
:func:`graph_timer`), and persists the winner to a small JSON cache keyed
by (kernel, shape, card name).  A plan replaces the rule's only where it is
faster by more than the timer's noise.  The wrappers probe the
cache when they first plan a shape (:func:`lookup`); nothing is measured
implicitly, only through the ``autotune_*`` entry points.  With an empty
cache every plan is the rule's.

Cache location: ``$TENSOR_OPS_TPU_TORCH_PLAN_CACHE`` or
``~/.cache/tensor_ops_tpu_torch/plans.json``, a file of the port's own: its
entries (``{"plan": [...], "us": float, "candidates": int, "spread_us":
float}``, the plan's free parameters) are not the JAX package's tiles.  The file is written
atomically (a temporary file, then a rename) and merged on write, so two
tuners lose at worst one entry, never the file.  A packaged table,
``ops/tuned_plans.json``, is the fallback behind the user cache; it ships
empty.

A candidate that fails to build or launch raises: every candidate passed
the plan's checks, so a failure is a fault, not a rejected configuration.
"""

from __future__ import annotations

import json
import os
import statistics
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import kernels as kern

ENV_VAR = "TENSOR_OPS_TPU_TORCH_PLAN_CACHE"
# a plan must beat the rule's time by more than this share of it (and than
# the timing rounds' spread) to replace it: two sweeps on one H100 read the
# same plan's device time up to 2.4% apart, more than some plans' rounds
# spread within one sweep
TIE_SHARE = 0.03


def default_cache_path() -> str:
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "tensor_ops_tpu_torch", "plans.json")


class TileCache:
    """Tiny JSON key -> entry store with atomic merge-on-write.

    Entries are ``{"plan": [...], "us": float, "candidates": int,
    "spread_us": float}``: the winning plan's free parameters and its
    provenance (measured microseconds, sweep size, the spread of its timing
    rounds), so a reader can audit what the tuner saw.
    A ``put`` makes the wrappers plan their shapes again
    (:func:`~.kernels.clear_plan_caches`)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_cache_path()
        self._data: Optional[Dict[str, dict]] = None

    def _load(self) -> Dict[str, dict]:
        if self._data is None:
            try:
                with open(self.path) as f:
                    self._data = json.load(f)
            except (OSError, ValueError):
                self._data = {}
        return self._data

    def get(self, key: str) -> Optional[dict]:
        return self._load().get(key)

    def put(self, key: str, entry: dict) -> None:
        # merge against the file's current contents so two processes
        # tuning different shapes both land
        try:
            with open(self.path) as f:
                on_disk = json.load(f)
        except (OSError, ValueError):
            on_disk = {}
        on_disk[key] = entry
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        tmp = f"{self.path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(on_disk, f, indent=0, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._data = on_disk
        if _CACHE is not self and (os.path.abspath(_CACHE.path)
                                   == os.path.abspath(self.path)):
            _CACHE.invalidate()
        kern.clear_plan_caches()

    def invalidate(self) -> None:
        self._data = None


_CACHE = TileCache()


def _card_name(device=None) -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is visible: a tuned plan is keyed "
                           "by the card it was measured on")
    return torch.cuda.get_device_name(device)


def make_key(kernel: str, dev: Optional[str] = None, **params) -> str:
    """``kernel|p1=v1|..|dev=<card name>``, the card's name as
    ``torch.cuda.get_device_name`` gives it (``dev``, or the current card's)
    with its spaces replaced by ``_``."""
    dev = dev if dev is not None else _card_name()
    parts = [kernel] + [f"{k}={params[k]}" for k in sorted(params)]
    parts.append(f"dev={dev.replace(' ', '_')}")
    return "|".join(parts)


_PACKAGED_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tuned_plans.json")
_packaged: Optional[Dict[str, dict]] = None


def _packaged_plans() -> Dict[str, dict]:
    """The read-only table shipped with the package
    (``ops/tuned_plans.json``), the fallback behind the user cache; its keys
    carry ``dev=``, so another card never matches.  It ships empty: filling
    it would change the main path's plans."""
    global _packaged
    if _packaged is None:
        try:
            with open(_PACKAGED_PATH) as f:
                _packaged = json.load(f)
        except (OSError, ValueError):
            _packaged = {}
    return _packaged


def lookup(kernel: str, device_name: str,
           **params) -> Optional[Tuple[str, list, str]]:
    """``(key, plan, file)`` of the tuned entry for ``kernel`` at ``params``
    on the card named ``device_name``: the user cache first, then the
    packaged table; None where neither has one (never measures)."""
    key = make_key(kernel, dev=device_name, **params)
    entry = _CACHE.get(key)
    path = _CACHE.path
    if entry is None:
        entry, path = _packaged_plans().get(key), _PACKAGED_PATH
    if entry is None:
        return None
    return key, list(entry["plan"]), path


def get_tuned(kernel: str, dev: Optional[str] = None,
              **params) -> Optional[tuple]:
    """The tuned plan's free parameters for ``kernel`` at ``params`` on the
    card ``dev`` (the current card's name by default), or None."""
    hit = lookup(kernel, dev if dev is not None else _card_name(), **params)
    return None if hit is None else tuple(hit[1])


def _diff_time_us(loop_fn: Callable[[int], object], small: int = 4,
                  big: int = 12, rounds: int = 5,
                  min_signal_s: float = 0.02) -> List[float]:
    """Per-iteration microseconds by the differential method, one value a
    round: ``loop_fn(n)`` runs n calls and synchronises; a round's value is
    ``(t_big - t_small) / (big - small)``, which cancels the constant cost
    of the loop's start and its synchronise.  Until the best difference
    exceeds ``min_signal_s``, ``big`` grows to what it says would reach it
    twice over (8 to 64 times itself, at most 65,536 calls)."""
    loop_fn(small)
    while True:
        per = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            loop_fn(small)
            t1 = time.perf_counter()
            loop_fn(big)
            per.append((time.perf_counter() - t1) - (t1 - t0))
        diff = max(statistics.median(per), 1e-9)
        if diff > min_signal_s or big >= 65536:
            return [d / (big - small) * 1e6 for d in per]
        small, big = big, min(65536, big * 64, max(big * 8, big + int(
            2 * min_signal_s * (big - small) / diff)))


def wall_timer(call: Callable[[], object]) -> List[float]:
    """Microseconds a call of ``call`` adds to a stream of them launched
    from the host, a value a round (:func:`_diff_time_us` over n calls and
    a ``torch.cuda.synchronize``): the larger of the wrapper's host time and
    the kernels' device time, as the main path pays it.  For a plan that
    changes how many launches the host makes (kernel 7's routes)."""
    def loop_fn(n):
        for _ in range(n):
            call()
        torch.cuda.synchronize()

    return _diff_time_us(loop_fn)


def graph_timer(call: Callable[[], object], calls: int = 20,
                rounds: int = 5) -> List[float]:
    """Device microseconds per call of ``call``, a value a round: ``calls``
    calls captured in one CUDA graph, replayed between CUDA events.  No
    host time: at the main path's shapes the wrapper's host work (tens of
    microseconds a call) is longer than most kernels, and a stream launched
    from the host would time that, the same for every plan.  ``call`` first
    runs twice on the capture stream, so that the wrapper's per-shape plan
    and per-stream scratch are made outside the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
        call()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        for _ in range(calls):
            call()
    g.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) * 1e3 / calls)
    del g
    return out


def sweep(kernel: str, shape: tuple, candidates: Sequence, run: Callable, *,
          rule=None, timer: Callable = None,
          cache: Optional[TileCache] = None, dev: Optional[str] = None,
          report: Optional[dict] = None, verbose: bool = False):
    """Time ``run(plan)`` for every plan of ``candidates`` with ``timer``
    (``timer(call) -> [us, ...]``, a value a round; :func:`graph_timer` by
    default, the CPU tests inject one), persist the winner under the key of
    ``kernel`` at ``shape`` (the arguments of its ``kernels.TUNING`` key)
    as ``{"plan", "us", "candidates", "spread_us"}`` and return it.

    A plan's time is the median of its rounds and its spread the largest
    less the least.  The fastest plan wins, except that where ``rule`` (the
    fixed rule's plan, a candidate) is given, a plan beats it only by more
    than the larger of the two spreads and :data:`TIE_SHARE` of the rule's
    time: a tie within the timer's noise keeps the rule.  A candidate that raises stops the sweep (it passed the
    plan's checks, so its failure is a fault).  ``report`` (a dict)
    receives the key, every candidate's µs, the winner and, with ``rule``,
    the rule's plan and µs."""
    cache = cache or _CACHE
    timer = timer or graph_timer
    tuning = kern.TUNING[kernel]
    key = make_key(kernel, dev=dev, **tuning.key(*shape))
    if not candidates:
        raise RuntimeError(f"no candidate plan for {key}")
    results = []
    for plan in candidates:
        rounds = [float(t) for t in timer(lambda p=plan: run(p))]
        results.append((statistics.median(rounds),
                        max(rounds) - min(rounds), plan))
        if verbose:
            print(f"  {kernel} {tuning.free(plan)}: {results[-1][0]:.2f} us "
                  f"(spread {results[-1][1]:.2f})")
    best_us, spread, best = min(results, key=lambda r: r[0])
    if rule is not None:
        rule_us, rule_spread, _ = next(r for r in results if r[2] == rule)
        if best_us >= rule_us - max(spread, rule_spread,
                                    TIE_SHARE * rule_us):
            best_us, spread, best = rule_us, rule_spread, rule
    cache.put(key, {"plan": list(tuning.free(best)), "us": round(best_us, 2),
                    "candidates": len(results),
                    "spread_us": round(spread, 2)})
    if report is not None:
        report.update(key=key, best=list(tuning.free(best)), best_us=best_us,
                      results=[(list(tuning.free(p)), us, sp)
                               for us, sp, p in results])
        if rule is not None:
            report.update(rule=list(tuning.free(rule)), rule_us=rule_us)
    return best


def _card(name: str, device) -> torch.device:
    """The card a sweep runs on; ``RuntimeError`` naming it when there is
    none: on the CPU the plain version runs, which ignores a plan, so there
    is nothing to time."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"{name} times a hand-written kernel on a CUDA card, and "
            f"{'no card is visible' if dev.type == 'cuda' else dev} "
            f"(on the CPU the plain version runs, which ignores a plan)")
    return dev


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _inputs(dev, *shapes, seed: int = 0) -> List[torch.Tensor]:
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(s, generator=g).to(dev) for s in shapes]


def _codes(dev, *shape, seed: int = 1) -> torch.Tensor:
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=g,
                         dtype=torch.int8).to(dev)


def _common(kw: dict, dev) -> dict:
    """The sweep's keyword arguments: the cache, timer, report and verbose
    the caller gave, and the card's name."""
    return dict(kw, dev=torch.cuda.get_device_name(dev))


def autotune_linear(B: int, K: int, O: int, *, act: str = "logistic",
                    dtype=torch.float32, device="cuda", **kw):
    """Measure every plan of :func:`~.kernels.linear_candidates` (the gemv,
    the tile with each split of K, the large tile) for ``fused_linear`` at x
    (B, K), w (O, K) and persist the winner; returns its
    :class:`~.kernels.LinearPlan`.  ``kw``: ``cache``, ``timer``,
    ``report``, ``verbose``."""
    dev = _card("autotune_linear", device)
    sms = kern._sm_count(_index(dev))
    x, w, b = _inputs(dev, (B, K), (O, K), (O,))
    x, w = x.to(dtype), w.to(dtype)
    cands = kern.linear_candidates(B, K, O, dtype, True, sms)
    return sweep("linear", (B, K, O, dtype), cands,
                 lambda p: kern.fused_linear(x, w, b, act, plan=p),
                 rule=kern.linear_plan(B, K, O, dtype, True, sms),
                 **_common(kw, dev))


def autotune_mlp_forward(B: int, dims: Sequence[int], acts: Sequence[str],
                         *, softmax_out: bool = True, device="cuda", **kw):
    """Sweep the whole-chain forward's row tile
    (:func:`~.kernels.mlp_forward_candidates`) at B rows through ``dims``;
    persists and returns the winning :class:`~.kernels.MlpPlan`."""
    dev = _card("autotune_mlp_forward", device)
    ws = _inputs(dev, *[(dims[k + 1], dims[k]) for k in range(len(dims) - 1)])
    bs = _inputs(dev, *[(d,) for d in dims[1:]], seed=1)
    x = torch.rand(B, dims[0], generator=torch.Generator().manual_seed(2)
                   ).to(dev)
    return sweep("mlp_fwd", (B, dims), kern.mlp_forward_candidates(B, dims),
                 lambda p: kern.fused_mlp_forward(x, ws, bs, acts, softmax_out,
                                               plan=p),
                 rule=kern.mlp_forward_plan(B, dims),
                 **_common(kw, dev))


def autotune_mlp_train_step(B: int, dims: Sequence[int],
                            acts: Sequence[str], *, lr: float = 0.05,
                            loss_kind: str = "softmax_xent", device="cuda",
                            **kw) -> int:
    """Sweep the step kernel's cooperative grid
    (:func:`~.kernels.train_grid_candidates`, at most the blocks the card
    holds at once); persists and returns the winning block count."""
    dev = _card("autotune_mlp_train_step", device)
    idx = _index(dev)
    ws = [w * 0.1 for w in _inputs(
        dev, *[(dims[k + 1], dims[k]) for k in range(len(dims) - 1)])]
    bs = _inputs(dev, *[(d,) for d in dims[1:]], seed=1)
    x = torch.rand(B, dims[0], generator=torch.Generator().manual_seed(2)
                   ).to(dev)
    y = torch.eye(dims[-1])[torch.arange(B) % dims[-1]].to(dev)
    cap, sms = kern._train_step_capacity(idx), kern._sm_count(idx)
    return sweep("mlp_train", (B, dims),
                 kern.train_grid_candidates(cap, sms, B, dims),
                 lambda g: kern.fused_mlp_train_step(
                     x, y, ws, bs, lr, acts, loss_kind=loss_kind, plan=g),
                 rule=kern.train_grid(cap, sms, B, dims),
                 **_common(kw, dev))


def autotune_linear_w8(B: int, K: int, O: int, *, act: str = "identity",
                       precision: str = "default", device="cuda", **kw):
    """Measure every plan of :func:`~.kernels.w8_candidates` (the gemv and
    the precision's tile, each split of K) for ``fused_linear_w8``; persists
    and returns the winning :class:`~.kernels.W8Plan`."""
    dev = _card("autotune_linear_w8", device)
    sms = kern._sm_count(_index(dev))
    (x,) = _inputs(dev, (B, K))
    q = kern.pad_codes(_codes(dev, O, K))
    s = torch.full((O, 1), 0.01, device=dev)
    (b,) = _inputs(dev, (O,), seed=3)
    return sweep("linear_w8", (B, K, O, precision),
                 kern.w8_candidates(B, K, O, precision, sms),
                 lambda p: kern.fused_linear_w8(x, q, s, b, act, precision,
                                             plan=p),
                 rule=kern.w8_plan(B, K, O, precision, sms),
                 **_common(kw, dev))


def autotune_linear_w8a8(B: int, K: int, O: int, *, act: str = "identity",
                         device="cuda", **kw):
    """Measure every plan of :func:`~.kernels.w8a8_candidates` (the one
    launch and the pair, each row tile, tile count and split of K) for
    ``fused_linear_w8a8``; persists and returns the winning
    :class:`~.kernels.W8a8Plan`."""
    dev = _card("autotune_linear_w8a8", device)
    sms = kern._sm_count(_index(dev))
    (x,) = _inputs(dev, (B, K))
    q = kern.pad_codes(_codes(dev, O, K))
    s = torch.full((O, 1), 0.01, device=dev)
    (b,) = _inputs(dev, (O,), seed=3)
    return sweep("linear_w8a8", (B, K, O), kern.w8a8_candidates(B, K, O, sms),
                 lambda p: kern.fused_linear_w8a8(x, q, s, b, act, plan=p),
                 rule=kern.w8a8_plan(B, K, O, sms),
                 **_common(kw, dev))


def autotune_mlp_w8a8(B: int, N: int, L: int, *, hidden_act: str = "relu",
                      device="cuda", **kw):
    """Sweep the whole-MLP int8 kernel's rows per group and ring depth
    (:func:`~.kernels.mlp_w8a8_candidates`) at B rows through L layers of
    N x N; persists and returns the winning
    :class:`~.kernels.MlpW8a8Plan`."""
    dev = _card("autotune_mlp_w8a8", device)
    sms = kern._sm_count(_index(dev))
    (x,) = _inputs(dev, (B, N))
    q = _codes(dev, L, N, N)
    s = torch.full((L, N), 0.01, device=dev)
    (b,) = _inputs(dev, (L, N), seed=3)
    return sweep("mlp_w8a8", (B, N, L), kern.mlp_w8a8_candidates(B, N, L, sms),
                 lambda p: kern.fused_mlp_w8a8_forward(x, q, s, b, hidden_act,
                                                    plan=p),
                 rule=kern.mlp_w8a8_plan(B, N, L, sms), **_common(kw, dev))


def autotune_rnn_step(B: int, I: int, O: int, *, act: str = "logistic",
                      n: int = 64, device="cuda", **kw) -> str:
    """Time a sequence of ``n`` Elman steps I -> O at B rows on each route
    of :func:`~.kernels.rnn_seq_candidates` (``"resident"``, one launch of
    the sequence kernel, where it fits; ``"steps"``, one step launch a
    timestep; the step kernel itself takes no host-side plan); persists and
    returns the winner.  The routes differ in the host's launches (one
    against ``n``), so they are timed as the host launches them
    (:func:`wall_timer`), not by device time alone."""
    dev = _card("autotune_rnn_step", device)
    xs, s0 = _inputs(dev, (n, B, I), (B, O))
    wx, ws = (w * 0.1 for w in _inputs(dev, (O, I), (O, O), seed=1))
    (b,) = _inputs(dev, (O,), seed=3)
    kw.setdefault("timer", wall_timer)
    return sweep("rnn_step", (B, I, O), kern.rnn_seq_candidates(B, I, O),
                 lambda p: kern.fused_rnn_seq(xs, s0, wx, ws, b, act, plan=p),
                 rule=kern.rnn_seq_plan(B, I, O), **_common(kw, dev))
