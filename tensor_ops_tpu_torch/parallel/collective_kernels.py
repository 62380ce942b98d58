"""Ring collectives over a group of ranks, and the data-parallel whole-step
trainer built on them.

The counterpart of ``tensor_ops_tpu/parallel/collective_kernels.py``.  There
each device of a mesh axis ran a Pallas kernel and sent chunks to its
neighbours with remote DMAs; here a rank is a torch device (several ranks
may share one card, as the JAX tests' 8 ranks share one CPU) and the
wrappers take the R per-rank tensors and return the R per-rank results:

* :func:`ring_all_reduce` — the one-way ring (kernel 8,
  ``csrc/ring_all_reduce.cu``), a drop-in for ``psum``;
* :func:`ring_all_reduce_bidir`, :func:`ring_reduce_scatter`,
  :func:`ring_all_gather` — the bidirectional ring (kernel 9,
  ``csrc/bidir_ring.cu``) in its phases ``ar``, ``rs`` (``psum_scatter``,
  tiled) and ``ag`` (``all_gather``, tiled);
* :func:`dp_megakernel_train_step` — ``fused_mlp_train_step`` on each rank's
  shard of the batch, then a ring all-reduce of every updated parameter.

Each element is summed in the JAX ring's order: the JAX chunk layout
(chunks of whole 1,024-element pieces) fixes, per element, the rank where
its fold starts and the direction it goes round the ring.  The ring
protocol's plain versions :func:`ring_all_reduce_ref` and
:func:`bidir_ring_ref` simulate the TPU schedule step by step;
:func:`oneshot_ref` folds each element in that order in closed form.  All
three equal the JAX rings bit for bit on random f32, and each kernel equals
its plain version bit for bit.

Routes: CPU tensors take :func:`oneshot_ref`.  When every rank sits on one
card, a wrapper launches the one-shot kernel once on that card's current
stream (``csrc/oneshot.cuh``): it reads each rank's input once and writes
each rank's output once.  Ranks spread over several cards take the ring
protocol (``csrc/ring.cuh``: one cooperative launch per card, neighbours
reached by peer access).  No route falls back to another or stages through
the host.
"""

from __future__ import annotations

import array
import ctypes
import math
import threading
from typing import List, Optional, Sequence, Tuple

import torch

from ..ops import kernels as K

CHUNK = 1024            # the TPU kernels' (8, 128) tile: the smallest piece
BLOCK_ELEMS = 1024      # elements one block sends per step (all directions)
THREADS = 256           # threads per block (csrc/ring.cuh kThreads)
MAX_LOCAL_RANKS = 16    # ranks of one launch (csrc/ring.cuh kMaxLocalRanks)
PHASES = {"ar": 0, "rs": 1, "ag": 2}
_DTYPE_CODES = {torch.float32: 0, torch.int32: 1}


class RankGroup:
    """An ordered list of torch devices, one per rank: the counterpart of a
    mesh's ``data`` axis.

    ``RankGroup(n)`` places n ranks round-robin over the visible cards (4
    ranks on a one-card machine all sit on ``cuda:0``; on a four-card machine
    one per card).  ``RankGroup(devices=["cpu"] * n)`` runs them on the CPU,
    which is used only when asked for.  Ranks on distinct cards need peer
    access between every pair of ring neighbours; without it the group
    raises ``ValueError`` naming the pair."""

    def __init__(self, n: Optional[int] = None,
                 devices: Optional[Sequence] = None):
        if devices is None:
            if n is None or n < 1:
                raise ValueError("RankGroup needs n >= 1 or a device list")
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "RankGroup: no CUDA device is visible; pass "
                    "devices=['cpu'] * n to run the ranks on the CPU")
            count = torch.cuda.device_count()
            devices = [f"cuda:{r % count}" for r in range(n)]
        devs = tuple(_canonical(torch.device(d)) for d in devices)
        if not devs or (n is not None and n != len(devs)):
            raise ValueError(f"RankGroup: n={n} with {len(devs)} devices")
        kinds = {d.type for d in devs}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"RankGroup: ranks must all be on the CPU or all "
                             f"on CUDA cards, got {[str(d) for d in devs]}")
        self.devices = devs
        if "cuda" in kinds:
            _check_peers(devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"RankGroup({[str(d) for d in self.devices]})"


def _canonical(d: torch.device) -> torch.device:
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _check_peers(devs: Sequence[torch.device]) -> None:
    n = len(devs)
    for r in range(n):
        a, b = devs[r], devs[(r + 1) % n]
        if a.index == b.index:
            continue
        if not (torch.cuda.can_device_access_peer(a.index, b.index)
                and torch.cuda.can_device_access_peer(b.index, a.index)):
            raise ValueError(
                f"ring neighbours {r} ({a}) and {(r + 1) % n} ({b}) are on "
                f"cards without peer access; the ring never stages through "
                f"the host")


# ---------------------------------------------------------------------------
# The chunk layout and the plain versions
# ---------------------------------------------------------------------------


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _layout(phase: str, shape, n: int, one_way: bool = False):
    """``(D, H, x_stride, x_len, x_size)`` of the JAX layout: the buffer is n
    chunks of D pieces of H elements (D = 1 for the one-way ring, 2 for the
    bidirectional one); input element ``c * x_stride + j`` lands at element
    j of chunk c when ``j < x_len`` (``ag``: the shard into the own chunk).

    one-way: chunks of ``ceil(size / (n·1024))·1024`` (``ring_all_reduce``);
    ``ar``: pieces of ``ceil(size / (n·2·1024))·1024`` (``_pad_to_halves``);
    ``rs``: each leading block padded on its own; ``ag``: the shard padded
    into two pieces."""
    size = math.prod(shape)
    if one_way:
        H = _ceil(size, n * CHUNK) * CHUNK
        return 1, H, H, H, size
    if phase == "ar":
        H = _ceil(size, n * 2 * CHUNK) * CHUNK
        return 2, H, 2 * H, 2 * H, size
    if phase == "rs":
        part = size // n
        H = _ceil(part, 2 * CHUNK) * CHUNK
        return 2, H, part, part, size
    H = _ceil(size, 2 * CHUNK) * CHUNK
    return 2, H, 0, size, size


def _pad_in(x, n: int, phase: str, layout, me: int):
    """The rank's input in its (n, D, H) buffer, zeros elsewhere."""
    D, H, stride, x_len, size = layout
    flat = x.reshape(-1)
    buf = torch.zeros((n, D * H), dtype=x.dtype, device=x.device)
    if phase == "ag":
        buf[me, :size] = flat
    elif stride == D * H:
        buf.view(-1)[:size] = flat
    else:
        buf[:, :x_len] = flat.reshape(n, x_len)
    return buf.reshape(n, D, H)


def _cw_indices(phase: str, n: int, s: int, me: torch.Tensor):
    """Per rank, the chunk sent and the chunk received into at step s in the
    clockwise direction (the TPU kernels' index math), and whether the
    receive adds."""
    if phase == "ar":
        if s < n - 1:
            return (me - s) % n, (me - s - 1) % n, True
        s2 = s - (n - 1)
        return (me + 1 - s2) % n, (me - s2) % n, False
    if phase == "rs":
        return (me - s - 1) % n, (me - s - 2) % n, True
    return (me - s) % n, (me - s - 1) % n, False


def _simulate(bufs: torch.Tensor, phase: str) -> torch.Tensor:
    """The ring schedule on the stacked (R, n, D, H) buffers: at every step
    each rank sends piece d of one chunk to its right (d = 0) or left (d = 1)
    neighbour, which writes ``out[recv] = out[recv] + got`` (reduce) or
    ``got`` (gather).  Every send of a step reads the buffers before any
    receive of that step writes them, as in the kernels."""
    R, n, D, _ = bufs.shape
    out = bufs.clone()
    me = torch.arange(R, device=bufs.device)
    n_steps = 2 * (n - 1) if phase == "ar" else n - 1
    for s in range(n_steps):
        send, recv, accum = _cw_indices(phase, n, s, me)
        # ccw mirrors cw: 2 me + 2 n - x
        sends = [send, (2 * me + 2 * n - send) % n]
        recvs = [recv, (2 * me + 2 * n - recv) % n]
        sent = [out[me, sends[d], d] for d in range(D)]
        for d in range(D):
            src = (me - 1) % R if d == 0 else (me + 1) % R
            got = sent[d][src]
            cur = out[me, recvs[d], d]
            out[me, recvs[d], d] = cur + got if accum else got
    return out


def _extract(out_r, phase: str, shape, n: int, me: int, layout):
    """Rank me's result from its (n, D, H) buffer, in the input's shape."""
    size = layout[4]
    if phase == "rs":
        part = size // n
        return out_r[me].reshape(-1)[:part].reshape(
            (shape[0] // n,) + tuple(shape[1:]))
    if phase == "ag":
        return out_r.reshape(n, -1)[:, :size].reshape(
            (n * shape[0],) + tuple(shape[1:]))
    return out_r.reshape(-1)[:size].reshape(shape)


def _ring_ref(xs, phase: str, one_way: bool) -> List[torch.Tensor]:
    n = len(xs)
    shape = tuple(xs[0].shape)
    layout = _layout(phase, shape, n, one_way)
    D, H = layout[0], layout[1]
    home = xs[0].device
    bufs = torch.stack([_pad_in(x.to(home), n, phase, layout, r)
                        for r, x in enumerate(xs)])
    out = _simulate(bufs, phase)
    return [_extract(out[r], phase, shape, n, r, layout).to(x.device)
            for r, x in enumerate(xs)]


def ring_all_reduce_ref(xs) -> List[torch.Tensor]:
    """Plain PyTorch one-way ring all-reduce: the step-by-step schedule of
    ``_ring_kernel`` on the JAX layout.  Returns every rank's sum."""
    xs = _check_inputs(xs, "ring_all_reduce")
    if len(xs) == 1:
        return list(xs)
    return _ring_ref(xs, "ar", one_way=True)


def bidir_ring_ref(xs, phase: str = "ar") -> List[torch.Tensor]:
    """Plain PyTorch bidirectional ring, the schedule of
    ``_bidir_ring_kernel``: ``ar`` every rank's sum, ``rs`` rank r's summed
    r-th block of the leading axis, ``ag`` the leading-axis concatenation
    of the shards in rank order."""
    _check_phase(phase)
    xs = _check_inputs(xs, f"bidir_ring {phase}")
    _check_phase_shape(xs, phase)
    if len(xs) == 1:
        return list(xs)
    return _ring_ref(xs, phase, one_way=False)


def _fold_plan(phase: str, shape, n: int, one_way: bool, device):
    """Per element of the flat input (``ar``, ``rs``): the rank where the
    ring's fold of it starts, and the step round the ring (1 to the right,
    n - 1 to the left).  See ``csrc/oneshot.cuh`` for the rule and a
    worked R = 4 example."""
    D, H, _, _, size = _layout(phase, shape, n, one_way)
    i = torch.arange(size, device=device)
    if phase == "ar":
        piece = i // H
        start, d = piece // D, piece % D
    else:  # rs: element j of rank r's block, r = i // part
        part = size // n
        r = i // part
        d = (i - r * part) // H
        start = torch.where(d == 0, (r + 1) % n, (r + n - 1) % n)
    return start, torch.where(d == 0, 1, n - 1)


def oneshot_ref(xs, phase: str = "ar", one_way: bool = False,
                scale: Optional[float] = None) -> List[torch.Tensor]:
    """Plain PyTorch one-shot collective: each element of the result folded
    over the ranks in the order the ring folds it (``one_way``: kernel 8's
    layout, else kernel 9's), then, for ``ar`` and ``rs``, multiplied by
    ``scale`` when one is given.  Returns what :func:`ring_all_reduce_ref`
    / :func:`bidir_ring_ref` return, bit for bit, each rank's result in
    memory of its own."""
    _check_phase(phase)
    if one_way and phase != "ar":
        raise ValueError(f"the one-way ring has no phase {phase!r}")
    xs = _check_inputs(xs, f"oneshot {phase}")
    _check_phase_shape(xs, phase)
    n, shape = len(xs), tuple(xs[0].shape)
    home = xs[0].device
    flat = torch.stack([x.reshape(-1).to(home) for x in xs])
    if phase == "ag":
        whole = flat.reshape((n * shape[0],) + shape[1:])
        return [whole.clone().to(x.device) for x in xs]
    if flat.shape[1] == 0:
        acc = flat[0]
    else:
        rank, step = _fold_plan(phase, shape, n, one_way, home)
        i = torch.arange(flat.shape[1], device=home)
        acc = flat[rank, i]
        for _ in range(n - 1):
            rank = (rank + step) % n
            acc = acc + flat[rank, i]
    if scale is not None:
        acc = acc * scale
    if phase == "rs":
        blocks = acc.reshape((n, shape[0] // n) + shape[1:])
        return [blocks[r].clone().to(x.device) for r, x in enumerate(xs)]
    return [acc.reshape(shape).clone().to(x.device) for x in xs]


def _check_inputs(xs, name: str):
    """The ranks' tensors as a list, after checking that they agree in
    shape and dtype and lie all on the CPU or all on CUDA cards."""
    xs = list(xs)
    if not xs or not all(isinstance(x, torch.Tensor) for x in xs):
        raise ValueError(f"{name}: want one tensor per rank, got {xs!r}")
    x0 = xs[0]
    for r, x in enumerate(xs):
        if x.shape != x0.shape or x.dtype != x0.dtype:
            raise ValueError(
                f"{name}: rank {r} has {tuple(x.shape)} {x.dtype}, rank 0 "
                f"{tuple(x0.shape)} {x0.dtype}")
    if len({x.is_cuda for x in xs}) != 1:
        raise ValueError(f"{name}: ranks must all be on the CPU or all on "
                         f"CUDA cards")
    return xs


def _check_phase(phase: str) -> None:
    if phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r} (known: {sorted(PHASES)})")


def _check_phase_shape(xs, phase: str) -> None:
    n, shape = len(xs), xs[0].shape
    if phase in ("rs", "ag") and len(shape) == 0:
        raise ValueError(f"bidir_ring {phase}: a 0-d tensor has no leading "
                         f"axis")
    if phase == "rs" and shape[0] % n != 0:
        raise ValueError(
            f"ring_reduce_scatter splits the leading axis: shape[0] "
            f"({shape[0]}) must be divisible by the ring size ({n})")


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


class _Scratch:
    """Every rank's comm slots (4-byte words) and flags (int64, zeroed once,
    on each card's current stream) in its card's memory, the table of their
    addresses on each card, and the call counter that makes each call's flag
    tags larger than any earlier call's."""

    def __init__(self, devices, slot_words: int, nb_cap: int):
        self.slot_words, self.nb_cap = slot_words, nb_cap
        self.slots = [torch.empty(slot_words, dtype=torch.int32, device=d)
                      for d in devices]
        self.flags = [torch.zeros(2 * 3 * nb_cap, dtype=torch.int64, device=d)
                      for d in devices]
        rows = [[s.data_ptr(), f.data_ptr()]
                for s, f in zip(self.slots, self.flags)]
        self.tables = {d: torch.tensor(rows, dtype=torch.int64, device=d)
                       for d in set(devices)}
        self.epoch = 0


_state_lock = threading.Lock()
_scratch: dict = {}    # (lib, devices) -> _Scratch
_capacity: dict = {}   # (lib, card index) -> co-resident blocks
_peers_enabled: set = set()


# csrc/ring.cuh ring::launch, after D: dtype, phase, n, n_local, ranks, xs,
# outs, table, H, sub, nb, nb_cap, x_stride, x_len, x_size, epoch, sys, stream
_LAUNCH_ARGS = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
                + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                + [ctypes.c_longlong] * 3
                + [ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p])


def _entry(lib: str, what: str):
    argtypes = {"launch": _LAUNCH_ARGS,
                "capacity": [ctypes.POINTER(ctypes.c_int)],
                "enable_peer": [ctypes.c_int]}[what]
    return K._kernel(lib, f"{lib}_{what}", argtypes)


def ring_capacity(lib: str, device) -> int:
    """Blocks of the ring kernel ``lib`` that one card holds at once (blocks
    per SM x SMs): at most that many blocks of all the card's ranks."""
    device = _canonical(torch.device(device))
    key = (lib, device.index)
    with _state_lock:
        if key in _capacity:
            return _capacity[key]
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        K._check_launch(f"{lib} capacity",
                        _entry(lib, "capacity")(ctypes.byref(blocks)))
    with _state_lock:
        _capacity[key] = blocks.value
    return blocks.value


def _enable_peers(lib: str, devices) -> None:
    cards = sorted({d.index for d in devices})
    if len(cards) < 2:
        return
    _check_peers(devices)
    n = len(devices)
    for r in range(n):
        a, b = devices[r].index, devices[(r + 1) % n].index
        for src, dst in ((a, b), (b, a)):
            if src == dst or (lib, src, dst) in _peers_enabled:
                continue
            with torch.cuda.device(src):
                K._check_launch(f"{lib} peer access {src}->{dst}",
                                _entry(lib, "enable_peer")(dst))
            _peers_enabled.add((lib, src, dst))


def _blocks_per_rank(lib: str, cards: dict, elems: int) -> int:
    """Blocks each rank runs: one per BLOCK_ELEMS of the ``elems`` a rank
    sends per step, as many as every card holds for all its ranks at once.
    Raises ``ValueError`` naming the ranks when one launch would run more
    than MAX_LOCAL_RANKS of them, or when a card cannot hold one block per
    rank."""
    nb = _ceil(elems, BLOCK_ELEMS)
    for card, ranks in cards.items():
        local = len(ranks)
        if local > MAX_LOCAL_RANKS:
            raise ValueError(
                f"{lib}: R={local} ranks on cuda:{card}; one launch runs at "
                f"most {MAX_LOCAL_RANKS} ranks of a card")
        cap = ring_capacity(lib, torch.device("cuda", card))
        if local > cap:
            raise ValueError(
                f"{lib}: R={local} ranks on cuda:{card} need at least {local} "
                f"co-resident blocks of {THREADS} threads (one per rank), and "
                f"the card holds {cap}")
        nb = min(nb, cap // local)
    return nb


def _order_after_fill(cards: Sequence[int]) -> None:
    """Make every card's current stream wait until every other card's
    current stream has done its work so far.  Each card zero-fills its own
    ranks' flags on its own stream, and a ring on one card stores into its
    neighbours' flags on other cards: its first launch must not run before
    those fills, or a late fill would wipe the flags it released."""
    if len(cards) < 2:
        return
    filled = []
    for card in cards:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(card))
        filled.append((card, event))
    for card in cards:
        stream = torch.cuda.current_stream(card)
        for other, event in filled:
            if other != card:
                stream.wait_event(event)


def _get_scratch(lib: str, devices, words: int,
                 nb: int) -> Tuple[_Scratch, int]:
    """The scratch of ``lib`` on ``devices`` with at least ``words`` slot
    words and flags for ``nb`` blocks per rank (made anew, and ordered on
    every card after its fills, when the old one is too small), and this
    call's epoch."""
    key = (lib, devices)
    with _state_lock:
        sc = _scratch.get(key)
        if sc is None or sc.slot_words < words or sc.nb_cap < nb:
            sc = _Scratch(devices, max(words, sc.slot_words if sc else 0),
                          max(nb, sc.nb_cap if sc else 0))
            _order_after_fill(sorted({d.index for d in devices}))
            _scratch[key] = sc
        sc.epoch += 1
        return sc, sc.epoch


def _ring_cuda(xs, phase: str, one_way: bool, scale: Optional[float] = None):
    """The ring protocol (``csrc/ring.cuh``): the route of ranks spread over
    several cards, one cooperative launch per card.  ``scale`` multiplies
    the results after the ring, as a separate operation."""
    lib = "ring_all_reduce" if one_way else "bidir_ring"
    if xs[0].dtype not in _DTYPE_CODES:
        raise ValueError(f"{lib} on CUDA takes float32 or int32 tensors, got "
                         f"{xs[0].dtype}")
    n = len(xs)
    devices = tuple(_canonical(x.device) for x in xs)
    shape = tuple(xs[0].shape)
    layout = _layout(phase, shape, n, one_way)
    D, H, x_stride, x_len, x_size = layout
    if H == 0:
        outs = [_extract(torch.empty((n, D, 0), dtype=x.dtype, device=d),
                         phase, shape, n, r, layout)
                for r, (x, d) in enumerate(zip(xs, devices))]
        return outs if scale is None else [t * scale for t in outs]
    _enable_peers(lib, devices)
    cards: dict = {}
    for r, d in enumerate(devices):
        cards.setdefault(d.index, []).append(r)
    nb = _blocks_per_rank(lib, cards, D * H)
    grain = CHUNK // D  # a block's share of each piece: whole grains
    sub = _ceil(_ceil(H, grain), nb) * grain
    nb = _ceil(H, sub)
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty((n, D, H), dtype=x.dtype, device=d)
            for x, d in zip(xs, devices)]
    sc, epoch = _get_scratch(lib, devices, 2 * D * H, nb)
    fn = _entry(lib, "launch")
    sys_scope = int(len(cards) > 1)
    for card, ranks in cards.items():
        dev = torch.device("cuda", card)
        c_ranks = (ctypes.c_int * len(ranks))(*ranks)
        c_xs = (ctypes.c_void_p * len(ranks))(*(xs[r].data_ptr()
                                                for r in ranks))
        c_outs = (ctypes.c_void_p * len(ranks))(*(outs[r].data_ptr()
                                                  for r in ranks))
        with torch.cuda.device(dev):
            err = fn(_DTYPE_CODES[xs[0].dtype], PHASES[phase], n, len(ranks),
                     c_ranks, c_xs, c_outs, K._p(sc.tables[dev]), H, sub, nb,
                     sc.nb_cap, x_stride, x_len, x_size, epoch, sys_scope,
                     K._stream(dev))
        if err != 0:
            raise RuntimeError(
                f"{lib}: the cooperative launch of {nb} blocks for each of "
                f"R={len(ranks)} ranks on {dev} failed with cudaError_t {err}"
                f" (720: more blocks than the card holds at once)")
        K._count(f"{lib}.ring")
    outs = [_extract(o, phase, shape, n, r, layout)
            for r, o in enumerate(outs)]
    return outs if scale is None else [t * scale for t in outs]


class _Desc(ctypes.Structure):
    """csrc/oneshot.cuh ``oneshot::Desc``: one call shape's constants."""

    _fields_ = [("size", ctypes.c_longlong), ("H", ctypes.c_longlong),
                ("part", ctypes.c_longlong), ("scale", ctypes.c_float),
                ("has_scale", ctypes.c_int), ("dtype", ctypes.c_int),
                ("phase", ctypes.c_int), ("n", ctypes.c_int),
                ("D", ctypes.c_int), ("vec", ctypes.c_int)]


class _OneShotCall:
    """The one-shot for one call shape (phase, layout, input shape, R,
    dtype, scale), everything but the pointers worked out once: each
    rank's result shape in one ``(R, *result)`` buffer, the JAX layout's
    piece length and directions, whether 16-byte positions apply (the
    size, and for ``rs`` each rank's block, a multiple of 4; the C entry
    also checks the pointers' alignment), and the bound C entry."""

    def __init__(self, phase: str, shape, n: int, one_way: bool, dtype,
                 scale: Optional[float], card: int):
        self.lib = "ring_all_reduce" if one_way else "bidir_ring"
        if dtype not in _DTYPE_CODES:
            raise ValueError(f"{self.lib} on CUDA takes float32 or int32 "
                             f"tensors, got {dtype}")
        if scale is not None and dtype != torch.float32:
            raise ValueError(f"{self.lib}: a scale applies to float32 sums, "
                             f"got {dtype}")
        if n > MAX_LOCAL_RANKS:
            raise ValueError(f"{self.lib}: R={n} ranks on one card; one "
                             f"launch runs at most {MAX_LOCAL_RANKS} ranks "
                             f"of a card")
        shape = tuple(shape)
        D, H, _, _, size = _layout(phase, shape, n, one_way)
        part = size // n if phase == "rs" else size
        if phase == "rs":
            out_shape = (shape[0] // n,) + shape[1:]
        elif phase == "ag":
            out_shape = (n * shape[0],) + shape[1:]
        else:
            out_shape = shape
        self.n, self.shape, self.dtype, self.card = n, shape, dtype, card
        self.buf_shape = (n,) + out_shape
        # the result buffer's shape, dtype and card on one element:
        # empty_like of it is the cheapest allocation per call
        self.like = torch.empty(1, dtype=dtype, device=(
            card if card >= 0 else "cpu")).expand(self.buf_shape)
        self.out_elems = math.prod(out_shape)
        self.desc = _Desc(size, H, part, 0.0 if scale is None else scale,
                          int(scale is not None), _DTYPE_CODES[dtype],
                          PHASES[phase], n, D,
                          int(size % 4 == 0 and part % 4 == 0))
        self.desc_ptr = ctypes.addressof(self.desc)
        self.fn = None

    def fast(self, xs) -> Optional[List[torch.Tensor]]:
        """The launch for R contiguous tensors of this call's shape and
        dtype on its card, checked in the one pass that reads their
        addresses; None when any rank differs (the caller then takes the
        checks that name the fault, or another route)."""
        shape, dtype, card = self.shape, self.dtype, self.card
        ptrs = []
        for x in xs:
            if (x.shape != shape or x.dtype is not dtype
                    or x.get_device() != card or not x.is_contiguous()):
                return None
            ptrs.append(x.data_ptr())
        return self.launch(ptrs)

    def __call__(self, xs) -> List[torch.Tensor]:
        xs = [x.contiguous() for x in xs]  # alive until the launch
        return self.launch([x.data_ptr() for x in xs])

    def launch(self, ptrs: list) -> List[torch.Tensor]:
        out = torch.empty_like(self.like)
        if self.out_elems:
            if self.fn is None:
                self.fn = _oneshot_entry(self.lib)
            card = self.card
            base = out.data_ptr()
            step = self.out_elems * out.element_size()
            ptrs += range(base, base + self.n * step, step)
            ptrs.append(torch._C._cuda_getCurrentRawStream(card))
            # the 2n + 1 addresses as one buffer of 64-bit words
            words = array.array("Q", ptrs)
            if card == torch._C._cuda_getDevice():
                err = self.fn(self.desc_ptr, words.buffer_info()[0])
            else:
                with torch.cuda.device(card):
                    err = self.fn(self.desc_ptr, words.buffer_info()[0])
            if err:
                K._check_launch(f"{self.lib} one-shot", err)
            K._count(self.lib)
        return list(torch.unbind(out))


_calls: dict = {}  # (phase, one_way, scale, R, shape, dtype, card) -> call
_oneshot_entries: dict = {}  # lib -> its bound C entry NAME_oneshot


def _oneshot_entry(lib: str):
    """``<lib>_oneshot`` of the built library, bound through ``ctypes.PyDLL``:
    the call keeps the GIL, which saves its release and re-acquisition (~1
    us of a ~15 us wrapper call, H100 host) around a launch that only
    queues work."""
    fn = _oneshot_entries.get(lib)
    if fn is None:
        from ..ops.cuda_build import build

        fn = getattr(ctypes.PyDLL(str(build(lib).path)), f"{lib}_oneshot")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _oneshot_entries[lib] = fn
    return fn


def _oneshot(xs, phase: str, one_way: bool, scale: Optional[float] = None):
    """The one-shot kernel (``csrc/oneshot.cuh``): every rank on one card,
    one launch on its current stream, the results written straight into
    one ``(R, *result)`` buffer whose rows are returned."""
    x0 = xs[0]
    key = (phase, one_way, scale, len(xs), x0.shape, x0.dtype,
           x0.get_device())
    call = _calls.get(key)
    if call is None:
        call = _OneShotCall(phase, x0.shape, len(xs), one_way, x0.dtype,
                            scale, key[-1])
        _calls[key] = call
    return call(xs)


def _cards(xs) -> set:
    """The card index of every rank (-1 on the CPU)."""
    return {x.get_device() for x in xs}


def _collective(xs, phase: str, one_way: bool, name: str,
                scale: Optional[float] = None):
    # a call shape the one-shot has run before: one pass over the ranks (on
    # one card the wrapper's host time is most of a call)
    if type(xs) is list and len(xs) > 1 and type(xs[0]) is torch.Tensor:
        x0 = xs[0]
        call = _calls.get((phase, one_way, scale, len(xs), x0.shape,
                           x0.dtype, x0.get_device()))
        if call is not None:
            out = call.fast(xs)
            if out is not None:
                return out
    xs = _check_inputs(xs, name)
    _check_phase_shape(xs, phase)
    if len(xs) == 1:
        return list(xs) if scale is None else [xs[0] * scale]
    cards = _cards(xs)
    if -1 in cards:
        return oneshot_ref(xs, phase, one_way, scale)
    if len(cards) == 1:
        return _oneshot(xs, phase, one_way, scale)
    return _ring_cuda(xs, phase, one_way, scale)


def ring_all_reduce(xs, scale: Optional[float] = None) -> List[torch.Tensor]:
    """Sum the R per-rank tensors with the one-way ring (``psum``): returns R
    tensors, each the sum, in the input's shape and dtype (f32 or int32 on
    CUDA; any dtype on the CPU).  One rank returns its input.  ``scale``
    multiplies the finished sum (f32 on CUDA), as ``sum * scale`` would."""
    return _collective(xs, "ar", True, "ring_all_reduce", scale)


def ring_all_reduce_bidir(xs, scale: Optional[float] = None
                          ) -> List[torch.Tensor]:
    """Sum the R per-rank tensors with the bidirectional ring (``psum``):
    each chunk's two pieces travel opposite ways round the ring.
    ``scale`` as for :func:`ring_all_reduce`."""
    return _collective(xs, "ar", False, "ring_all_reduce_bidir", scale)


def ring_reduce_scatter(xs) -> List[torch.Tensor]:
    """Bidirectional ring reduce-scatter (``psum_scatter``, tiled): rank r
    gets the summed r-th block of the leading axis.  ``shape[0]`` must be
    divisible by the ring size."""
    return _collective(xs, "rs", False, "ring_reduce_scatter")


def ring_all_gather(xs) -> List[torch.Tensor]:
    """Bidirectional ring all-gather (``all_gather``, tiled): every rank
    gets the leading-axis concatenation of the R shards in rank order."""
    return _collective(xs, "ag", False, "ring_all_gather")


# ---------------------------------------------------------------------------
# The data-parallel whole step
# ---------------------------------------------------------------------------


class _DPStep:
    """``step(xb, yb, ws, bs) -> (loss, new_ws, new_bs)``: see
    :func:`dp_megakernel_train_step`."""

    def __init__(self, group: RankGroup, acts, lr, precision: str,
                 bidirectional: bool):
        self.group, self.acts, self.lr = group, list(acts), lr
        self.precision = precision
        self.all_reduce = (ring_all_reduce_bidir if bidirectional
                           else ring_all_reduce)
        self.replicas = None

    def __call__(self, xb, yb, ws, bs):
        devs = self.group.devices
        n = len(devs)
        if xb.shape[0] % n or yb.shape[0] != xb.shape[0]:
            raise ValueError(
                f"dp_megakernel_train_step: a global batch of {xb.shape[0]} "
                f"rows (targets {yb.shape[0]}) does not split over {n} ranks")
        k = xb.shape[0] // n
        losses, new_ws, new_bs = [], [], []
        for r, d in enumerate(devs):
            loss, w_r, b_r = K.fused_mlp_train_step(
                xb[r * k:(r + 1) * k].to(d), yb[r * k:(r + 1) * k].to(d),
                [w.to(d) for w in ws], [b.to(d) for b in bs], self.lr,
                self.acts, precision=self.precision)
            losses.append(loss)
            new_ws.append(w_r)
            new_bs.append(b_r)
        inv = 1.0 / n
        # one ring call per tensor, as the JAX step does; the 1/n is the
        # collective's scale, applied to each finished sum
        red_w = [self.all_reduce([w_r[i] for w_r in new_ws], scale=inv)
                 for i in range(len(ws))]
        red_b = [self.all_reduce([b_r[i] for b_r in new_bs], scale=inv)
                 for i in range(len(bs))]
        self.replicas = [([t[r] for t in red_w], [t[r] for t in red_b])
                         for r in range(n)]
        total = losses[0]
        for v in losses[1:]:
            total = total + v.to(total.device)
        return total * inv, self.replicas[0][0], self.replicas[0][1]


def dp_megakernel_train_step(group: RankGroup, acts, *, lr,
                             precision: str = "default",
                             bidirectional: bool = True) -> _DPStep:
    """Data-parallel whole-step training over the ranks of ``group``: each
    rank runs ``fused_mlp_train_step`` (kernel 3) on its shard of the global
    batch (split in rank order along the leading axis), then every updated
    weight and bias is summed by the ring (one call per tensor; kernel 9
    with ``bidirectional=True``, the default, kernel 8 with ``False``) and
    multiplied by ``1 / n`` inside that call: the mean-gradient SGD step on
    the whole batch.
    The loss is the rank-order sum of the ranks' losses times ``1 / n``.

    Returns ``step(xb, yb, ws, bs) -> (loss, new_ws, new_bs)``.  ``ws`` and
    ``bs`` are one copy of the parameters, moved to each rank's device as
    needed; every rank then holds its own copy of the result, identical on
    all ranks, and ``step.replicas`` keeps them (a list of ``(ws, bs)`` per
    rank) until the next call.  ``new_ws``/``new_bs`` are rank 0's copy and
    the loss lies on rank 0's device."""
    return _DPStep(group, acts, lr, precision, bidirectional)
