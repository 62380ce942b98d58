"""Training in several processes: the counterpart of
``tensor_ops_tpu/parallel/distributed.py``.

The JAX package wires its hosts into one global device mesh with
``jax.distributed.initialize``.  Here every process runs the same program
(one process per card, the torchrun layout, or several CPU ranks per
process where the caller asks for them), and :func:`init_distributed`
wires them together:

    from tensor_ops_tpu_torch.parallel.distributed import init_distributed
    init_distributed()                  # TOPS_* or the launcher's env
    mesh = make_mesh()                  # the GLOBAL ranks, process-major
    fit(net, loss, be, X, Y, mesh=mesh, ...)

A mesh is then global over every process's ranks in process-major order
(process p owns a contiguous block of flat ranks, as ``jax.devices()`` is
ordered), each :class:`~.mesh.Sharded` leaf holds tensors for its own
process's ranks only, and every collective between ranks of several
processes still runs kernel 9 (:mod:`.collective_kernels`): on the CPU the
ranks' inputs cross as bytes over gloo and fold in the ring's order, on
cards the kernels read and write each other's buffers through CUDA IPC.
``torch.distributed`` with gloo carries only the host side: those bytes on
the CPU, the IPC handles, and the barriers that order the processes.
Every wait has a finite timeout (``timeout_s``, 60 s by default), so a
process that never arrives fails the others in seconds, not hours.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

_initialized = False   # this module created the default process group
_table: Optional[Tuple["GlobalDevice", ...]] = None  # every process's ranks
_local: Optional[Tuple[str, ...]] = None  # this process's ranks' devices
_groups: Dict[Tuple[int, ...], object] = {}
_timeout = datetime.timedelta(seconds=60)


@dataclass(frozen=True)
class GlobalDevice:
    """One rank of the global device list: the process that holds it, its
    device as named in that process, and the identity of its card (the
    card's UUID; empty on the CPU), which tells two processes that they
    share one card."""

    proc: int
    device: str
    card: str


def _dist():
    import torch.distributed as dist

    return dist


def _card_id(device: str) -> str:
    d = torch.device(device)
    if d.type != "cuda":
        return ""
    return str(torch.cuda.get_device_properties(
        d.index if d.index is not None else torch.cuda.current_device()).uuid)


def _resolve_local(local_devices,
                   local_rank: Optional[int] = None) -> Tuple[str, ...]:
    """This process's ranks: the argument, else ``TOPS_LOCAL_DEVICES``
    (comma-separated, e.g. ``cpu,cpu,cpu,cpu`` or ``cuda:0,cuda:0``), else
    under a launcher that names this process's place on its node
    (``local_rank``: torchrun's ``LOCAL_RANK``) the card of that index,
    else one rank per visible card (none without a card: the CPU is taken
    only when asked for)."""
    if local_devices is None and os.environ.get("TOPS_LOCAL_DEVICES"):
        local_devices = os.environ["TOPS_LOCAL_DEVICES"].split(",")
    if local_devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local_rank is None:
            local_devices = [f"cuda:{i}" for i in range(n)]
        elif local_rank < n:
            local_devices = [f"cuda:{local_rank}"]
        else:
            raise ValueError(
                f"init_distributed: LOCAL_RANK={local_rank} with {n} "
                f"card(s) visible; name this process's devices in "
                f"TOPS_LOCAL_DEVICES")
    return tuple(str(torch.device(d.strip() if isinstance(d, str) else d))
                 for d in local_devices)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     local_devices: Optional[Sequence] = None,
                     timeout_s: float = 60.0) -> dict:
    """Initialize the multi-process runtime (idempotent).

    Argument resolution order: explicit args > ``TOPS_COORDINATOR`` /
    ``TOPS_NUM_PROCESSES`` / ``TOPS_PROCESS_ID`` > the launcher's
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` (taken
    only when neither of the first two names a coordinator; the
    counterpart of JAX's pod auto-discovery; with them ``LOCAL_RANK``,
    which gives the process its one card).  The coordinator is a
    ``host:port`` where process 0 listens (``torch.distributed``'s TCP
    rendezvous, gloo backend, ``timeout_s`` on every wait).  Single-process
    runs (no coordinator configured anywhere) are a no-op.

    ``local_devices`` (or ``TOPS_LOCAL_DEVICES``) names this process's
    ranks; by default the card ``LOCAL_RANK`` names under the launcher,
    else one rank per visible card.  Returns a summary dict:
    ``{initialized, process_index, process_count, local_devices,
    global_devices}``."""
    global _initialized, _table, _local, _timeout
    dist = _dist()

    coordinator_address = coordinator_address or os.environ.get(
        "TOPS_COORDINATOR")
    if num_processes is None and "TOPS_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["TOPS_NUM_PROCESSES"])
    if process_id is None and "TOPS_PROCESS_ID" in os.environ:
        process_id = int(os.environ["TOPS_PROCESS_ID"])
    local_rank = None
    if (coordinator_address is None and "MASTER_ADDR" in os.environ
            and "WORLD_SIZE" in os.environ):
        if "LOCAL_RANK" in os.environ:
            local_rank = int(os.environ["LOCAL_RANK"])
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
        if num_processes is None:
            num_processes = int(os.environ["WORLD_SIZE"])
        if process_id is None:
            process_id = int(os.environ.get("RANK", "0"))
    if _local is None or local_devices is not None:
        _local = _resolve_local(local_devices, local_rank)
    if not _initialized and coordinator_address is not None and not (
            dist.is_available() and dist.is_initialized()):
        if num_processes is None or process_id is None:
            raise ValueError(
                f"init_distributed: coordinator {coordinator_address!r} "
                f"needs num_processes and process_id (or "
                f"TOPS_NUM_PROCESSES / TOPS_PROCESS_ID)")
        _timeout = datetime.timedelta(seconds=timeout_s)
        dist.init_process_group(backend="gloo",
                                init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes),
                                rank=int(process_id), timeout=_timeout)
        _initialized = True
    if _table is None and process_count() > 1:
        from . import collective_kernels as CK

        rows = [(d, _card_id(d)) for d in _local]
        every: List = [None] * process_count()
        dist.all_gather_object(every, rows)
        _table = tuple(GlobalDevice(p, d, c) for p, rows_p in
                       enumerate(every) for d, c in rows_p)
        CK._MULTI = True
    return {
        "initialized": _initialized,
        "process_index": process_index(),
        "process_count": process_count(),
        "local_devices": len(_local),
        "global_devices": len(global_devices()),
    }


def shutdown_distributed() -> None:
    """Tear down the process group this module made (end-of-program
    hygiene), after a barrier so that no process leaves while another
    still waits on it."""
    global _initialized, _table
    if _initialized:
        from . import collective_kernels as CK

        dist = _dist()
        if dist.is_initialized():
            dist.barrier()
            CK._release_ipc()
            dist.destroy_process_group()
        _initialized = False
        _table = None
        _groups.clear()
        CK._MULTI = False


def process_count() -> int:
    """The number of processes of the run (1 without a process group)."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's index (0 without a process group)."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def local_devices() -> Tuple[str, ...]:
    """This process's ranks' devices (:func:`init_distributed`'s
    resolution; by default the visible cards)."""
    return _local if _local is not None else _resolve_local(None)


def global_devices() -> Tuple[GlobalDevice, ...]:
    """Every process's ranks, process-major: process p's ranks form one
    contiguous block (a single process: its own)."""
    if process_count() > 1:
        if _table is None:
            raise RuntimeError("several processes: call init_distributed() "
                               "in every process before building a mesh")
        return _table
    return tuple(GlobalDevice(0, d, "") for d in local_devices())


def register_groups(proc_sets) -> None:
    """Make a gloo group for each set of processes (of two or more, short
    of all) that a mesh's collectives span.  Every process calls this with
    the same sets, in the same order (a mesh is built in every process)."""
    if process_count() <= 1:
        return
    every = tuple(range(process_count()))
    for procs in sorted({tuple(sorted(s)) for s in proc_sets}):
        if len(procs) > 1 and procs != every and procs not in _groups:
            _groups[procs] = _dist().new_group(list(procs), timeout=_timeout,
                                               backend="gloo")


def group(procs: Sequence[int]):
    """The gloo group of ``procs`` (sorted; the world for all of them)."""
    procs = tuple(sorted(procs))
    if procs == tuple(range(process_count())):
        return None
    try:
        return _groups[procs]
    except KeyError:
        raise RuntimeError(f"no process group for processes {procs}: the "
                           f"mesh that spans them registers it") from None


def barrier(procs: Sequence[int]) -> None:
    """Wait until every process of ``procs`` reaches this point."""
    _dist().barrier(group=group(procs))


def all_gather_bytes(procs: Sequence[int], buf: torch.Tensor) -> list:
    """Each process of ``procs`` contributes ``buf`` (uint8 on the CPU, the
    same length in all of them); returns the buffers in process order."""
    g = group(procs)
    out = [torch.empty_like(buf) for _ in procs]
    _dist().all_gather(out, buf, group=g)
    return out


def all_gather_object(procs: Sequence[int], obj) -> list:
    """``obj`` of every process of ``procs``, in process order."""
    out: List = [None] * len(procs)
    _dist().all_gather_object(out, obj, group=group(procs))
    return out


def broadcast_object(obj, src: int = 0):
    """Process ``src``'s ``obj`` in every process (one process: ``obj``)."""
    if process_count() <= 1:
        return obj
    box = [obj]
    _dist().broadcast_object_list(box, src=src)
    return box[0]
