"""ctypes bindings for the repository's C++ runtime
(``native/tensorops_native.cpp``), built on first use, and the training
data path: the threaded shuffled loader and the device prefetcher.

The shared library is compiled once with g++ into ``build/native/`` (the
JAX package builds its own copy into ``native/build/``; the two never
share a file).  Plain C ABI + ``ctypes``.  Every entry point has a NumPy
fallback, so a host without a toolchain still trains: the loader's
fallback is the reference's own host-side behaviour, and its shuffle
order differs from the native one (each is deterministic per seed).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from collections import deque
from typing import Optional, Tuple

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "tensorops_native.cpp")
_SO = os.path.join(_ROOT, "build", "native", "libtensorops_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    # Compile to a PID-suffixed temp path and os.replace() into place:
    # concurrent first-use builds (test workers, ranks) must never dlopen
    # a partially written .so or clobber each other mid-write.  Portable
    # flags: -march=native would SIGILL on a weaker ISA.
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
           _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it on first use; None if there
    is no toolchain or the build fails (callers fall back to NumPy)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_SO)
        ):
            if not os.path.exists(_SRC) or not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        c_dp = ctypes.POINTER(ctypes.c_double)
        c_fp = ctypes.POINTER(ctypes.c_float)
        lib.top_gmul.restype = None
        lib.top_gmul.argtypes = [c_dp, c_dp, c_dp, c_i64p, ctypes.c_int,
                                 ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int64]
        lib.top_transpose.restype = None
        lib.top_transpose.argtypes = [c_dp, c_dp, c_i64p, ctypes.c_int]
        lib.top_loader_create.restype = ctypes.c_void_p
        lib.top_loader_create.argtypes = [
            c_fp, c_fp, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_uint64, ctypes.c_int, ctypes.c_int]
        lib.top_loader_next.restype = ctypes.c_int64
        lib.top_loader_next.argtypes = [ctypes.c_void_p, c_fp, c_fp]
        lib.top_loader_next_idx.restype = ctypes.c_int64
        lib.top_loader_next_idx.argtypes = [ctypes.c_void_p, c_i64p]
        lib.top_loader_destroy.restype = None
        lib.top_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def native_gmul(lm: int, lo: int, ln: int, x: np.ndarray, y: np.ndarray
                ) -> Optional[np.ndarray]:
    """gmul (x's trailing ``lo`` axes against y's leading ``lo`` in reversed
    order) by the C++ kernel in f64; None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    ms = x.shape[:lm]
    os_ = np.asarray(x.shape[lm:], dtype=np.int64)
    ns = y.shape[lo:]
    M = int(np.prod(ms)) if ms else 1
    O = int(np.prod(os_)) if lo else 1
    N = int(np.prod(ns)) if ns else 1
    out = np.zeros(ms + ns, dtype=np.float64)
    lib.top_gmul(_dp(x), _dp(y), _dp(out), _ip(os_), lo, M, O, N)
    return out


def native_transpose(x: np.ndarray) -> Optional[np.ndarray]:
    """All axes reversed, by the C++ kernel in f64; None when the library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    shape = np.asarray(x.shape, dtype=np.int64)
    out = np.empty(tuple(reversed(x.shape)), dtype=np.float64)
    lib.top_transpose(_dp(x), _dp(out), _ip(shape), x.ndim)
    return out


class DevicePrefetcher:
    """Keep the next ``depth`` batches of ``loader`` already on ``device``.

    On a CUDA device each host batch is pinned and copied by a
    non-blocking host-to-device copy on a side stream, and an event
    recorded after it; ``next()`` makes the current stream wait on that
    event before handing the batch out, so batch k+1's copy overlaps batch
    k's step.  On the CPU the batch is only converted.  Batches come out
    in the loader's order."""

    def __init__(self, loader, device, dtype: torch.dtype, depth: int = 2):
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self.loader = loader
        self.device = torch.device(device)
        self.dtype = dtype
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._q = deque(self._put(*loader.next()) for _ in range(depth))

    def _put(self, xb: np.ndarray, yb: np.ndarray):
        if self._stream is None:
            return (torch.as_tensor(xb, dtype=self.dtype, device=self.device),
                    torch.as_tensor(yb, dtype=self.dtype, device=self.device),
                    None)
        # the pinned buffers may go out of scope at once: the caching host
        # allocator keeps a block until the copies that read it are done
        hx = torch.from_numpy(xb).pin_memory()
        hy = torch.from_numpy(yb).pin_memory()
        with torch.cuda.stream(self._stream):
            x = hx.to(self.device, self.dtype, non_blocking=True)
            y = hy.to(self.device, self.dtype, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return x, y, ready

    def next(self) -> Tuple[torch.Tensor, torch.Tensor]:
        x, y, ready = self._q.popleft()
        if ready is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ready)
            # allocated on the side stream, used on this one
            x.record_stream(cur)
            y.record_stream(cur)
        self._q.append(self._put(*self.loader.next()))
        return x, y


class NativeLoader:
    """Threaded shuffled minibatch loader (C++ worker + ring buffer); falls
    back to a NumPy generator when the native library is absent.  The same
    seed gives the same batches as the JAX package's ``NativeLoader`` on
    the same path (native or fallback)."""

    def __init__(self, X: np.ndarray, Y: np.ndarray, batch: int,
                 seed: int = 0, drop_last: bool = False,
                 shard: Optional[Tuple[int, int]] = None,
                 index_mode: bool = False):
        """``shard=(index, count)`` keeps every count-th row starting at
        index: the data-parallel per-process partition (shards are
        disjoint and cover the set; the shuffle stays per shard and
        seeded).

        ``index_mode=True`` makes the loader emit batch INDICES
        (``next_indices()``) from the same shuffle machinery (one seed =>
        the same batches as a gathered-mode loader); ``next()`` still
        works, gathering on the host from the indices."""
        if shard is not None:
            idx, n = shard
            if not (0 <= idx < n):
                raise ValueError(f"shard index {idx} not in [0, {n})")
            X = X[idx::n]
            Y = Y[idx::n]
        self.shard = shard
        self.X = np.ascontiguousarray(X, dtype=np.float32)
        self.Y = np.ascontiguousarray(Y, dtype=np.float32)
        if self.X.ndim != 2 or self.Y.ndim != 2:
            raise ValueError(
                f"NativeLoader expects 2-D X and Y, got {self.X.shape} / "
                f"{self.Y.shape} (one-hot or reshape labels to (n, 1))")
        if drop_last and self.X.shape[0] < batch:
            raise ValueError(
                f"drop_last with dataset ({self.X.shape[0]}) smaller than "
                f"one batch ({batch}) would never yield a batch")
        self.batch = int(batch)
        self.seed = int(seed)
        self.drop_last = drop_last
        self.index_mode = bool(index_mode)
        self._lib = get_lib()
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.top_loader_create(
                _fp(self.X), _fp(self.Y), self.X.shape[0],
                self.X.shape[1], self.Y.shape[1], self.batch,
                self.seed, int(drop_last), int(self.index_mode))
        else:
            self._rng = np.random.default_rng(seed)
            self._perm = self._rng.permutation(self.X.shape[0])
            self._cursor = 0

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    def _advance(self) -> np.ndarray:
        """The NumPy path's next batch of row indices (reshuffling at the
        end of an epoch; with ``drop_last``, a short tail is replaced by a
        full batch of the next epoch, as the native worker does)."""
        n = self.X.shape[0]
        if self._cursor >= n:
            self._perm = self._rng.permutation(n)
            self._cursor = 0
        take = min(self.batch, n - self._cursor)
        if self.drop_last and take < self.batch:
            self._perm = self._rng.permutation(n)
            self._cursor = 0
            take = self.batch
        idx = self._perm[self._cursor: self._cursor + take]
        self._cursor += take
        return idx

    def next(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.index_mode:
            idx = self.next_indices()
            return self.X[idx], self.Y[idx]
        if self._handle is not None:
            xout = np.empty((self.batch, self.X.shape[1]), dtype=np.float32)
            yout = np.empty((self.batch, self.Y.shape[1]), dtype=np.float32)
            took = self._lib.top_loader_next(self._handle, _fp(xout),
                                             _fp(yout))
            return xout[:took], yout[:took]
        idx = self._advance()
        return self.X[idx], self.Y[idx]

    def next_indices(self) -> np.ndarray:
        """Row indices of the next batch (``index_mode=True`` only)."""
        if not self.index_mode:
            raise ValueError(
                "next_indices() requires NativeLoader(index_mode=True) "
                "— the gathered-mode worker consumes the permutation as "
                "assembled rows, so the two streams cannot be mixed")
        if self._handle is not None:
            iout = np.empty(self.batch, dtype=np.int64)
            took = self._lib.top_loader_next_idx(self._handle, _ip(iout))
            return iout[:took]
        return np.asarray(self._advance(), dtype=np.int64)

    def skip(self, n: int) -> None:
        """Advance the stream by ``n`` batches without using their data:
        a resumed ``fit`` skips to its restored global step, so no batch
        is replayed."""
        if n <= 0:
            return
        if self._handle is None:
            for _ in range(n):
                self._advance()
            return
        if self.index_mode:
            iout = np.empty(self.batch, dtype=np.int64)
            for _ in range(n):
                self._lib.top_loader_next_idx(self._handle, _ip(iout))
            return
        xout = np.empty((self.batch, self.X.shape[1]), dtype=np.float32)
        yout = np.empty((self.batch, self.Y.shape[1]), dtype=np.float32)
        for _ in range(n):
            self._lib.top_loader_next(self._handle, _fp(xout), _fp(yout))

    def close(self) -> None:
        if self._handle is not None:
            self._lib.top_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
