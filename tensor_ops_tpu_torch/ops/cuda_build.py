"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface; kernels
may share ``csrc/*.cuh`` headers.  At first use it is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` at the root of the checkout, and loaded with ``ctypes``.
The library's file name carries a hash of the source, of every header in
``csrc/`` and of the flags, so an edited source or header is rebuilt and a
stale library is never loaded.  Nothing here runs at import: a build needs ``nvcc``, which only
the machine with the card has.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # per-kernel registers, shared memory and spills into the log
              "-Xptxas", "-v")
CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"


@dataclass(frozen=True)
class Built:
    """A loaded kernel library and what its build took."""

    lib: ctypes.CDLL
    path: Path
    seconds: float  # compile time; 0.0 when an up-to-date library was found
    log: str        # nvcc's output (ptxas resource usage), "" when reused


_lock = threading.Lock()  # guards _locks and _loaded
_locks: dict = {}         # one per kernel, so different kernels build at once
_loaded: dict = {}


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels are built from source on the machine with the GPU")


def source_digest(name: str, csrc: Path = CSRC_DIR) -> str:
    """The hash in the library's file name: ``csrc/<name>.cu``, every
    ``csrc/*.cuh`` (by name and content) and the nvcc flags."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` if its library is missing or stale, load
    it, and return it.  Raises ``RuntimeError`` with nvcc's output when the
    compile fails.  Different kernels may be built from several threads at
    once; one kernel is built once."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        src = CSRC_DIR / f"{name}.cu"
        digest = source_digest(name)
        so = BUILD_DIR / f"{name}-{digest}.so"
        seconds, log = 0.0, ""
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = BUILD_DIR / f"{name}-{digest}.{os.getpid()}.tmp.so"
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    capture_output=True, text=True)
                log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed to build {src} "
                        f"(exit {proc.returncode}):\n{log}")
                os.replace(tmp, so)  # atomic: no reader sees a partial file
            finally:
                if tmp.exists():
                    tmp.unlink()
            seconds = time.perf_counter() - t0
        built = Built(ctypes.CDLL(str(so)), so, seconds, log)
        with _lock:
            _loaded[name] = built
        return built
