"""The batch orders of the training loops, worked out again without the
program, so that a reference can follow the window's own batches.

``fit``'s loader (``native/tensorops_native.cpp``) shuffles its order in
place at the start of each epoch, with ``std::shuffle`` driven by
``std::mt19937_64`` seeded with ``seed + 0x9e3779b97f4a7c15 * epoch``
(epochs counted from 1), so each epoch reorders the last one's order.
Here are that engine and libstdc++'s ``std::shuffle`` (GCC 11 and later:
two swap positions from one draw where the engine's range allows, and
``uniform_int_distribution`` by Lemire's multiply-and-reject).
``fit_sequences`` draws each epoch's order as ``np.random.default_rng(seed)
.permutation(n)``, one call an epoch.
"""

from __future__ import annotations

from typing import List

import numpy as np

M64 = (1 << 64) - 1
GOLDEN = 0x9E3779B97F4A7C15


class MT19937_64:
    """``std::mt19937_64``: 312 words of state, tempered 64-bit outputs."""

    N, M = 312, 156
    A = np.uint64(0xB5026F5AA96619E9)
    UPPER = np.uint64(0xFFFFFFFF80000000)
    LOWER = np.uint64(0x7FFFFFFF)

    def __init__(self, seed: int):
        mt = [int(seed) & M64]
        for i in range(1, self.N):
            prev = mt[-1]
            mt.append((6364136223846793005 * (prev ^ (prev >> 62)) + i) & M64)
        self.mt = np.array(mt, dtype=np.uint64)
        self.out: List[int] = []
        self.pos = 0

    def _twist(self):
        mt, N, M = self.mt, self.N, self.M
        one = np.uint64(1)

        def mix(hi, lo):
            y = (hi & self.UPPER) | (lo & self.LOWER)
            return (y >> one) ^ np.where(y & one, self.A, np.uint64(0))

        mt[:N - M] = mt[M:] ^ mix(mt[:N - M], mt[1:N - M + 1])
        mt[N - M:N - 1] = mt[:M - 1] ^ mix(mt[N - M:N - 1], mt[N - M + 1:])
        mt[N - 1] = mt[M - 1] ^ mix(mt[N - 1:], mt[:1])[0]
        z = mt.copy()
        z ^= (z >> np.uint64(29)) & np.uint64(0x5555555555555555)
        z ^= (z << np.uint64(17)) & np.uint64(0x71D67FFFEDA60000)
        z ^= (z << np.uint64(37)) & np.uint64(0xFFF7EEE000000000)
        z ^= z >> np.uint64(43)
        self.out = [int(v) for v in z]
        self.pos = 0

    def __call__(self) -> int:
        if self.pos == len(self.out):
            self._twist()
        v = self.out[self.pos]
        self.pos += 1
        return v


def _below(g: MT19937_64, r: int) -> int:
    """``uniform_int_distribution{0, r - 1}(g)`` of libstdc++ for a 64-bit
    engine: the high word of ``g() * r``, drawn again while the low word
    falls under ``2**64 mod r``."""
    prod = g() * r
    low = prod & M64
    if low < r:
        threshold = ((1 << 64) - r) % r
        while low < threshold:
            prod = g() * r
            low = prod & M64
    return prod >> 64


def std_shuffle(n: int, g: MT19937_64) -> np.ndarray:
    """``std::shuffle`` of ``[0, n)`` by libstdc++ with the engine ``g``."""
    a = list(range(n))
    if n < 2:
        return np.asarray(a, dtype=np.int64)
    if M64 // n >= n:
        i = 1
        if n % 2 == 0:
            j = _below(g, 2)
            a[1], a[j] = a[j], a[1]
            i = 2
        while i != n:
            b0 = i + 1
            x = _below(g, b0 * (b0 + 1))
            j0, j1 = x // (b0 + 1), x % (b0 + 1)
            a[i], a[j0] = a[j0], a[i]
            a[i + 1], a[j1] = a[j1], a[i + 1]
            i += 2
    else:
        for i in range(1, n):
            j = _below(g, i + 1)
            a[i], a[j] = a[j], a[i]
    return np.asarray(a, dtype=np.int64)


def native_epochs(seed: int, epochs: int, n: int) -> List[np.ndarray]:
    """The row orders of ``fit``'s loader in its first ``epochs`` epochs."""
    order, out = np.arange(n), []
    for e in range(1, epochs + 1):
        g = MT19937_64((int(seed) + GOLDEN * e) & M64)
        order = order[std_shuffle(n, g)]
        out.append(order)
    return out


def seq_epochs(seed: int, epochs: int, n: int) -> List[np.ndarray]:
    """The sequence orders of ``fit_sequences``' first ``epochs`` epochs."""
    rng = np.random.default_rng(int(seed))
    return [rng.permutation(n) for _ in range(epochs)]
