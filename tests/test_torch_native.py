"""The port's native runtime (``tensor_ops_tpu_torch/utils/native.py``)
against the JAX package's: the threaded loader yields bit-identical
batches and indices for one seed on the native path and with both forced
to the NumPy fallback, ``skip`` lands where drained batches do, the C++
kernels match NumPy, and the device prefetcher keeps the loader's order
and its depth."""

import numpy as np
import pytest
import torch

from tensor_ops_tpu.utils import native as JN
from tensor_ops_tpu_torch import NumpyBackend
from tensor_ops_tpu_torch.utils import native as TN
from torch_threads import one_torch_thread  # noqa: F401


def dataset(n=100, seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n, 3)).astype(np.float32),
            r.normal(size=(n, 2)).astype(np.float32))


@pytest.fixture(params=["native", "fallback"])
def path(request, monkeypatch):
    if request.param == "fallback":
        monkeypatch.setattr(JN, "get_lib", lambda: None)
        monkeypatch.setattr(TN, "get_lib", lambda: None)
    elif TN.get_lib() is None or JN.get_lib() is None:
        pytest.skip("no C++ toolchain: the native library cannot build")
    return request.param


@pytest.mark.parametrize("kw", [dict(batch=16), dict(batch=16, drop_last=True),
                                dict(batch=7, shard=(1, 3))],
                         ids=["ragged", "drop_last", "shard"])
def test_loader_batches_match_jax(path, kw):
    X, Y = dataset()
    a, b = JN.NativeLoader(X, Y, seed=42, **kw), TN.NativeLoader(X, Y, seed=42,
                                                                  **kw)
    try:
        assert a.is_native == b.is_native == (path == "native")
        for _ in range(25):  # several epochs
            (xa, ya), (xb, yb) = a.next(), b.next()
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)
    finally:
        a.close()
        b.close()


def test_loader_indices_match_jax(path):
    X, Y = dataset()
    a = JN.NativeLoader(X, Y, batch=16, seed=9, index_mode=True)
    b = TN.NativeLoader(X, Y, batch=16, seed=9, index_mode=True)
    g = TN.NativeLoader(X, Y, batch=16, seed=9)
    try:
        for _ in range(15):
            ia, ib = a.next_indices(), b.next_indices()
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_array_equal(X[ib], g.next()[0])
        with pytest.raises(ValueError, match="index_mode"):
            g.next_indices()
    finally:
        for ld in (a, b, g):
            ld.close()


@pytest.mark.parametrize("index_mode", [False, True])
def test_skip_matches_drained_stream(path, index_mode):
    """``skip(n)`` lands where n drained batches do, across an epoch
    boundary (ceil(100/16) = 7 batches an epoch)."""
    X, Y = dataset()
    a = TN.NativeLoader(X, Y, batch=16, seed=42, index_mode=index_mode)
    b = TN.NativeLoader(X, Y, batch=16, seed=42, index_mode=index_mode)
    try:
        for _ in range(9):
            a.next()
        b.skip(9)
        for _ in range(3):
            (xa, ya), (xb, yb) = a.next(), b.next()
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)
    finally:
        a.close()
        b.close()


def test_loader_refusals():
    X, Y = dataset(10)
    with pytest.raises(ValueError, match="2-D"):
        TN.NativeLoader(X[:, 0], Y, batch=4)
    with pytest.raises(ValueError, match="drop_last"):
        TN.NativeLoader(X, Y, batch=11, drop_last=True)
    with pytest.raises(ValueError, match="shard"):
        TN.NativeLoader(X, Y, batch=4, shard=(3, 3))


def rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape)


@pytest.mark.parametrize("ms,os_,ns", [((2,), (3,), ()), ((2,), (3, 4), (5,)),
                                       ((), (3,), ()), ((2, 3), (4,), (5, 2)),
                                       ((), (2, 3, 2), ())])
def test_native_gmul_matches_numpy(ms, os_, ns):
    x = rand(1, *(ms + os_))
    y = rand(2, *(tuple(reversed(os_)) + ns))
    got = TN.native_gmul(len(ms), len(os_), len(ns), x, y)
    want = NumpyBackend().gmul(len(ms), len(os_), len(ns), x, y)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape", [(2, 3), (2, 3, 4), (5,), (2, 1, 3, 2)])
def test_native_transpose_matches_numpy(shape):
    x = rand(3, *shape)
    np.testing.assert_array_equal(TN.native_transpose(x),
                                  NumpyBackend().transp(x))


def test_native_backend_matches_pure_numpy():
    """``NumpyBackend(use_native=True)`` routes gmul/transp through the C++
    kernels: a training step agrees with the pure oracle to 1e-12."""
    from tensor_ops_tpu_torch.backend.rng import Rng
    from tensor_ops_tpu_torch.models import (act_logistic, gen_net,
                                             squared_error)

    pure, nat = NumpyBackend(), NumpyBackend(use_native=True)
    net = gen_net(pure, 3, 2, [(5, act_logistic())], act_logistic(),
                  Rng(pure, seed=4))
    x, y = rand(5, 3), np.array([0.3, 0.8])
    a = net.train(squared_error(2), 0.5, pure, x, y)
    b = net.train(squared_error(2), 0.5, nat, x, y)
    for p, q in zip(a.params, b.params):
        np.testing.assert_allclose(p, q, rtol=0, atol=1e-12)


class CountingLoader:
    def __init__(self):
        self.k = 0

    def next(self):
        self.k += 1
        return (np.full((2, 3), self.k, np.float32),
                np.full((2, 1), -self.k, np.float32))


def test_prefetcher_order_and_depth():
    """Depth batches are pulled at construction, one more per ``next``, and
    batches come out in the loader's order, as tensors of the asked dtype
    on the asked device (the CPU here; a side stream on a card)."""
    loader = CountingLoader()
    pf = TN.DevicePrefetcher(loader, "cpu", torch.float64, depth=3)
    assert loader.k == 3
    for want in (1, 2, 3, 4):
        x, y = pf.next()
        assert loader.k == want + 3
        assert x.dtype == y.dtype == torch.float64 and x.device.type == "cpu"
        assert torch.equal(x, torch.full((2, 3), float(want),
                                         dtype=torch.float64))
        assert torch.equal(y, torch.full((2, 1), -float(want),
                                         dtype=torch.float64))
    with pytest.raises(ValueError, match="depth"):
        TN.DevicePrefetcher(CountingLoader(), "cpu", torch.float32, depth=0)


def test_library_builds_beside_the_jax_one():
    """The port builds its own copy under build/native, never the JAX
    package's native/build file."""
    assert TN._SO != JN._SO
    assert TN._SO.endswith("build/native/libtensorops_native.so")
    assert TN._SRC == JN._SRC
