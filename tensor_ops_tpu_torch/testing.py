"""Public verification utilities: the oracles and gradient checkers the
framework's own suite is built on, exposed for users adding backends,
primitives, or kernels (the port of ``tensor_ops_tpu/testing.py``).

``loop_gmul`` is the executable specification of the contraction
semantics (mirrors ``Nested.gmul'``, reference ``src/Data/Nested.hs:
451-473``); ``check_grads`` verifies any scalar-output graph's
transposition AD against central finite differences, and
``check_grads_vs_autograd`` against ``torch.autograd`` of the graph's
forward (the JAX package's ``check_grads_vs_jax``, with PyTorch's AD as
the independent oracle).
"""

from __future__ import annotations

import numpy as np

from .ops import ir
from .tensor import _host


def rand(seed: int, *shape) -> np.ndarray:
    """Seeded standard-normal test data (the convention every suite uses)."""
    return np.random.default_rng(seed).normal(size=shape)


def loop_gmul(lm: int, lo: int, ln: int, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Triple-loop oracle for gmul:
    ``out[m, n] = sum_o x[m, o1..ok] * y[ok..o1, n]``."""
    x, y = _host(x), _host(y)
    ms = x.shape[:lm]
    os_ = x.shape[lm:]
    ns = y.shape[lo:]
    out = np.zeros(ms + ns, dtype=np.float64)
    for mi in np.ndindex(*ms) if ms else [()]:
        for ni in np.ndindex(*ns) if ns else [()]:
            acc = 0.0
            for oi in np.ndindex(*os_) if os_ else [()]:
                acc += x[mi + oi] * y[tuple(reversed(oi)) + ni]
            out[mi + ni] = acc
    return out


def fd_grad(op, be, xs, slot: int, out_slot: int = 0, eps: float = 1e-6):
    """Central finite differences of scalar-output ``op`` w.r.t. input
    ``slot`` (dense: perturbs every element)."""
    xs = [_host(x).astype(np.float64) for x in xs]
    g = np.zeros_like(xs[slot])
    indices = list(np.ndindex(*xs[slot].shape)) if xs[slot].shape else [()]

    def value(args):
        out = ir.run(op, be, [be.asarray(a) for a in args])[out_slot]
        return float(_host(out))

    for idx in indices:
        xp = [x.copy() for x in xs]
        xm = [x.copy() for x in xs]
        xp[slot][idx] += eps
        xm[slot][idx] -= eps
        g[idx] = (value(xp) - value(xm)) / (2 * eps)
    return g


def check_grads(op, be, xs, atol: float = 1e-5, rtol: float = 1e-4):
    """Assert the staged-AD gradients of a scalar-output graph match
    finite differences for every input slot."""
    assert op.out_stack == ((),), "check_grads needs a scalar-output graph"
    _, grads = ir.value_and_grad(op, be, tuple(be.asarray(x) for x in xs))
    for slot in range(len(xs)):
        fd = fd_grad(op, be, xs, slot)
        got = _host(grads[slot])
        np.testing.assert_allclose(
            got, fd, atol=atol, rtol=rtol,
            err_msg=f"gradient mismatch at input slot {slot}")


def check_grads_vs_autograd(op, tb, xs, atol=None, rtol=None):
    """Assert the transposition AD of a scalar-output graph equals
    ``torch.autograd`` of the composed forward on the torch backend
    ``tb`` — an INDEPENDENT whole-graph oracle alongside finite
    differences (tolerance-bound, ~1e-6).  Autograd records the graph's
    *forward* (``ir.run``) and derives the VJP itself, so a
    subtly-wrong-but-FD-close hand transposition (the VJP semantics of
    reference ``src/TensorOps/Types.hs:122-157`` / ``TOp.hs:56-131``) is
    caught at ~1e-12 on an f64 backend instead of FD's ~1e-6.

    Default tolerance: 1e-12 in f64, 1e-6 in any other dtype."""
    import torch

    assert op.out_stack == ((),), "needs a scalar-output graph"
    if atol is None:
        atol = 1e-12 if tb.dtype == torch.float64 else 1e-6
    if rtol is None:
        rtol = atol
    xt = tuple(tb.asarray(x) for x in xs)
    _, grads = ir.value_and_grad(op, tb, xt)
    args = tuple(x.detach().clone().requires_grad_() for x in xt)
    with torch.enable_grad():
        out = ir.run(op, tb, args)[0].reshape(())
        oracle = torch.autograd.grad(out, args, allow_unused=True)
    for slot, (got, want, x) in enumerate(zip(grads, oracle, args)):
        want = torch.zeros_like(x) if want is None else want
        np.testing.assert_allclose(
            _host(got), _host(want), atol=atol, rtol=rtol,
            err_msg=(f"transposition AD disagrees with torch.autograd at "
                     f"input slot {slot}"))
