"""The port's NumPy oracle (``tensor_ops_tpu_torch.NumpyBackend``) against
the JAX package's, primitive by primitive, in f64: exact where both run
the same NumPy code, 1e-12 where a pointwise function runs in torch (the
port) against jax.numpy (the JAX package).  Its ``Rng`` draws exactly the
JAX package's numbers for one seed."""

import numpy as np
import pytest

import tensor_ops_tpu as T
from tensor_ops_tpu.backend.rng import Rng as JRng
from tensor_ops_tpu.models import neuralnet as JNN
from tensor_ops_tpu.ops import vfunc as JV
from tensor_ops_tpu_torch import NumpyBackend
from tensor_ops_tpu_torch.backend import base as TBase
from tensor_ops_tpu_torch.backend.rng import Rng as TRng
from tensor_ops_tpu_torch.models import neuralnet as TNN
from tensor_ops_tpu_torch.ops import vfunc as TV
from torch_threads import one_torch_thread  # noqa: F401

JNB, TNB = T.NumpyBackend(), NumpyBackend()
TOL_POINTWISE = 1e-12


def rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape)


def same(got, want, atol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float64
    if atol:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(got, want)


def test_construction():
    same(TNB.asarray([[1, 2], [3, 4]]), JNB.asarray([[1, 2], [3, 4]]))
    same(TNB.zeros((2, 3)), JNB.zeros((2, 3)))
    same(TNB.ones((4,)), JNB.ones((4,)))
    same(TNB.konst(2.5, (3, 2)), JNB.konst(2.5, (3, 2)))
    assert TNB.cache_key() == JNB.cache_key() == ("numpy", "float64", False)


# (port VFunc, JAX VFunc, tolerance, arity): closed-form and derived
# gradients, NumPy-only and torch pointwise functions
LIFTS = {
    "square+1": (lambda: TV.vfunc1(lambda x: x * x + 1),
                 lambda: JV.vfunc1(lambda x: x * x + 1), 0.0, 1),
    "logistic": (lambda: TV.vfunc1(TNN.logistic, TNN.logistic_prime),
                 lambda: JV.vfunc1(JNN.logistic, JNN.logistic_prime),
                 TOL_POINTWISE, 1),
    "logistic derived": (lambda: TV.vfunc1(TNN.logistic),
                         lambda: JV.vfunc1(JNN.logistic), TOL_POINTWISE, 1),
    "x*y+x": (lambda: TV.vfunc2(lambda x, y: x * y + x),
              lambda: JV.vfunc2(lambda x, y: x * y + x), 0.0, 2),
}


@pytest.mark.parametrize("name", list(LIFTS))
def test_lift_and_lift_vjp(name):
    t_vf, j_vf, tol, n = LIFTS[name]
    xs = [rand(10 + k, 3, 4) for k in range(n)]
    ct = rand(20, 3, 4)
    same(TNB.lift(t_vf(), xs), JNB.lift(j_vf(), xs), tol)
    for g, w in zip(TNB.lift_vjp(t_vf(), xs, ct), JNB.lift_vjp(j_vf(), xs, ct)):
        same(g, w, tol)


@pytest.mark.parametrize("ms,os_,ns", [((2,), (3,), ()), ((2,), (3, 4), (5,)),
                                       ((), (3,), ()), ((2, 3), (4,), (5, 2)),
                                       ((2,), (), (3,)), ((), (), ())])
def test_gmul(ms, os_, ns):
    x = rand(1, *(ms + os_))
    y = rand(2, *(tuple(reversed(os_)) + ns))
    same(TNB.gmul(len(ms), len(os_), len(ns), x, y),
         JNB.gmul(len(ms), len(os_), len(ns), x, y))


def test_transp_sums_and_diagonals():
    for shape in [(2, 3), (2, 3, 4), (5,)]:
        x = rand(3, *shape)
        same(TNB.transp(x), JNB.transp(x))
        same(TNB.sum_rows(x), JNB.sum_rows(x))
    v = rand(4, 4)
    for k in (1, 2, 3):
        same(TNB.diag(k, v), JNB.diag(k, v))
        same(TNB.get_diag(k, JNB.diag(k, v)), JNB.get_diag(k, JNB.diag(k, v)))
    ts = [rand(5 + k, 2, 3) for k in range(3)]
    same(TNB.sum_list(ts, (2, 3)), JNB.sum_list(ts, (2, 3)))
    same(TNB.sum_list([], (2, 3)), JNB.sum_list([], (2, 3)))
    same(TNB.scale(0.3, ts[0]), JNB.scale(0.3, ts[0]))
    same(TNB.index(ts[1], (1, 2)), JNB.index(ts[1], (1, 2)))
    assert TNB.shape_of(ts[2]) == JNB.shape_of(ts[2]) == (2, 3)
    same(TNB.broadcast_to(rand(6, 3), (2, 3)), JNB.broadcast_to(rand(6, 3),
                                                                (2, 3)))


@pytest.mark.parametrize("k", [0, 1, 2])
def test_map_rows(k):
    t = rand(7, 2, 3, 4)
    f = lambda r: np.cumsum(r, axis=-1) * 2.0  # noqa: E731
    same(TNB.map_rows(k, f, t), JNB.map_rows(k, f, t))
    empty = np.zeros((0, 3, 4))
    if k:
        same(TNB.map_rows(k, f, empty), JNB.map_rows(k, f, empty))


def test_generate_and_ix_rows():
    f = lambda idx: float(sum((i + 1) * 10 ** j for j, i in enumerate(idx)))  # noqa: E731
    same(TNB.generate((2, 3), f), JNB.generate((2, 3), f))
    same(TNB.generate((), lambda idx: 4.0), JNB.generate((), lambda idx: 4.0))
    t = rand(8, 2, 3, 2)
    g = lambda idx, row: row * (idx[0] + 1) - idx[-1]  # noqa: E731
    for k in (1, 2):
        same(TNB.ix_rows(k, g, t), JNB.ix_rows(k, g, t))
    with pytest.raises(Exception, match="empty leading axis"):
        TNB.ix_rows(1, g, np.zeros((0, 2)))


DISTS = [("normal", (0.5, 2.0)), ("uniform", (-1.0, 3.0)),
         ("exponential", (2.0,)), ("gamma", (2.0, 0.5)), ("beta", (2.0, 3.0))]


@pytest.mark.parametrize("kind,args", DISTS, ids=[d for d, _ in DISTS])
def test_rng_draws_match_jax_numpy_rng(kind, args):
    """``Rng(NumpyBackend(), seed)`` draws bit-identical numbers to the JAX
    package's ``Rng(NumpyBackend(), seed)``, draw after draw."""
    t, j = TRng(TNB, seed=11), JRng(JNB, seed=11)
    td, jd = getattr(TBase, kind)(*args), getattr(T, kind)(*args)
    for shape in [(3, 4), (5,), ()]:
        same(t.draw(td, shape), j.draw(jd, shape))
    np.testing.assert_array_equal(t.shuffle(17), j.shuffle(17))


def test_custom_distribution_by_icdf():
    t, j = TRng(TNB, seed=2), JRng(JNB, seed=2)
    icdf = lambda u: -np.log1p(-u)  # noqa: E731 — exponential(1), numpy ops
    same(t.draw(TBase.custom(icdf=icdf), (4, 3)),
         j.draw(T.custom(icdf=icdf), (4, 3)))


def test_gen_net_draws_the_jax_network():
    """The same seed builds the same network in both packages on the
    oracle: what the dots app relies on."""
    from tensor_ops_tpu.models import act_logistic as j_logistic
    from tensor_ops_tpu.models import gen_net as j_gen_net
    from tensor_ops_tpu_torch.models import act_logistic as t_logistic
    from tensor_ops_tpu_torch.models import gen_net as t_gen_net

    tn = t_gen_net(TNB, 2, 1, [(12, t_logistic()), (8, t_logistic())],
                   t_logistic(), TRng(TNB, seed=7))
    jn = j_gen_net(JNB, 2, 1, [(12, j_logistic()), (8, j_logistic())],
                   j_logistic(), JRng(JNB, seed=7))
    for a, b in zip(tn.params, jn.params):
        same(a, b)
    x = rand(9, 2)
    same(tn.run(TNB, x), jn.run(JNB, x), TOL_POINTWISE)


def test_use_native_matches_pure():
    nat = NumpyBackend(use_native=True)
    assert nat.cache_key() == ("numpy", "float64", True)
    x, y = rand(1, 2, 3, 4), rand(2, 4, 3, 5)
    np.testing.assert_allclose(nat.gmul(1, 2, 1, x, y),
                               TNB.gmul(1, 2, 1, x, y), rtol=0, atol=1e-12)
    same(nat.transp(x), TNB.transp(x))
