"""The port's value-level Tensor helper API (``tensor_ops_tpu_torch.tensor``,
``src/TensorOps/Tensor.hs`` parity) against hand computations and the JAX
package's ``tensor`` module on the same inputs at 1e-9: the port of
``tests/test_tensor_helpers.py``, on the port's torch backend (f64, CPU)
and its NumPy oracle.  ``TT.tensor`` is the package root's export."""

import numpy as np
import pytest
import torch

import tensor_ops_tpu_torch as T
from tensor_ops_tpu import tensor as JT
from tensor_ops_tpu.ops.shapes import ShapeError as JShapeError
from tensor_ops_tpu_torch.ops.shapes import ShapeError
from tensor_ops_tpu_torch.testing import rand as r
from torch_threads import one_torch_thread  # noqa: F401

TT = T.tensor
TOL = 1e-9
BACKENDS = (T.TorchBackend(torch.float64, "cpu"), T.NumpyBackend())


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def same(got, want):
    np.testing.assert_allclose(host(got), np.asarray(want), atol=TOL, rtol=0)


def test_konst_map_zip(jb):
    for be in BACKENDS:
        k = TT.konst(be, 2.5, (2, 3))
        assert np.allclose(host(k), 2.5)
        same(k, JT.konst(jb, 2.5, (2, 3)))
        m = TT.tmap(be, lambda v: v * 2, be.asarray(r(0, 3)),
                    lambda v: 2.0 + 0 * v)
        assert np.allclose(host(m), 2 * r(0, 3))
        same(m, JT.tmap(jb, lambda v: v * 2, jb.asarray(r(0, 3))))
        z = TT.tzip(be, lambda a, b: a * b, be.asarray(r(1, 3)),
                    be.asarray(r(2, 3)))
        assert np.allclose(host(z), r(1, 3) * r(2, 3))
        same(TT.tzipN(be, lambda a, b, c: a * b + c, *(be.asarray(r(i, 3))
                                                      for i in range(3))),
             JT.tzipN(jb, lambda a, b, c: a * b + c,
                      *(jb.asarray(r(i, 3)) for i in range(3))))
        same(TT.tadd(be, be.asarray(r(1, 3)), be.asarray(r(2, 3))),
             r(1, 3) + r(2, 3))


def test_contraction_helpers(jb):
    x, y = r(3, 4), r(4, 4)
    m = r(5, 3, 4)
    for be in BACKENDS:
        a = be.asarray
        assert np.isclose(float(host(TT.dot(be, a(x), a(y)))), x @ y)
        same(TT.mat_vec(be, a(m), a(x)), JT.mat_vec(jb, m, x))
        np.testing.assert_allclose(host(TT.mat_vec(be, a(m), a(x))), m @ x,
                                   atol=1e-9)
        np.testing.assert_allclose(host(TT.vec_mat(be, a(r(6, 3)), a(m))),
                                   r(6, 3) @ m, atol=1e-9)
        np.testing.assert_allclose(host(TT.outer_v(be, a(x), a(y))),
                                   np.outer(x, y), atol=1e-9)
        np.testing.assert_allclose(host(TT.outer(be, a(m), a(x))),
                                   np.multiply.outer(m, x), atol=1e-9)
        same(TT.mat_mat(be, a(m), a(r(7, 4, 2))),
             JT.mat_mat(jb, m, r(7, 4, 2)))
        same(TT.inner(be, 1, 1, a(m), a(x)), JT.inner(jb, 1, 1, m, x))


@pytest.mark.parametrize("be", BACKENDS, ids=lambda b: b.name)
def test_from_list_and_iteration(nb, be):
    t = TT.from_list(be, [1, 2, 3, 4, 5, 6], (2, 3))
    assert tuple(t.shape) == (2, 3) and float(t[1, 2]) == 6
    with pytest.raises(ShapeError):
        TT.from_list(be, [1, 2], (2, 3))
    with pytest.raises(JShapeError):
        JT.from_list(nb, [1, 2], (2, 3))
    assert TT.to_list(be, t) == [1, 2, 3, 4, 5, 6]
    assert TT.elems(be, t) == [1, 2, 3, 4, 5, 6]
    assert TT.ito_list(be, t)[3] == ((1, 0), 4.0)
    assert TT.ito_list(be, t) == JT.ito_list(nb, JT.from_list(
        nb, [1, 2, 3, 4, 5, 6], (2, 3)))
    assert len(TT.rows(be, t)) == 2
    assert TT.un_scalar(be, TT.from_list(be, [7.0], ())) == 7.0


@pytest.mark.parametrize("be", BACKENDS, ids=lambda b: b.name)
def test_generate_one_hot_argmax(nb, be):
    g = TT.generate(be, (2, 2), lambda idx: idx[0] * 10 + idx[1])
    assert float(g[1, 1]) == 11
    same(g, JT.generate(nb, (2, 2), lambda idx: idx[0] * 10 + idx[1]))
    oh = TT.one_hot(be, 1.0, 0.0, 2, 5)
    assert float(oh[2]) == 1 and float(oh.sum()) == 1
    same(oh, JT.one_hot(nb, 1.0, 0.0, 2, 5))
    v = be.asarray(np.array([1.0, 5.0, 2.0]))
    assert TT.arg_max(be, v) == 1 and TT.arg_min(be, v) == 0
    ie = TT.ix_elems(be, lambda idx, v: v + idx[0], be.asarray(np.zeros(3)))
    assert np.allclose(host(ie), [0, 1, 2])
