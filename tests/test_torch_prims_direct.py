"""Direct coverage of the port's Tensor primitives that only had indirect
use: ``ix_rows``, ``index`` (the reference's ``(!)``), ``map_rows``, and all
five ``gen_rand`` distribution kinds with custom ones: the port of
``tests/test_prims_direct.py``, on the port's torch backend (f64, CPU) and
its NumPy oracle.  Semantics are checked against hand-computed values and
the JAX package's backends' values of the same calls (at 1e-12, as the
JAX file's parity checks); ``gen_rand`` by moments, because the port's
generators draw other numbers than threefry.  The parity cases of
``ix_rows``, ``index`` and ``map_rows`` on random inputs extend
``tests/test_torch_backend_ir.py``."""

import numpy as np
import pytest
import torch

import tensor_ops_tpu_torch as TT
from tensor_ops_tpu.ops.shapes import ShapeError as JShapeError
from tensor_ops_tpu_torch.backend.base import (beta, custom, exponential,
                                               gamma, normal, uniform)
from tensor_ops_tpu_torch.backend.rng import Rng
from tensor_ops_tpu_torch.ops.shapes import ShapeError
from torch_threads import one_torch_thread  # noqa: F401

TB = TT.TorchBackend(torch.float64, "cpu")
TNB = TT.NumpyBackend()
BACKENDS = (TB, TNB)
ids = [b.name for b in BACKENDS]


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def with_jax(backends, call, atol=1e-12):
    """``call(be)`` on the port's backend and on the JAX package's two,
    held to each other; returns the port's value."""
    got = host(call(backends[0]))
    for jbe in backends[1:]:
        np.testing.assert_allclose(got, np.asarray(call(jbe)), atol=atol,
                                   rtol=0, err_msg=jbe.name)
    return got


# -- ix_rows (Types.hs:100-106) ------------------------------------------


@pytest.mark.parametrize("be", BACKENDS, ids=ids)
def test_ix_rows_semantics(backends, be):
    t = np.arange(24, dtype=np.float64).reshape(2, 3, 4)
    want = np.stack([np.stack([t[i, j] * (i + 10 * j) for j in range(3)])
                     for i in range(2)])
    got = with_jax((be,) + tuple(backends), lambda b: b.ix_rows(
        2, lambda idx, row: row * (idx[0] + 10 * idx[1]), b.asarray(t)))
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("be", BACKENDS, ids=ids)
def test_ix_rows_changes_slice_shape(backends, be):
    # the slice function may change the per-slice shape (indexed traversal
    # is shape-polymorphic in the result slice)
    t = np.arange(12, dtype=np.float64).reshape(3, 4)
    got = with_jax((be,) + tuple(backends), lambda b: b.ix_rows(
        1, lambda idx, row: row[:2] + idx[0], b.asarray(t)))
    np.testing.assert_allclose(got, np.stack([t[i, :2] + i for i in
                                              range(3)]), atol=1e-12)


@pytest.mark.parametrize("be", BACKENDS, ids=ids)
def test_ix_rows_empty_axis_raises(backends, be):
    for b in (be,) + tuple(backends):
        with pytest.raises(ShapeError if b is be else JShapeError):
            b.ix_rows(1, lambda idx, row: row, b.asarray(np.zeros((0, 3))))


# -- index / (!) (Types.hs:107-109) ---------------------------------------


@pytest.mark.parametrize("be", BACKENDS, ids=ids)
def test_index_semantics(backends, be):
    t = np.arange(24, dtype=np.float64).reshape(2, 3, 4)
    for idx in [(1, 2, 3), (0, 0, 0)]:
        got = with_jax((be,) + tuple(backends),
                       lambda b: b.index(b.asarray(t), idx))
        assert float(got) == t[idx]


@pytest.mark.parametrize("be", BACKENDS, ids=ids)
def test_index_scalar_rank0(backends, be):
    got = with_jax((be,) + tuple(backends),
                   lambda b: b.index(b.asarray(7.5), ()))
    assert float(got) == 7.5


# -- map_rows (Types.hs:77-81) --------------------------------------------


@pytest.mark.parametrize("be", BACKENDS, ids=ids)
def test_map_rows_semantics(backends, be):
    t = np.arange(12, dtype=np.float64).reshape(3, 4)
    got = with_jax((be,) + tuple(backends), lambda b: b.map_rows(
        1, lambda row: row.sum() * row, b.asarray(t)))
    np.testing.assert_allclose(got, np.stack([r.sum() * r for r in t]),
                               atol=1e-12)


@pytest.mark.parametrize("be", BACKENDS, ids=ids)
def test_map_rows_k0_whole_tensor(backends, be):
    t = np.arange(6, dtype=np.float64).reshape(2, 3)
    got = with_jax((be,) + tuple(backends), lambda b: b.map_rows(
        0, lambda x: x * 2.0, b.asarray(t)))
    np.testing.assert_allclose(got, t * 2, atol=1e-12)


@pytest.mark.parametrize("be", BACKENDS, ids=ids)
def test_map_rows_shape_change(backends, be):
    t = np.arange(24, dtype=np.float64).reshape(2, 3, 4)
    got = with_jax((be,) + tuple(backends), lambda b: b.map_rows(
        2, lambda row: row[:2] * 3.0, b.asarray(t)))
    np.testing.assert_allclose(got, (t * 3.0)[:, :, :2], atol=1e-12)


@pytest.mark.parametrize("be", BACKENDS, ids=ids)
def test_map_rows_empty_leading_axis(backends, be):
    # both backends keep lead + f(slice).shape for a (0, k) input
    for b in (be,) + tuple(backends):
        got = b.map_rows(1, lambda row: row[:2] * 2.0,
                         b.asarray(np.zeros((0, 3))))
        assert tuple(got.shape) == (0, 2)


# -- gen_rand: all five distribution kinds (Types.hs:93-96) ----------------

N = 40_000
DISTS = [
    (normal(1.5, 0.5), 1.5, 0.5**2),
    (uniform(-1.0, 3.0), 1.0, (3.0 - (-1.0)) ** 2 / 12),
    (exponential(2.0), 0.5, 0.25),          # rate 2 -> mean 1/2, var 1/4
    (gamma(3.0, 2.0), 6.0, 12.0),           # shape*scale, shape*scale^2
    (beta(2.0, 5.0), 2 / 7, (2 * 5) / ((7**2) * 8)),
]


def _gen(be, seed):
    return (np.random.default_rng(seed) if be is TNB
            else torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("be", BACKENDS, ids=ids)
@pytest.mark.parametrize("dist,mean,var", DISTS,
                         ids=[d[0].kind for d in DISTS])
def test_gen_rand_moments(be, dist, mean, var):
    out = host(be.gen_rand(dist, _gen(be, 7), (N,)))
    assert out.shape == (N,) and out.dtype == np.float64
    se = (var / N) ** 0.5
    assert abs(out.mean() - mean) < 6 * se
    assert abs(out.var() - var) < 0.05 * max(var, 1e-3) + 6 * se


@pytest.mark.parametrize("be", BACKENDS, ids=ids)
def test_gen_rand_support_bounds(be):
    """uniform stays in [lo, hi); exponential/gamma nonnegative; beta in
    [0, 1] — cheap sanity on the sampler wiring."""
    rng = _gen(be, 3)

    def draw(dist):
        return host(be.gen_rand(dist, rng, (1000,)))

    u = draw(uniform(-2.0, -1.0))
    assert u.min() >= -2.0 and u.max() <= -1.0
    assert draw(exponential(3.0)).min() >= 0.0
    assert draw(gamma(2.0, 1.0)).min() >= 0.0
    b = draw(beta(0.5, 0.5))
    assert b.min() >= 0.0 and b.max() <= 1.0


def test_gen_rand_deterministic_per_generator():
    a = host(TB.gen_rand(normal(0, 1), _gen(TB, 11), (64,)))
    b = host(TB.gen_rand(normal(0, 1), _gen(TB, 11), (64,)))
    np.testing.assert_array_equal(a, b)


# -- gen_rand: custom distributions (the full ContGen parameterization) ----


def _laplace_icdf(u):
    # standard Laplace (mu=0, b=1): mean 0, var 2; torch or numpy values
    m = torch if isinstance(u, torch.Tensor) else np
    return -m.sign(u - 0.5) * m.log1p(-2 * m.abs(u - 0.5))


@pytest.mark.parametrize("be", BACKENDS, ids=ids)
def test_gen_rand_custom_icdf_moments(be):
    lap = custom(icdf=_laplace_icdf, name="laplace")
    out = host(be.gen_rand(lap, _gen(be, 7), (N,)))
    assert out.shape == (N,) and out.dtype == np.float64
    se = (2.0 / N) ** 0.5
    assert abs(out.mean()) < 6 * se
    assert abs(out.var() - 2.0) < 0.1 + 6 * se


def test_gen_rand_custom_native_sampler_overrides_icdf():
    """A per-backend native sampler wins over the icdf on its backend;
    the other backend falls back to the icdf."""
    def torch_sampler(gen, shape):
        return torch.distributions.Laplace(0.0, 1.0).sample(shape).double()

    lap = custom(icdf=_laplace_icdf, samplers={"torch": torch_sampler},
                 name="laplace")
    torch.manual_seed(3)
    out_t = host(TB.gen_rand(lap, _gen(TB, 3), (N,)))
    torch.manual_seed(3)
    want_t = torch_sampler(None, (N,)).numpy()
    np.testing.assert_array_equal(out_t, want_t)  # native path taken
    out_n = host(TNB.gen_rand(lap, _gen(TNB, 3), (N,)))
    se = (2.0 / N) ** 0.5
    for out in (out_t, out_n):
        assert abs(out.mean()) < 6 * se
        assert abs(out.var() - 2.0) < 0.1 + 6 * se


@pytest.mark.parametrize("be", BACKENDS, ids=ids)
def test_gen_rand_custom_through_rng_draw(be):
    """Rng.draw accepts a custom distribution (the user-facing path
    gen_net etc. thread through)."""
    lap = custom(icdf=_laplace_icdf, name="laplace")
    out = host(Rng(be, seed=5).draw(lap, (8, 4)))
    assert out.shape == (8, 4) and np.isfinite(out).all()


def test_gen_rand_custom_requires_a_spec():
    with pytest.raises(ValueError, match="inverse CDF"):
        custom()
