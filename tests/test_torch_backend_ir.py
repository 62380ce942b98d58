"""The port's backend and IR against the JAX package, in float64.

Inputs come from numpy with a seed and go to both packages; parameters are
made once (by the JAX package) and copied across, because jax threefry and
``torch.Generator`` draw different numbers from equal seeds.  Tolerance:
1e-9, the JAX package's own bound for backend and IR parity in f64
(``tests/test_backends.py``)."""

import numpy as np
import pytest
import torch

import tensor_ops_tpu as T
import tensor_ops_tpu_torch as TT
from tensor_ops_tpu.backend.rng import Rng as JRng
from tensor_ops_tpu.models import act_logistic as j_logistic
from tensor_ops_tpu.models import act_softmax as j_softmax
from tensor_ops_tpu.models import cross_entropy as j_xent
from tensor_ops_tpu.models import gen_net as j_gen_net
from tensor_ops_tpu.ops import ir as j_ir
from tensor_ops_tpu.ops import prim as JP
from tensor_ops_tpu.testing import loop_gmul
from tensor_ops_tpu.testing import rand as r
from tensor_ops_tpu_torch.backend.rng import Rng as TRng
from tensor_ops_tpu_torch.models import Network
from tensor_ops_tpu_torch.models import act_logistic as t_logistic
from tensor_ops_tpu_torch.models import act_relu as t_relu
from tensor_ops_tpu_torch.models import act_softmax as t_softmax
from tensor_ops_tpu_torch.models import cross_entropy as t_xent
from tensor_ops_tpu_torch.models import gen_net as t_gen_net
from tensor_ops_tpu_torch.ops import ir as t_ir
from tensor_ops_tpu_torch.ops import prim as TP
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-9


@pytest.fixture(scope="module")
def tb():
    return TT.TorchBackend(torch.float64, "cpu")


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=0, atol=tol)


def both(tb, jb, fn):
    """Run ``fn(be, asarray)`` on both backends; return (torch, jax)."""
    return fn(tb, tb.asarray), fn(jb, jb.asarray)


# -- the 13 Tensor primitives -----------------------------------------------

GMUL_CASES = [
    # (lm, lo, ln, x shape, y shape): y's leading axes are x's trailing
    # contracted axes in REVERSED order
    (1, 1, 0, (3, 4), (4,)),
    (1, 1, 1, (3, 4), (4, 5)),
    (0, 1, 0, (4,), (4,)),
    (1, 2, 1, (2, 3, 4), (4, 3, 5)),
    (2, 2, 1, (2, 3, 4, 5), (5, 4, 2)),
    (0, 3, 1, (2, 3, 4), (4, 3, 2, 3)),
    (1, 0, 1, (3,), (4,)),
    (0, 0, 0, (), ()),
]


@pytest.mark.parametrize("lm,lo,ln,xs,ys", GMUL_CASES)
def test_gmul(tb, jb, lm, lo, ln, xs, ys):
    x, y = r(1, *xs), r(2, *ys)
    got, want = both(tb, jb, lambda be, a: be.gmul(lm, lo, ln, a(x), a(y)))
    close(got, want)
    close(got, loop_gmul(lm, lo, ln, x, y))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_diag_and_get_diag(tb, jb, k):
    v = r(3, 4)
    got, want = both(tb, jb, lambda be, a: be.diag(k, a(v)))
    close(got, want)
    if k >= 2:
        t = r(4, *(4,) * k)
        got, want = both(tb, jb, lambda be, a: be.get_diag(k, a(t)))
        close(got, want)


def test_lift_and_lift_vjp(tb, jb):
    x, y, ct = r(5, 3, 4), r(6, 3, 4), r(7, 3, 4)
    f = lambda u, v: u * v + u * u  # noqa: E731
    df = lambda u, v: (v + 2 * u, u)  # noqa: E731
    closed = TT.vfunc2(f, df)
    jclosed = T.vfunc2(f, df)
    derived, jderived = TT.vfunc2(f), T.vfunc2(f)
    for tvf, jvf in ((closed, jclosed), (derived, jderived)):
        close(tb.lift(tvf, (tb.asarray(x), tb.asarray(y))),
              jb.lift(jvf, (jb.asarray(x), jb.asarray(y))))
        got = tb.lift_vjp(tvf, (tb.asarray(x), tb.asarray(y)), tb.asarray(ct))
        want = jb.lift_vjp(jvf, (jb.asarray(x), jb.asarray(y)),
                           jb.asarray(ct))
        for g, w in zip(got, want):
            close(g, w)
    # the autodiff-derived partials (torch.func.grad + vmap)
    for g, w in zip(derived.derived_grads()(tb.asarray(x), tb.asarray(y)),
                    df(x, y)):
        close(g, w)


def test_sum_list_scale_sum_rows_transp(tb, jb):
    a, b, c = r(8, 3, 4), r(9, 3, 4), r(10, 2, 3, 4)
    got, want = both(tb, jb, lambda be, t: be.sum_list([t(a), t(b)], (3, 4)))
    close(got, want)
    got, want = both(tb, jb, lambda be, t: be.sum_list([], (3, 4)))
    close(got, want)
    got, want = both(tb, jb, lambda be, t: be.scale(-2.5, t(a)))
    close(got, want)
    got, want = both(tb, jb, lambda be, t: be.sum_rows(t(c)))
    close(got, want)
    got, want = both(tb, jb, lambda be, t: be.transp(t(c)))
    assert tuple(got.shape) == (4, 3, 2)
    close(got, want)
    got, want = both(tb, jb, lambda be, t: be.broadcast_to(t(b[0]), (5, 4)))
    close(got, want)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_map_rows(tb, jb, k):
    t = r(11, 2, 3, 4)
    got, want = both(tb, jb, lambda be, a: be.map_rows(
        k, lambda row: row * row.sum(), a(t)))
    close(got, want)
    # tests/test_prims_direct.py's parity case, on the port's NumPy oracle
    # too
    t = np.random.default_rng(2).normal(size=(5, 3))
    f = lambda row: row - row.mean()  # noqa: E731
    want = jb.map_rows(1, f, jb.asarray(t))
    for be in (tb, TT.NumpyBackend()):
        close(be.map_rows(1, f, be.asarray(t)), want, 1e-12)


def test_map_rows_empty_leading_axis(tb):
    out = tb.map_rows(1, lambda row: row[:2] * 2, tb.zeros((0, 4)))
    assert tuple(out.shape) == (0, 2)


def test_generate_ix_rows_index(tb, jb):
    f = lambda idx: idx[0] * 10.0 + idx[1] * 0.5  # noqa: E731
    got, want = both(tb, jb, lambda be, a: be.generate((3, 4), f))
    close(got, want)
    t = r(12, 3, 4)
    g = lambda idx, row: row * (idx[0] + 1)  # noqa: E731
    got, want = both(tb, jb, lambda be, a: be.ix_rows(1, g, a(t)))
    close(got, want)
    got, want = both(tb, jb, lambda be, a: be.index(a(t), (2, 1)))
    close(got, want)
    # tests/test_prims_direct.py's parity cases, on the port's NumPy
    # oracle too
    t = np.random.default_rng(0).normal(size=(4, 2, 3))
    f = lambda idx, row: row * row + idx[0] - idx[1]  # noqa: E731
    t5 = np.random.default_rng(1).normal(size=(3, 5))
    for be in (tb, TT.NumpyBackend()):
        close(be.ix_rows(2, f, be.asarray(t)),
              jb.ix_rows(2, f, jb.asarray(t)), 1e-12)
        for idx in [(0, 0), (2, 4), (1, 3)]:
            close(be.index(be.asarray(t5), idx),
                  jb.index(jb.asarray(t5), idx), 1e-12)


DISTS = [
    (TT.normal(1.0, 2.0), 1.0, 4.0),
    (TT.uniform(-1.0, 3.0), 1.0, 16.0 / 12),
    (TT.exponential(2.0), 0.5, 0.25),
    (TT.gamma(3.0, 0.5), 1.5, 0.75),
    (TT.beta(2.0, 3.0), 0.4, 0.04),
]


@pytest.mark.parametrize("dist,mean,var", DISTS,
                         ids=[d.kind for d, _, _ in DISTS])
def test_gen_rand_distributions(tb, jb, dist, mean, var):
    """Same distribution, different numbers: both backends' sample moments
    agree with the analytic ones (n = 200k: 5 sigma of the estimate)."""
    n = 200_000
    jdist = T.backend.base.Distribution(dist.kind, dist.a, dist.b)
    s_t = TRng(tb, seed=3).draw(dist, (n,))
    s_j = JRng(jb, seed=3).draw(jdist, (n,))
    assert s_t.dtype == torch.float64 and tuple(s_t.shape) == (n,)
    for s in (np.asarray(s_t), np.asarray(s_j)):
        assert abs(s.mean() - mean) < 5 * np.sqrt(var / n)
        assert abs(s.var() - var) < 0.05 * var


def test_gen_rand_custom_and_determinism(tb):
    lap = TT.custom(icdf=lambda u: -torch.sign(u - 0.5)
                    * torch.log1p(-2 * torch.abs(u - 0.5)), name="laplace")
    a = TRng(tb, seed=7).draw(lap, (1000,))
    b = TRng(tb, seed=7).draw(lap, (1000,))
    assert torch.equal(a, b)
    native = TT.custom(samplers={"torch": lambda g, shape: torch.zeros(shape)})
    assert float(TRng(tb, seed=0).draw(native, (3,)).abs().sum()) == 0.0
    perm = TRng(tb, seed=1).shuffle(10)
    assert sorted(perm.tolist()) == list(range(10))


def test_default_dtype_untouched(tb):
    tb.asarray(np.zeros(3))
    assert torch.get_default_dtype() == torch.float32


def test_remat_names_roadmap_item(tb, jb):
    """``remat`` (once a ROADMAP item, now ported with ``ops/loops.py``)
    gives the wrapped op's forward and gradients, as the JAX remat does."""
    def graph(P):
        return P.remat(P.mat_vec(3, 4) >> P.map_op((3,), lambda v: v * v)) \
            >> P.sum_rows((3,))

    w, v = r(3, 3, 4), r(4, 4)
    got = t_ir.value_and_grad(graph(TP), tb, (tb.asarray(w), tb.asarray(v)))
    want = j_ir.value_and_grad(graph(JP), jb, (jb.asarray(w), jb.asarray(v)))
    close(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        close(a, b)


# -- graphs through the IR ----------------------------------------------------


def _nets(tb, jb, hidden=(8, 5), i=6, o=3, seed=0):
    """The same ffLayer chain in both packages: the JAX package makes the
    parameters, the port gets them as numpy arrays."""
    jnet = j_gen_net(jb, i, o, [(h, j_logistic()) for h in hidden],
                     j_softmax(), JRng(jb, seed=seed))
    tnet = t_gen_net(tb, i, o, [(h, t_logistic()) for h in hidden],
                     t_softmax(), TRng(tb, seed=seed))
    params = tuple(tb.asarray(np.asarray(p)) for p in jnet.params)
    return Network(tnet.op, params, tnet.act_names), jnet


def test_gen_net_structure_matches(tb, jb):
    tnet, jnet = _nets(tb, jb)
    assert tnet.op.in_stack == jnet.op.in_stack
    assert tnet.op.out_stack == jnet.op.out_stack
    assert tnet.act_names == jnet.act_names == ("logistic", "logistic",
                                                 "softmax")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gen_net_forward_through_ir(tb, jb, seed):
    tnet, jnet = _nets(tb, jb, seed=seed)
    x = r(20 + seed, 6)
    got = tnet.run(tb, tb.asarray(x))
    want = jnet.run(jb, jb.asarray(x))
    close(got, want)
    close(got.sum(), 1.0)


def test_value_and_grad_graph(tb, jb):
    """``op *>> crossEntropy`` on stack x : params >: y, value and every
    input cotangent, through each package's own transposition AD."""
    tnet, jnet = _nets(tb, jb)
    x, y = r(30, 6), np.eye(3)[1]
    tloss = tnet.op.lead(t_xent(3))
    jloss = jnet.op.lead(j_xent(3))
    tv, tg = t_ir.value_and_grad(
        tloss, tb, (tb.asarray(x),) + tnet.params + (tb.asarray(y),))
    jv, jg = j_ir.value_and_grad(
        jloss, jb, (jb.asarray(x),) + jnet.params + (jb.asarray(y),))
    close(tv, jv)
    assert len(tg) == len(jg) == len(tloss.in_stack)
    for g, w in zip(tg, jg):
        close(g, w)


def test_value_and_grad_autodiff_lift_and_structure(tb, jb):
    """A graph with an autodiff-derived lift, fanout, shuffle and konst."""
    def graph(P, act):
        sh = (4,)
        body = (P.map_op(sh, act) .fanout(P.scale(sh, 0.5))
                >> P.add(sh) >> P.duplicate(sh) >> P.dot(4))
        return P.swap(sh, sh) >> P.take([sh], [sh]) >> body

    tg_op = graph(TP, lambda u: u * u * u + u)
    jg_op = graph(JP, lambda u: u * u * u + u)
    x, y = r(31, 4), r(32, 4)
    tv, tg = t_ir.value_and_grad(tg_op, tb, (tb.asarray(x), tb.asarray(y)))
    jv, jg = j_ir.value_and_grad(jg_op, jb, (jb.asarray(x), jb.asarray(y)))
    close(tv, jv)
    for g, w in zip(tg, jg):
        close(g, w)


def test_relu_net_vjp(tb, jb):
    """ir.vjp of a relu hidden layer against the JAX package."""
    from tensor_ops_tpu.models import act_relu as j_relu

    jnet = j_gen_net(jb, 5, 2, [(7, j_relu())], j_softmax(), JRng(jb, 4))
    tnet = t_gen_net(tb, 5, 2, [(7, t_relu())], t_softmax(), TRng(tb, 4))
    params = tuple(tb.asarray(np.asarray(p)) for p in jnet.params)
    x, ct = r(33, 5), r(34, 2)
    got = t_ir.vjp(tnet.op, tb, (tb.asarray(x),) + params, (tb.asarray(ct),))
    want = j_ir.vjp(jnet.op, jb, (jb.asarray(x),) + jnet.params,
                    (jb.asarray(ct),))
    for g, w in zip(got, want):
        close(g, w)
