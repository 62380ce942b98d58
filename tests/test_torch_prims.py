"""Per-primitive forward semantics of the port, on its torch backend (f64,
CPU) and its NumPy oracle, against hand computations, the triple-loop
gmul oracle (``testing.loop_gmul``) and the JAX package's values of the
same graphs at 1e-9: the port of ``tests/test_prims.py`` (SURVEY.md §7.3
hard part 1: exact ``(ms++os) x (Reverse os++ns) -> (ms++ns)``
semantics)."""

import numpy as np
import pytest
import torch

import tensor_ops_tpu_torch as TT
from tensor_ops_tpu.ops import ir as j_ir
from tensor_ops_tpu.ops import prim as JP
from tensor_ops_tpu.testing import loop_gmul as j_loop_gmul
from tensor_ops_tpu_torch.ops import ir as t_ir
from tensor_ops_tpu_torch.ops import prim as TP
from tensor_ops_tpu_torch.testing import loop_gmul
from tensor_ops_tpu_torch.testing import rand as r
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-9
PORT = (TT.TorchBackend(torch.float64, "cpu"), TT.NumpyBackend())


def runs(build, xs, jb):
    """``build(P)`` run on each port backend, each output list held to the
    JAX package's at 1e-9; returns the torch backend's outputs as arrays."""
    want = j_ir.run(build(JP), jb, tuple(jb.asarray(x) for x in xs))
    first = None
    for be in PORT:
        got = t_ir.run(build(TP), be, tuple(be.asarray(x) for x in xs))
        assert len(got) == len(want)
        got = [np.asarray(g) for g in got]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), atol=TOL, rtol=0,
                                       err_msg=be.name)
        first = got if first is None else first
    return first


GMUL_CASES = [
    # (ms, os, ns)
    ((), (), ()),        # scalar * scalar
    ((), (3,), ()),      # dot
    ((2,), (3,), ()),    # matVec
    ((), (2,), (3,)),    # vecMat
    ((2,), (3,), (4,)),  # matMat
    ((2,), (), (3,)),    # outer
    ((2, 3), (), ()),    # right-scalar scale
    ((2,), (3, 4), (5,)),        # rank-3 contraction over 2 axes
    ((2, 3), (4,), (5, 2)),      # rank-3 x rank-3
    ((), (2, 3, 2), ()),         # full contraction rank 3
]


@pytest.mark.parametrize("ms,os,ns", GMUL_CASES)
def test_gmul_matches_loop_oracle(jb, ms, os, ns):
    x = r(1, *(ms + os))
    y = r(2, *(tuple(reversed(os)) + ns))
    want = loop_gmul(len(ms), len(os), len(ns), x, y)
    np.testing.assert_array_equal(
        want, j_loop_gmul(len(ms), len(os), len(ns), x, y))
    got = runs(lambda P: P.gmul(ms, os, ns), (x, y), jb)[0]
    np.testing.assert_allclose(got, want, atol=1e-10)


def test_matvec_family(jb):
    w, x = r(3, 3, 2), r(4, 2)
    a, b = r(5, 2, 3), r(6, 3, 4)
    v = r(7, 3)
    np.testing.assert_allclose(runs(lambda P: P.mat_vec(3, 2), (w, x),
                                    jb)[0], w @ x, atol=1e-10)
    np.testing.assert_allclose(runs(lambda P: P.mat_mat(2, 3, 4), (a, b),
                                    jb)[0], a @ b, atol=1e-10)
    np.testing.assert_allclose(runs(lambda P: P.vec_mat(3, 4), (v, b),
                                    jb)[0], v @ b, atol=1e-10)
    np.testing.assert_allclose(runs(lambda P: P.dot(3), (v, v), jb)[0],
                               v @ v, atol=1e-10)
    np.testing.assert_allclose(runs(lambda P: P.outer((3,), (2,)), (v, x),
                                    jb)[0], np.outer(v, x), atol=1e-10)


def test_transp_full_reversal(jb):
    x = r(8, 2, 3, 4)
    got = runs(lambda P: P.transp_op((2, 3, 4)), (x,), jb)[0]
    np.testing.assert_allclose(got, np.transpose(x, (2, 1, 0)))


def test_sum_rows(jb):
    x = r(9, 4, 3)
    np.testing.assert_allclose(runs(lambda P: P.sum_rows((4, 3)), (x,),
                                    jb)[0], x.sum(axis=0))


def test_sum_op_scale_negate(jb):
    x, y, z = r(10, 3), r(11, 3), r(12, 3)
    np.testing.assert_allclose(runs(lambda P: P.add((3,)), (x, y), jb)[0],
                               x + y)
    np.testing.assert_allclose(runs(lambda P: P.add3((3,)), (x, y, z),
                                    jb)[0], x + y + z)
    np.testing.assert_allclose(runs(lambda P: P.scale((3,), 2.5), (x,),
                                    jb)[0], 2.5 * x)
    np.testing.assert_allclose(runs(lambda P: P.negate((3,)), (x,), jb)[0],
                               -x)


def test_konst_replicate_duplicate(jb):
    x = r(13, 3)
    outs = runs(lambda P: P.konst(2.0, (2, 2), n=3), (), jb)
    assert len(outs) == 3
    np.testing.assert_allclose(outs[1], np.full((2, 2), 2.0))
    outs = runs(lambda P: P.replicate_op((3,), 4), (x,), jb)
    assert len(outs) == 4 and np.allclose(outs[3], x)
    assert len(runs(lambda P: P.duplicate((3,)), (x,), jb)) == 2


def test_diag_getdiag(jb):
    v = r(14, 4)
    np.testing.assert_allclose(runs(lambda P: P.diag_op(4, 2), (v,), jb)[0],
                               np.diag(v))
    d3 = runs(lambda P: P.diag_op(4, 3), (v,), jb)[0]
    assert d3.shape == (4, 4, 4)
    assert np.isclose(d3[2, 2, 2], v[2]) and d3[0, 1, 2] == 0
    back = runs(lambda P: P.get_diag_op(4, 3), (d3,), jb)[0]
    np.testing.assert_allclose(back, v)


def test_map_zip(jb):
    x, y = r(15, 3), r(16, 3)
    np.testing.assert_allclose(runs(lambda P: P.zip_op(
        (3,), lambda a, b: a * b), (x, y), jb)[0], x * y)
    np.testing.assert_allclose(runs(lambda P: P.zip3_op(
        (3,), lambda a, b, c: a * b + c), (x, y, x), jb)[0], x * y + x)
