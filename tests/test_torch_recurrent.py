"""The port's recurrent family against the JAX package's, in float64 on the
CPU: ``ScanOp``/``MappedOp``/``Remat`` (``ops/loops.py``),
``RecurrentNetwork`` and its constructors (``models/recurrent.py``) and the
recurrent checkpoints.

Each network is built by the JAX package; its states and params go to the
port's net of the same construction through ``recurrent_from_arrays``
(jax threefry and ``torch.Generator`` draw different numbers from equal
seeds).  Inputs are numpy arrays from a seed.  Tolerance: 1e-9, the JAX
package's own bound for its numpy oracle against its JAX backend
(``tests/test_recurrent.py``); the JAX tests hold the same graphs against
an explicit unroll and finite differences.  Where the port must reproduce
its own numbers (checkpointed scans, the offloaded tape), equality is
exact."""

import numpy as np
import pytest
import torch

import tensor_ops_tpu.models as JM
import tensor_ops_tpu.models.recurrent as JR
from tensor_ops_tpu import prim as JP
from tensor_ops_tpu.backend.rng import Rng as JRng
from tensor_ops_tpu.ops import ir as j_ir
from tensor_ops_tpu.ops.loops import MappedOp as JMappedOp
from tensor_ops_tpu.testing import rand as r
from tensor_ops_tpu.utils import checkpoint as JC
import tensor_ops_tpu_torch.models as TM
import tensor_ops_tpu_torch.models.recurrent as TR
from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch import prim as TP
from tensor_ops_tpu_torch.backend.rng import Rng as TRng
from tensor_ops_tpu_torch.ops import ir as t_ir
from tensor_ops_tpu_torch.ops.loops import MappedOp, ScanOp, _sqrt_divisor
from tensor_ops_tpu_torch.ops.shapes import ShapeError
from tensor_ops_tpu_torch.utils import checkpoint as TC

TOL = 1e-9


@pytest.fixture(scope="module")
def tb():
    return TorchBackend(torch.float64, "cpu")


def close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


# -- one construction for both packages ----------------------------------------


def build(kind, M, R, be, rng):
    """The same recurrent network in either package (``M`` its models
    module, ``R`` its recurrent module)."""
    lg = M.act_logistic
    if kind == "fc":
        return R.fully_connected(lg(), be, 3, 2, rng)
    if kind == "fc-tanh":
        return R.fully_connected(M.act_tanh(), be, 2, 2, rng)
    if kind == "two-states":
        return R.fully_connected(lg(), be, 2, 3, rng).then(
            R.fully_connected(lg(), be, 3, 2, rng))
    if kind == "gen-net":
        return R.gen_net(be, 4, 2, [(5, lg(), lg()), (3, lg(), None)], lg(),
                         None, rng)
    if kind == "gen-net-relu":
        return R.gen_net(be, 3, 2, [(6, M.act_tanh(), M.act_relu())], lg(),
                         lg(), rng)
    if kind == "assoc-left":
        a, b, c = (R.fully_connected(lg(), be, i, o, rng)
                   for i, o in ((2, 3), (3, 4), (4, 2)))
        return a.then(b).then(c)
    if kind == "assoc-right":
        a, b, c = (R.fully_connected(lg(), be, i, o, rng)
                   for i, o in ((2, 3), (3, 4), (4, 2)))
        return a.then(b.then(c))
    raise ValueError(kind)


def pair(kind, nb, tb, seed=11):
    """(JAX net on the numpy oracle, the port's net with its weights)."""
    jnet = build(kind, JM, JR, nb, JRng(nb, seed=seed))
    template = build(kind, TM, TR, tb, TRng(tb, seed=0))
    arrays, meta = JC._recurrent_payload(jnet, None)
    tnet = TC.recurrent_from_arrays(
        {k: np.asarray(v) for k, v in arrays.items()}, meta, template, tb)
    return jnet, tnet


def on_jax(jnet, jb):
    return JR.RecurrentNetwork(jnet.op, tuple(jb.asarray(s) for s in jnet.states),
                               tuple(jb.asarray(p) for p in jnet.params),
                               jnet.arch)


KINDS = ["fc", "fc-tanh", "two-states", "gen-net", "gen-net-relu",
         "assoc-left"]


# -- forward, gradients and training against the JAX package --------------------


@pytest.mark.parametrize("kind", KINDS)
def test_seq_loss_run_seq_and_grads_match_jax(nb, tb, kind):
    """``seq_loss``, ``run_seq`` (ys and final states) and ``seq_grad``
    (inputs, initial states, params) — the ports of the JAX package's
    scan-forward, scan-gradient and two-state scan tests."""
    jnet, tnet = pair(kind, nb, tb)
    n, i, o = 5, jnet.in_shape[0], jnet.out_shape[0]
    xs, tg = r(1, n, i), r(2, n, o)
    loss_j, loss_t = JM.squared_error(o), TM.squared_error(o)
    close(tnet.seq_loss(loss_t, tb, tb.asarray(xs), tb.asarray(tg)),
          jnet.seq_loss(loss_j, nb, xs, tg))
    ys_t, after_t = tnet.run_seq(tb, tb.asarray(xs))
    ys_j, after_j = jnet.run_seq(nb, xs)
    close(ys_t, ys_j)
    for a, b in zip(after_t.states, after_j.states):
        close(a, b)
    got = tnet.seq_grad(loss_t, tb, tb.asarray(xs), tb.asarray(tg))
    want = jnet.seq_grad(loss_j, nb, xs, tg)
    close(got[0], want[0])
    for g, w in zip(got[1] + got[2], want[1] + want[2]):
        close(g, w)


def test_scan_matches_jax_backend(nb, jb, tb):
    """The JAX backend (``lax.scan``) and the port agree on loss and
    gradients (``test_scan_forward_numpy_vs_jax``,
    ``test_scan_grad_parity_numpy_vs_jax``)."""
    jnet, tnet = pair("fc", nb, tb)
    jx = on_jax(jnet, jb)
    xs, tg = r(3, 4, 3), r(4, 4, 2)
    loss_j, loss_t = JM.squared_error(2), TM.squared_error(2)
    close(tnet.seq_loss(loss_t, tb, tb.asarray(xs), tb.asarray(tg)),
          jx.seq_loss(loss_j, jb, jb.asarray(xs), jb.asarray(tg)))
    got = tnet.seq_grad(loss_t, tb, tb.asarray(xs), tb.asarray(tg))
    want = jx.seq_grad(loss_j, jb, jb.asarray(xs), jb.asarray(tg))
    for g, w in zip((got[0],) + got[1] + got[2],
                    (want[0],) + want[1] + want[2]):
        close(g, w)


def test_scan_equals_explicit_step_loop(nb, tb):
    """The scan threads the state as a step-by-step ``run`` fold does
    (``test_scan_forward_matches_explicit_loop``)."""
    _, tnet = pair("two-states", nb, tb)
    xs, tg = r(73, 5, 2), r(74, 5, 2)
    loss = TM.squared_error(2)
    total, m = 0.0, tnet
    for t in range(5):
        y, m = m.run(tb, tb.asarray(xs[t]))
        total += float(t_ir.run(loss, tb, (y, tb.asarray(tg[t])))[0])
    close(tnet.seq_loss(loss, tb, tb.asarray(xs), tb.asarray(tg)), total,
          1e-12)


@pytest.mark.parametrize("kind", ["fc", "gen-net"])
def test_train_steps_match_jax(nb, tb, kind):
    """Five dual-rate SGD steps (``trainNetwork'``) on a sine echo task
    (``test_training_reduces_sequence_loss``, ``test_gen_net_recurrent``):
    the same states and params, and the loss falls."""
    jnet, tnet = pair(kind, nb, tb, seed=3)
    i, o = jnet.in_shape[0], jnet.out_shape[0]
    t = np.linspace(0, 2 * np.pi, 13)
    xs = np.tile(np.sin(t[:-1])[:, None], (1, i))
    tg = np.clip(np.tile(np.sin(t[1:])[:, None], (1, o)), 0.05, 0.95)
    lj, lt = JM.squared_error(o), TM.squared_error(o)
    l0 = float(tnet.seq_loss(lt, tb, tb.asarray(xs), tb.asarray(tg)))
    for _ in range(5):
        jnet = jnet.train(lj, 0.02, 0.05, nb, xs, tg)
        tnet = tnet.train(lt, 0.02, 0.05, tb, tb.asarray(xs), tb.asarray(tg))
    for a, b in zip(tnet.states + tnet.params, jnet.states + jnet.params):
        close(a, b)
    assert tnet.arch == jnet.arch
    assert float(tnet.seq_loss(lt, tb, tb.asarray(xs), tb.asarray(tg))) < l0


@pytest.mark.parametrize("kind", ["fc", "two-states"])
def test_train_batch_is_mean_of_singles(nb, jb, tb, kind):
    """Batched-sequence SGD (``torch.func.vmap`` of the scan gradient)
    equals averaging per-sequence gradients, and equals the JAX package's
    ``train_batch`` (``test_train_batch_matches_mean_of_singles``)."""
    jnet, tnet = pair(kind, nb, tb, seed=51)
    i, o = jnet.in_shape[0], jnet.out_shape[0]
    xb, tgb = r(60, 3, 4, i), r(61, 3, 4, o)
    lt = TM.squared_error(o)
    acc = [torch.zeros_like(p) for p in tnet.states + tnet.params]
    for b in range(3):
        _, gS, gP = tnet.seq_grad(lt, tb, tb.asarray(xb[b]),
                                  tb.asarray(tgb[b]))
        acc = [a + g for a, g in zip(acc, gS + gP)]
    rates = [0.1] * len(tnet.states) + [0.2] * len(tnet.params)
    got = tnet.train_batch(lt, 0.1, 0.2, tb, tb.asarray(xb), tb.asarray(tgb))
    for p, a, g, rate in zip(tnet.states + tnet.params, acc,
                             got.states + got.params, rates):
        close(g, p - rate * a / 3, 1e-10)
    want = on_jax(jnet, jb).train_batch(JM.squared_error(o), 0.1, 0.2, jb,
                                        jb.asarray(xb), jb.asarray(tgb))
    for a, b in zip(got.states + got.params, want.states + want.params):
        close(a, b)


@pytest.mark.parametrize("kind", ["fc", "gen-net", "two-states"])
def test_seq_batch_loss_matches_jax(nb, jb, tb, kind):
    """``seq_batch_loss`` (the value ``fit_sequences`` validates with): the
    JAX package's vmapped mean over N sequences, in f64."""
    from tensor_ops_tpu.models.training import seq_batch_loss as j_sbl
    from tensor_ops_tpu_torch.models.training import seq_batch_loss

    jnet, tnet = pair(kind, nb, tb, seed=41)
    i, o = jnet.in_shape[0], jnet.out_shape[0]
    XS, TS = r(80, 5, 6, i), r(81, 5, 6, o)
    want = j_sbl(on_jax(jnet, jb), JM.squared_error(o), jb, XS, TS)
    got = seq_batch_loss(tnet, TM.squared_error(o), tb, XS, TS)
    assert isinstance(got, float)
    close(got, want)


def test_seq_batch_loss_is_the_mean_of_seq_losses(tb):
    """The port of ``tests/test_production_knobs.py:319-330``: the batched
    loss equals the mean of per-sequence ``seq_loss`` on phase-shifted sine
    waves, for two sequence lengths from one cache."""
    from tensor_ops_tpu_torch.models.training import seq_batch_loss

    t = np.linspace(0, 1, 10)
    waves = np.sin(2 * np.pi * t[None, :]
                   + np.random.default_rng(14).uniform(0, np.pi, size=(16, 1)))
    net = TR.gen_net(tb, 1, 1, [(6, TM.act_logistic(), TM.act_logistic())],
                     TM.act_logistic(), None, TRng(tb, seed=15))
    loss = TM.squared_error(1)
    for n in (9, 4):
        XS, TS = waves[:, :n, None], waves[:, 1:n + 1, None]
        got = seq_batch_loss(net, loss, tb, XS, TS)
        want = np.mean([float(net.seq_loss(loss, tb, tb.asarray(xs),
                                           tb.asarray(ts)))
                        for xs, ts in zip(XS, TS)])
        close(got, want, 1e-12)


# -- structure ------------------------------------------------------------------


def test_fully_connected_output_is_preactivation(nb, tb):
    """fc outputs z = Ws.s + Wx.x + b and state act(z)
    (``Recurrent.hs:97-125``)."""
    _, tnet = pair("fc", nb, tb, seed=21)
    wS, wX, b = tnet.params
    (s0,) = tnet.states
    x = tb.asarray(r(10, 3))
    y, after = tnet.run(tb, x)
    z = wS @ s0 + wX @ x + b
    close(y, z, 1e-12)
    close(after.states[0], 1 / (1 + torch.exp(-z)), 1e-12)


def test_then_threads_both_states(nb, tb):
    """``a.then(b)``: outputs of b after a, state order ``ss2 ++ ss1``
    (``Recurrent.hs:218-222``), as in the JAX package."""
    ja = JR.fully_connected(JM.act_logistic(), nb, 2, 3, JRng(nb, seed=31))
    jbn = JR.fully_connected(JM.act_logistic(), nb, 3, 2, JRng(nb, seed=32))
    jcomp = ja.then(jbn)
    _, tcomp = pair("two-states", nb, tb)
    tcomp = TC.recurrent_from_arrays(
        {k: np.asarray(v) for k, v in
         JC._recurrent_payload(jcomp, None)[0].items()}, {}, tcomp, tb)
    x = r(11, 2)
    yj, jc2 = jcomp.run(nb, x)
    yt, tc2 = tcomp.run(tb, tb.asarray(x))
    close(yt, yj)
    _, a2 = ja.run(nb, x)
    yb, b2 = jbn.run(nb, ja.run(nb, x)[0])
    close(yt, yb)
    close(tc2.states[0], b2.states[0])
    close(tc2.states[1], a2.states[0])


def test_compose_is_associative(nb, tb):
    """(a . b) . c == a . (b . c) in outputs and state threading
    (``test_recurrent_compose_associative``), and equal to the JAX
    package's."""
    jl, left = pair("assoc-left", nb, tb, seed=81)
    _, right = pair("assoc-right", nb, tb, seed=81)
    xs = r(84, 4, 2)
    yl, yr, yj = left, right, jl
    for t in range(4):
        out_l, yl = yl.run(tb, tb.asarray(xs[t]))
        out_r, yr = yr.run(tb, tb.asarray(xs[t]))
        out_j, yj = yj.run(nb, xs[t])
        close(out_l, out_r, 1e-12)
        close(out_l, out_j)
    sl = sorted(float(s.sum()) for s in yl.states)
    sr = sorted(float(s.sum()) for s in yr.states)
    close(sl, sr, 1e-12)


def test_stateless_embedding_matches_ff(nb, tb):
    """``stateless(ff_layer)`` runs the feed-forward layer and has no
    state (``Recurrent.hs:132-137``)."""
    jrec = JR.ff_layer(nb, 3, 2, JRng(nb, seed=9))
    trec = TR.ff_layer(tb, 3, 2, TRng(tb, seed=0))
    trec = TR.RecurrentNetwork(trec.op, (),
                               tuple(tb.asarray(p) for p in jrec.params))
    x = r(9, 3)
    y_t, after = trec.run(tb, tb.asarray(x))
    close(y_t, jrec.run(nb, x)[0])
    assert after.states == ()
    ff = TM.Network(trec.op, trec.params)
    close(TR.stateless(ff).run(tb, tb.asarray(x))[0], ff.run(tb, tb.asarray(x)))


def test_gen_net_arch_and_post_op(nb, tb):
    """gen_net records the architecture the serve app rebuilds from; a
    graph-altering post_op/nmap drops it, as in the JAX package."""
    jnet, tnet = pair("gen-net-relu", nb, tb)
    assert tnet.arch == jnet.arch == {
        "in": 3, "out": 2, "sizes": [6], "acts": ["tanh", "logistic"],
        "state_acts": ["relu", "logistic"]}
    doubled = tnet.nmap(lambda v: 2 * v)
    assert doubled.arch is None
    x = r(5, 3)
    close(doubled.run(tb, tb.asarray(x))[0],
          2 * jnet.run(nb, x)[0])


# -- MappedOp, Remat ------------------------------------------------------------


def test_mapped_op_and_its_gradient(nb, tb):
    """``MappedOp`` maps an op over a leading axis (``torch.func.vmap``);
    its gradient through a sum equals the JAX package's
    (``test_mapped_op``)."""
    xs, ys = r(14, 4, 3), r(15, 4, 3)
    m = MappedOp(TP.dot(3), 4)
    close(t_ir.run(m, tb, (tb.asarray(xs), tb.asarray(ys)))[0],
          (xs * ys).sum(axis=1), 1e-12)
    g_t = t_ir.value_and_grad(m >> TP.sum_rows((4,)), tb,
                              (tb.asarray(xs), tb.asarray(ys)))
    g_j = j_ir.value_and_grad(JMappedOp(JP.dot(3), 4) >> JP.sum_rows((4,)),
                              nb, (xs, ys))
    close(g_t[0], g_j[0])
    for a, b in zip(g_t[1], g_j[1]):
        close(a, b)
    close(g_t[1][0], ys, 1e-12)


def test_remat_matches_plain_op(nb, tb):
    """``prim.remat`` keeps only inputs and recomputes: same value and
    gradients as the op it wraps, bit for bit."""
    _, tnet = pair("fc", nb, tb)
    args = (tb.asarray(r(1, 3)),) + tnet.states + tnet.params
    tail = TP.sum_op(2, (2,)) >> TP.sum_rows((2,))
    v1, g1 = t_ir.value_and_grad(TP.remat(tnet.op) >> tail, tb, args)
    v2, g2 = t_ir.value_and_grad(tnet.op >> tail, tb, args)
    assert torch.equal(v1, v2)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


# -- checkpointed scans and the offloaded tape ------------------------------------


def _scan_grads(be, net, xs, tg, remat_every, offload_tape=False):
    o = net.out_shape[0]
    loss = (TM if be.name == "torch" else JM).squared_error(o)
    g = net._seq_graph(loss, xs.shape[0], remat_every=remat_every,
                       offload_tape=offload_tape)
    ir = t_ir if be.name == "torch" else j_ir
    return ir.value_and_grad(g, be, (be.asarray(xs),) + tuple(net.states)
                             + tuple(net.params) + (be.asarray(tg),))


@pytest.mark.parametrize("remat", [2, 4, 6, "sqrt", 12])
def test_remat_scan_grads_equal_plain(nb, jb, tb, remat):
    """Checkpointed-scan gradients are bit-identical to the plain scan's
    in the port (same ops, same order, recomputed), and equal the JAX
    package's checkpointed scan (``test_remat_scan_grads_equal_plain``)."""
    jnet, tnet = pair("fc", nb, tb)
    n = 12
    xs, tg = r(5, n, 3), r(6, n, 2)
    v_p, plain = _scan_grads(tb, tnet, xs, tg, None)
    v_c, ck = _scan_grads(tb, tnet, xs, tg, remat)
    assert torch.equal(v_p, v_c)
    for a, b in zip(plain, ck):
        assert torch.equal(a, b)
    _, jck = _scan_grads(jb, on_jax(jnet, jb), xs, tg, remat)
    for a, b in zip(ck, jck):
        close(a, b)


@pytest.mark.parametrize("remat", [None, 2, "sqrt"])
def test_offload_tape_is_a_no_op_on_the_cpu(nb, tb, remat):
    """``offload_tape`` streams the tape through pinned host memory only
    for CUDA tensors: on the CPU the value and gradients are bit-identical
    to the on-device tape (``test_scan_offload.py:60-88``)."""
    _, tnet = pair("gen-net", nb, tb, seed=0)
    xs, tg = r(1, 8, 4), r(2, 8, 2)
    v_on, g_on = _scan_grads(tb, tnet, xs, tg, remat)
    v_off, g_off = _scan_grads(tb, tnet, xs, tg, remat, offload_tape=True)
    assert torch.equal(v_on, v_off)
    for a, b in zip(g_on, g_off):
        assert torch.equal(a, b)


def test_remat_scan_forward_identical(nb, tb):
    _, tnet = pair("fc", nb, tb)
    xs, tg = r(7, 8, 3), r(8, 8, 2)
    loss = TM.squared_error(2)
    a = tnet.seq_loss(loss, tb, tb.asarray(xs), tb.asarray(tg))
    g = tnet._seq_graph(loss, 8, remat_every=4)
    b = t_ir.run(g, tb, (tb.asarray(xs),) + tnet.states + tnet.params
                 + (tb.asarray(tg),))[0]
    assert torch.equal(a, b)


def test_remat_tape_is_smaller_and_divisor_checked(nb, tb):
    """The taped carries shrink from n to n/k block entries; a
    non-divisor is refused; ``"sqrt"`` picks the divisor nearest sqrt(n)
    (``test_remat_tape_is_smaller``, ``test_remat_requires_divisor``,
    ``test_sqrt_divisor_schedule``)."""
    _, tnet = pair("fc", nb, tb)
    n, k = 12, 4
    args = (tb.asarray(r(9, n, 3)),) + tnet.states + tnet.params
    _, tape_p = ScanOp(tnet.op, n, 1).apply_tape(tb, args)
    _, tape_c = ScanOp(tnet.op, n, 1, remat_every=k).apply_tape(tb, args)
    assert tape_p[1][0].shape[0] == n
    assert tape_c[1][0].shape[0] == n // k
    with pytest.raises(ShapeError, match="divisor"):
        ScanOp(tnet.op, 10, 1, remat_every=3)
    assert _sqrt_divisor(4096) == 64
    assert _sqrt_divisor(12) in (3, 4)
    assert _sqrt_divisor(7) in (1, 7)
    assert 100 % _sqrt_divisor(100) == 0
    assert ScanOp(tnet.op, 12, 1, remat_every="sqrt").remat_every in (3, 4)


# -- checkpoints ------------------------------------------------------------------


@pytest.mark.parametrize("written_by", ["jax", "port"])
def test_recurrent_checkpoints_cross_both_ways(tmp_path, nb, tb, written_by):
    """A recurrent checkpoint (states, params, arch) written by either
    package loads in the other, bit for bit; a wrong template is
    refused."""
    jnet, tnet = pair("gen-net", nb, tb)
    path = str(tmp_path / "rnn.npz")
    if written_by == "jax":
        JC.save_recurrent(path, jnet)
        got = TC.load_recurrent(path, tnet, tb)
        want = jnet
    else:
        TC.save_recurrent_async(path, tnet).result()
        got = JC.load_recurrent(path, jnet, nb)
        want = tnet
    for a, b in zip(got.states + got.params, want.states + want.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert got.arch == want.arch
    assert TC.load_meta(path)["kind"] == "recurrent"
    _, other = pair("fc", nb, tb)
    with pytest.raises(ValueError, match="params"):
        TC.load_recurrent(path, other, tb)
