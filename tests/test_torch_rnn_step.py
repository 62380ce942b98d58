"""The port's Elman step kernel wrapper ``fused_rnn_step`` and ``FusedRNN``
against the JAX package's, on the CPU.

On the CPU the wrapper takes its plain PyTorch version
(``fused_rnn_step_ref``); the JAX ``fused_rnn_step`` runs its Pallas kernel
in interpret mode (``pallas_kernels.py:51-54``).  The CUDA kernel is held
against the same plain version on the card by ``chip_smoke.py``.

Inputs are numpy arrays from a seed, cast to f32 for both packages.
Tolerances: 1e-5 for the step's outputs and gradients, as
``tests/test_pallas.py:318`` holds the JAX kernel (f32 sums of up to 72
products added in another order); ``FusedRNN`` sequences at 1e-5 as
``test_pallas.py:456`` holds its two impls, and its parameters after five
SGD steps at 1e-5 + 1e-5·|ref| (each step adds its own f32 rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensor_ops_tpu.models.fast as JF
from tensor_ops_tpu.backend.rng import Rng as JRng
from tensor_ops_tpu.models import act_logistic as j_logistic
from tensor_ops_tpu.models import squared_error as j_squared_error
from tensor_ops_tpu.models.recurrent import fully_connected as j_fc
from tensor_ops_tpu.ops import pallas_kernels as PK
from tensor_ops_tpu.testing import rand as r
from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng as TRng
from tensor_ops_tpu_torch.models import FusedRNN, act_logistic
from tensor_ops_tpu_torch.models.recurrent import fully_connected
from tensor_ops_tpu_torch.ops import kernels as K
from tensor_ops_tpu_torch.utils import checkpoint as TC

ACTS = ("identity", "logistic", "relu", "tanh")
TOL = 1e-5


def f32(a):
    return np.asarray(a, dtype=np.float32)


def close(got, want, atol=TOL, rtol=0.0):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def step_inputs(seed, B, i, o):
    """x, s, wx, ws, b as f32 numpy: x normal, s a logistic state in (0, 1),
    weights at 1/sqrt(fan-in) scale."""
    rr = np.random.default_rng(seed)
    return (f32(rr.normal(size=(B, i))),
            f32(1 / (1 + np.exp(-rr.normal(size=(B, o))))),
            f32(rr.normal(size=(o, i)) / np.sqrt(i + o)),
            f32(rr.normal(size=(o, o)) / np.sqrt(i + o)),
            f32(rr.normal(size=o) * 0.3))


SHAPES = [(1, 3, 5), (1, 32, 40), (37, 3, 5), (37, 32, 40)]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("B,i,o", SHAPES)
def test_step_matches_jax_kernel(B, i, o, act):
    args = step_inputs(B * 100 + i + o, B, i, o)
    y, s_new = K.fused_rnn_step(*(torch.tensor(a) for a in args), act,
                                "highest")
    jy, js = PK.fused_rnn_step(*(jnp.asarray(a) for a in args), act,
                               "highest")
    assert y.shape == s_new.shape == (B, o) and y.dtype == torch.float32
    close(y, jy)
    close(s_new, js)
    close(K.fused_rnn_step_ref(*(torch.tensor(a) for a in args), act)[1], js)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("B,i,o", [(1, 3, 5), (37, 32, 40)])
def test_step_gradients_match_jax_custom_vjp(B, i, o, act):
    """Gradients of a scalar of (y, s') w.r.t. all five inputs: the port's
    ``autograd.Function`` backward against ``jax.grad`` through the JAX
    kernel's custom VJP."""
    args = step_inputs(7 * B + i, B, i, o)
    rr = np.random.default_rng(B + o)
    cy, cs = f32(rr.normal(size=(B, o))), f32(rr.normal(size=(B, o)))

    def j_scalar(*a):
        y, s = PK.fused_rnn_step(*a, act, "highest")
        return jnp.sum(y * cy) + jnp.sum(s * cs)

    want = jax.grad(j_scalar, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    y, s = K.fused_rnn_step(*ts, act, "highest")
    ((y * torch.tensor(cy)).sum() + (s * torch.tensor(cs)).sum()).backward()
    for t, w in zip(ts, want):
        close(t.grad, w)


def test_step_equals_the_fully_connected_cell():
    """The step is the IR ``fully_connected`` cell: y the pre-activation,
    s' = logistic(z) (``test_fused_rnn_step_matches_recurrent_network``)."""
    be = TorchBackend(torch.float64, "cpu")
    net = fully_connected(act_logistic(), be, 3, 5, TRng(be, seed=31))
    wS, wX, b = net.params
    (s0,) = net.states
    x = be.asarray(r(30, 3))
    y_ir, after = net.run(be, x)
    y, s = K.fused_rnn_step(x[None], s0[None], wX, wS, b, "logistic")
    assert y.dtype == torch.float64  # the plain version keeps f64 inputs
    close(y[0], y_ir.numpy(), 1e-12)
    close(s[0], after.states[0].numpy(), 1e-12)


def test_step_validates_its_inputs():
    x, s, wx, ws, b = (torch.tensor(a) for a in step_inputs(1, 2, 3, 4))
    with pytest.raises(ValueError, match="activation"):
        K.fused_rnn_step(x, s, wx, ws, b, "gelu")
    with pytest.raises(ValueError, match="precision"):
        K.fused_rnn_step(x, s, wx, ws, b, "relu", "fast")
    with pytest.raises(ValueError, match="disagree"):
        K._fused_rnn_step_cuda(x, s, ws, ws, b, "relu")
    with pytest.raises(ValueError, match="float32"):
        K._fused_rnn_step_cuda(x.double(), s, wx, ws, b, "relu")
    with pytest.raises(ValueError, match="one device"):
        K._fused_rnn_step_cuda(x, s, wx, ws, b.to("meta"), "relu")


def test_cpu_step_launches_no_kernel():
    K.reset_launch_counts()
    args = [torch.tensor(a) for a in step_inputs(2, 4, 3, 5)]
    K.fused_rnn_step(*args)
    FusedRNN(args[2], args[3], args[4], args[1][0], impl="pallas") \
        .seq_forward(np.zeros((3, 3), np.float32))
    K.fused_rnn_seq(args[0][None], *args[1:])
    counts = K.launch_counts()
    assert counts["fused_rnn_step"] == counts["fused_rnn_step.seq"] == 0


# -- FusedRNN ----------------------------------------------------------------


def rnn_params(seed, i, o):
    rr = np.random.default_rng(seed)
    return (f32(rr.normal(size=(o, i)) * 0.3), f32(rr.normal(size=(o, o)) * 0.3),
            f32(rr.normal(size=o) * 0.1), f32(rr.normal(size=o) * 0.5))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_fused_rnn_matches_jax(impl):
    """``seq_forward`` and five ``train`` steps against the JAX FusedRNN of
    the same impl; ``impl`` survives ``train``."""
    i, o, n = 5, 7, 11
    wX, wS, b, s0 = rnn_params(3, i, o)
    rr = np.random.default_rng(4)
    xs = f32(rr.normal(size=(n, i)))
    tg = f32(0.3 * rr.normal(size=(n, o)))
    jm = JF.FusedRNN(*(jnp.asarray(a) for a in (wX, wS, b, s0)),
                     precision="highest", impl=impl)
    tm = FusedRNN.from_numpy(wX, wS, b, s0, precision="highest", impl=impl,
                             device="cpu")
    ys, sf = tm.seq_forward(xs)
    jys, jsf = jm.seq_forward(xs)
    assert ys.shape == (n, o) and sf.shape == (o,)
    close(ys, jys)
    close(sf, jsf)
    for _ in range(5):
        v, tm = tm.train(0.01, 0.001, xs, tg)
        jv, jm = jm.train(0.01, 0.001, xs, tg)
        close(v, jv, TOL, TOL)
    assert tm.impl == impl
    for got, want in zip((tm.wX, tm.wS, tm.b, tm.s0),
                         (jm.wX, jm.wS, jm.b, jm.s0)):
        close(got, want, TOL, TOL)


def test_fused_rnn_impls_agree():
    """The plain cell and the kernel route give the same sequences and
    training steps (``test_fused_rnn_impl_parity_and_preservation``)."""
    i, o, n = 5, 7, 11
    params = rnn_params(3, i, o)
    m = FusedRNN.from_numpy(*params, device="cpu")
    assert m.impl == "xla"
    mp = FusedRNN.from_numpy(*params, impl="pallas", device="cpu")
    rr = np.random.default_rng(3)
    xs = f32(rr.normal(size=(n, i)))
    tg = f32(0.3 * rr.normal(size=(n, o)))
    close(m.seq_forward(xs)[0], mp.seq_forward(xs)[0].numpy())
    v_x, m2 = m.train(0.01, 0.001, xs, tg)
    v_p, mp2 = mp.train(0.01, 0.001, xs, tg)
    close(v_x, v_p, TOL, TOL)
    assert (m2.impl, mp2.impl) == ("xla", "pallas")
    with pytest.raises(ValueError, match="impl"):
        FusedRNN.from_numpy(*params, impl="triton", device="cpu")


def test_fused_rnn_from_recurrent_trains_like_the_ir(nb):
    """From a ``fully_connected`` RecurrentNetwork, whose weights came from
    the JAX package's: the sequence loss of the kernel route is the IR
    scan's, its parameter gradients the IR's (``test_fused_rnn_scan_bptt_
    matches_ir``), and training lowers the loss
    (``test_fused_rnn_model_trains``)."""
    jnet = j_fc(j_logistic(), nb, 2, 3, JRng(nb, seed=32))
    be = TorchBackend(torch.float64, "cpu")
    tnet = TC.recurrent_from_arrays(
        {"param_0": jnet.params[0], "param_1": jnet.params[1],
         "param_2": jnet.params[2], "state_0": jnet.states[0]}, {},
        fully_connected(act_logistic(), be, 2, 3, TRng(be, 0)), be)
    xs, tg = f32(r(33, 4, 2)), f32(r(34, 4, 3))
    m = FusedRNN.from_recurrent(tnet)
    m = FusedRNN(m.wX, m.wS, m.b, m.s0, impl="pallas")
    want = float(jnet.seq_loss(j_squared_error(3), nb, xs, tg))
    v, stepped = m.train(0.0, 0.0, xs, tg)
    assert abs(v - want) < 1e-4
    _, gS_ir, gP_ir = jnet.seq_grad(j_squared_error(3), nb, xs, tg)
    # a step at rate 1 moves each parameter by minus its gradient
    _, unit = m.train(0.0, 1.0, xs, tg)
    close(m.wX - unit.wX, gP_ir[1], 1e-4)
    close(m.wS - unit.wS, gP_ir[0], 1e-4)
    close(m.b - unit.b, gP_ir[2], 1e-4)
    for a, b in zip((stepped.wX, stepped.wS), (m.wX, m.wS)):
        assert torch.equal(a, b)
    v0, trained = m.train(0.02, 0.05, xs, tg)
    for _ in range(30):
        v1, trained = trained.train(0.02, 0.05, xs, tg)
    assert v1 < 0.7 * v0


# -- fused_rnn_seq: a whole sequence -----------------------------------------


def seq_inputs(seed, n, B, i, o, dtype=np.float32):
    """xs (n, B, i) normal and the step's s0, wx, ws, b (``step_inputs``)."""
    x, s, wx, ws, b = step_inputs(seed, B, i, o)
    xs = np.random.default_rng(seed + 1).normal(size=(n, B, i))
    return tuple(np.asarray(a, dtype) for a in (xs, s, wx, ws, b))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_seq_matches_jax_fused_rnn(impl):
    """``fused_rnn_seq_ref`` and ``FusedRNN(impl="pallas")`` on the CPU
    against the JAX ``FusedRNN.seq_forward``: in f64 at 1e-9 against the
    JAX cell loop (``impl="xla"``), in f32 at the file's 1e-5 against the
    JAX kernel in interpret mode (``impl="pallas"``, an f32 kernel)."""
    dt, tol = (np.float64, 1e-9) if impl == "xla" else (np.float32, TOL)
    xs, s, wx, ws, b = seq_inputs(41, 9, 1, 5, 7, dt)
    xs = xs.astype(np.float32).astype(dt)  # the JAX model reads xs in f32
    jm = JF.FusedRNN(*(jnp.asarray(a) for a in (wx, ws, b, s[0])),
                     precision="highest", impl=impl)
    jys, jsf = jm.seq_forward(xs[:, 0])
    ys, sf = K.fused_rnn_seq(*(torch.tensor(a) for a in (xs, s, wx, ws, b)))
    assert ys.shape == (9, 1, 7) and ys.dtype == torch.tensor(xs).dtype
    close(ys[:, 0], jys, tol)
    close(sf[0], jsf, tol)
    tm = FusedRNN.from_numpy(wx, ws, b, s[0], impl="pallas", device="cpu")
    tys, tsf = tm.seq_forward(xs[:, 0])
    close(tys, jys, tol)
    close(tsf, jsf, tol)


@pytest.mark.parametrize("act", ACTS)
def test_seq_equals_the_step_loop(act):
    """On the CPU the sequence is the loop of ``fused_rnn_step`` bit for bit,
    at several rows, and its BPTT gradients are autograd's through that
    loop (f64, 1e-12: the same products summed in another order)."""
    xs, s, wx, ws, b = (torch.tensor(a) for a in
                        seq_inputs(43, 6, 3, 4, 5, np.float64))
    ys, sf = K.fused_rnn_seq(xs, s, wx, ws, b, act)
    st, out = s, []
    for t in range(xs.shape[0]):
        y, st = K.fused_rnn_step(xs[t], st, wx, ws, b, act)
        out.append(y)
    assert torch.equal(ys, torch.stack(out)) and torch.equal(sf, st)
    rr = np.random.default_rng(44)
    cy = torch.tensor(rr.normal(size=tuple(ys.shape)))
    cs = torch.tensor(rr.normal(size=tuple(sf.shape)))
    grads = []
    for seq in (True, False):
        ts = [a.clone().requires_grad_() for a in (xs, s, wx, ws, b)]
        if seq:
            y, f = K.fused_rnn_seq(*ts, act)
        else:
            f, out = ts[1], []
            for t in range(xs.shape[0]):
                yt, f = K.fused_rnn_step(ts[0][t], f, *ts[2:], act)
                out.append(yt)
            y = torch.stack(out)
        ((y * cy).sum() + (f * cs).sum()).backward()
        grads.append([a.grad for a in ts])
    for got, want in zip(*grads):
        close(got, want.numpy(), 1e-12)


def test_seq_gradients_match_jax_scan_of_the_kernel():
    """The sequence's BPTT against ``jax.grad`` through ``lax.scan`` of the
    JAX kernel's custom VJP (interpret mode), all five inputs, at 1e-5."""
    xs, s, wx, ws, b = seq_inputs(45, 7, 2, 3, 6)
    rr = np.random.default_rng(46)
    cy = f32(rr.normal(size=(7, 2, 6)))

    def j_loss(xs, s0, wx, ws, b):
        def step(st, xt):
            y, st = PK.fused_rnn_step(xt, st, wx, ws, b, "tanh", "highest")
            return st, y
        sf, ys = jax.lax.scan(step, s0, xs)
        return jnp.sum(ys * cy) + jnp.sum(sf)

    want = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (xs, s, wx, ws, b)))
    ts = [torch.tensor(a, requires_grad=True) for a in (xs, s, wx, ws, b)]
    ys, sf = K.fused_rnn_seq(*ts, "tanh", "highest")
    ((ys * torch.tensor(cy)).sum() + sf.sum()).backward()
    for t, w in zip(ts, want):
        close(t.grad, w)


def test_seq_of_no_steps_keeps_the_state():
    xs, s, wx, ws, b = (torch.tensor(a) for a in seq_inputs(47, 0, 2, 3, 4))
    ys, sf = K.fused_rnn_seq(xs, s, wx, ws, b)
    assert ys.shape == (0, 2, 4) and torch.equal(sf, s)


@pytest.mark.parametrize("B,i,o,plan", [
    (1, 32, 512, "resident"),   # FusedRNN at the recurrent slice's widths
    (4, 32, 512, "resident"),
    (1, 3, 45, "resident"),
    (3, 1024, 64, "resident"),
    (5, 32, 512, "steps"),      # more rows than the kernel takes
    (1, 32, 513, "steps"),      # more columns than the cluster's warps
    (1, 32, 1024, "steps"),     # 64 columns x 1056 floats > 227 KB a block
    (256, 32, 512, "steps"),
])
def test_rnn_seq_plan_per_shape(B, i, o, plan):
    assert K.rnn_seq_plan(B, i, o) == plan
    fits = K.rnn_seq_smem_bytes(B, i, o) <= K.MAX_SMEM_BYTES
    assert plan == "steps" or fits


def test_rnn_seq_plan_and_wrapper_refuse_what_they_cannot_run():
    with pytest.raises(ValueError, match="no sequence kernel"):
        K.rnn_seq_plan(0, 3, 4)
    with pytest.raises(ValueError, match="no sequence kernel"):
        K.rnn_seq_plan(1, 3, 0)
    xs, s, wx, ws, b = (torch.tensor(a) for a in seq_inputs(48, 3, 1, 3, 4))
    # checked before any launch (these tensors lie on the CPU)
    with pytest.raises(ValueError, match=r"xs \(n, B, i\)"):
        K._fused_rnn_seq_cuda(xs[0], s, wx, ws, b, "tanh")
    with pytest.raises(ValueError, match="disagree"):
        K._fused_rnn_seq_cuda(xs, s, ws, ws, b, "tanh")
    with pytest.raises(ValueError, match="float32"):
        K._fused_rnn_seq_cuda(xs.double(), s, wx, ws, b, "tanh")
    with pytest.raises(ValueError, match="one device"):
        K._fused_rnn_seq_cuda(xs, s, wx, ws, b.to("meta"), "tanh")
    with pytest.raises(ValueError, match="activation"):
        K.fused_rnn_seq(xs, s, wx, ws, b, "gelu")
