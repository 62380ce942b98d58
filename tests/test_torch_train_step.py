"""The train-step kernel's plain version against the JAX package's Pallas
kernel run in interpret mode at ``precision="highest"``, and the port's
``FusedMLP`` training against its own and the JAX package's, on the CPU.

On the CPU the ``fused_mlp_train_step`` wrapper takes its plain version
(the CUDA kernel itself is held against the same plain version on the card
by ``chip_smoke.py``).  Inputs are seeded numpy arrays cast to f32 for both
packages.  Tolerances: 1e-6 at the ``tests/test_pallas.py`` widths (as
there), in both loss modes and on a ragged batch; 1e-5 at the flagship
widths, whose 784-long f32 sums are added in another order; 1e-5 between
the two ``FusedMLP`` training routes (as ``test_pallas.py:141-160``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensor_ops_tpu as T
from tensor_ops_tpu.backend.rng import Rng as JRng
from tensor_ops_tpu.models import act_logistic as j_logistic
from tensor_ops_tpu.models import act_softmax as j_softmax
from tensor_ops_tpu.models import gen_net as j_gen_net
from tensor_ops_tpu.models.fast import FusedMLP as JFusedMLP
from tensor_ops_tpu.ops import pallas_kernels as PK
from tensor_ops_tpu_torch.models import FusedMLP
from tensor_ops_tpu_torch.ops import kernels as K

FLAGSHIP = (784, 300, 100, 10)


def f32(a):
    return np.asarray(a, dtype=np.float32)


def close(got, want, atol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol)


def inputs(seed, dims, B, kind, scale=None):
    """x uniform in [0, 1), y one-hot (or y = x for the squared error),
    weights ~ N(0, 1) times ``scale`` (default 1/sqrt(fan-in))."""
    r = np.random.default_rng(seed)
    ws = [r.normal(size=(dims[k + 1], dims[k]))
          * (scale if scale is not None else 1 / np.sqrt(dims[k]))
          for k in range(len(dims) - 1)]
    bs = [r.normal(size=(dims[k + 1],)) * (scale or 0.3)
          for k in range(len(dims) - 1)]
    x = r.uniform(0, 1, size=(B, dims[0]))
    y = (np.eye(dims[-1])[r.integers(0, dims[-1], size=B)]
         if kind == "softmax_xent" else x)
    return x, y, ws, bs


STEP_CASES = [
    # (batch, widths, acts, loss_kind, atol)
    (16, (12, 8, 6, 4), ("logistic", "logistic", "identity"),
     "softmax_xent", 1e-6),                               # test_pallas.py
    (37, (12, 8, 6, 4), ("tanh", "relu", "identity"), "softmax_xent", 1e-6),
    (37, (8, 3, 8), ("logistic", "logistic"), "squared_error", 1e-6),
    (5, (8, 3, 8), ("relu", "tanh"), "squared_error", 1e-6),
    (64, FLAGSHIP, ("logistic", "logistic", "identity"), "softmax_xent",
     1e-5),
]


@pytest.mark.parametrize("B,dims,acts,kind,atol", STEP_CASES,
                         ids=["pallas-test", "ragged-ce", "se-8-3-8",
                              "se-tiny-batch", "flagship"])
def test_train_step_ref_matches_pallas(B, dims, acts, kind, atol):
    flagship = dims == FLAGSHIP
    x, y, ws, bs = inputs(0, dims, B, kind, None if flagship else 0.3)
    want = PK.fused_mlp_train_step(
        jnp.asarray(f32(x)), jnp.asarray(f32(y)),
        [jnp.asarray(f32(w)) for w in ws], [jnp.asarray(f32(b)) for b in bs],
        0.1, acts, precision="highest", loss_kind=kind)
    got = K.fused_mlp_train_step(
        torch.tensor(f32(x)), torch.tensor(f32(y)),
        [torch.tensor(f32(w)) for w in ws], [torch.tensor(f32(b)) for b in bs],
        0.1, acts, precision="highest", loss_kind=kind)
    assert got[0].ndim == 0 and got[0].dtype == torch.float32
    close(got[0], np.asarray(want[0]), atol)
    for g, w in zip(got[1] + got[2], list(want[1]) + list(want[2])):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        close(g, np.asarray(w), atol)


def test_squared_error_rows_past_the_batch_do_not_leak():
    """A batch of 5 rows and the same rows padded with 3 zero rows whose
    targets are act(b) would be a different loss; the step must see only
    the 5 (the TPU kernel masks its padded rows, ``pallas_kernels.py:459-
    463``): loss and gradient equal those of the explicit per-row sum."""
    x, y, ws, bs = inputs(1, (8, 3, 8), 5, "squared_error", 0.3)
    acts = ("logistic", "logistic")
    t = lambda a: torch.tensor(a)  # f64: the check is the math, not f32
    loss, nws, nbs = K.fused_mlp_train_step_ref(
        t(x), t(y), [t(w) for w in ws], [t(b) for b in bs], 1.0, acts,
        loss_kind="squared_error")
    tw = [t(w).requires_grad_() for w in ws]
    tb = [t(b).requires_grad_() for b in bs]
    h = torch.sigmoid(t(x) @ tw[0].T + tb[0])
    p = torch.sigmoid(h @ tw[1].T + tb[1])
    want = ((p - t(y)) ** 2).sum(dim=1).mean()
    grads = torch.autograd.grad(want, tw + tb)
    close(loss, want.item(), 1e-12)
    for new, old, g in zip(nws + nbs, ws + bs, grads):
        close(new, old - g.numpy(), 1e-12)


def test_cross_entropy_takes_log_where_p_positive():
    """The step's loss is -sum y log(where(p > 0, p, 1)) (``pallas_kernels.
    py:455``): a class of probability 0 and target 0 adds nothing, where
    log(p + 1e-30) would add 0 too but log(p) would give nan."""
    x = torch.zeros(2, 2, dtype=torch.float64)
    w = torch.tensor([[0.0, 0.0], [0.0, 0.0], [0.0, 0.0]],
                     dtype=torch.float64)
    b = torch.tensor([800.0, 0.0, -800.0], dtype=torch.float64)
    y = torch.tensor([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]], dtype=torch.float64)
    loss, _, _ = K.fused_mlp_train_step_ref(x, y, [w], [b], 0.1,
                                            ["identity"])
    assert float(loss) == 0.0  # p = (1, 0, 0) exactly


def jax_fused(seed=0):
    jb = T.JaxBackend()
    net = j_gen_net(jb, 12, 4, [(8, j_logistic())], j_softmax(),
                    JRng(jb, seed=seed))
    fm = JFusedMLP.from_network(net, precision="highest")
    return JFusedMLP(tuple(w.astype(jnp.float32) for w in fm.weights),
                     tuple(b.astype(jnp.float32) for b in fm.biases),
                     fm.acts, fm.softmax_out, "highest")


def port_fused(jfm, **kw):
    return FusedMLP.from_numpy([np.asarray(w) for w in jfm.weights],
                               [np.asarray(b) for b in jfm.biases],
                               jfm.acts, jfm.softmax_out, device="cpu",
                               precision="highest", **kw)


def minibatch(seed=1, n=10, i=12, o=4):
    r = np.random.default_rng(seed)
    return f32(r.uniform(0, 1, size=(n, i))), \
        f32(np.eye(o)[r.integers(0, o, size=n)])


def test_train_fullfused_matches_train():
    fm = port_fused(jax_fused())
    x, y = minibatch()
    xb, yb = torch.tensor(x), torch.tensor(y)
    v1, fm1 = fm.train(0.1, xb, yb)
    v2, fm2 = fm.train_fullfused(0.1, xb, yb)
    assert isinstance(v2, float)
    assert abs(float(v1) - v2) < 1e-5
    for a, b in zip(fm1.to_params(), fm2.to_params()):
        close(a, b.numpy(), 1e-5)
    # the model trained from is left as it was
    for a, b in zip(fm.to_params(), port_fused(jax_fused()).to_params()):
        assert torch.equal(a, b)


def test_train_matches_jax_fusedmlp_train():
    jfm = jax_fused(seed=3)
    fm = port_fused(jfm)
    x, y = minibatch(seed=4)
    for _ in range(3):
        jv, jfm = jfm.train(0.2, jnp.asarray(x), jnp.asarray(y))
        tv, fm = fm.train(0.2, torch.tensor(x), torch.tensor(y))
        close(tv, np.asarray(jv), 1e-5)
        for a, b in zip(fm.to_params(), jfm.to_params()):
            close(a, np.asarray(b), 1e-5)
    assert fm.loss_kind == "ce" and not fm.weights[0].requires_grad


def test_mse_routes_agree_and_refuse_mixed_kinds():
    r = np.random.default_rng(5)
    ws, bs = [r.normal(size=(3, 8)) * 0.3, r.normal(size=(8, 3)) * 0.3], \
        [r.normal(size=3) * 0.3, r.normal(size=8) * 0.3]
    fm = FusedMLP.from_numpy([f32(w) for w in ws], [f32(b) for b in bs],
                             ("logistic", "logistic"), softmax_out=False,
                             device="cpu", loss_kind="mse")
    x = torch.tensor(f32(r.uniform(0, 1, size=(6, 8))))
    v1, fm1 = fm.train(0.5, x, x)
    v2, fm2 = fm.train_fullfused(0.5, x, x)
    assert abs(float(v1) - v2) < 1e-6
    for a, b in zip(fm1.to_params(), fm2.to_params()):
        close(a, b.numpy(), 1e-6)
    with pytest.raises(ValueError, match="softmax_out=False"):
        FusedMLP(fm.weights, fm.biases, fm.acts, True, "default",
                 "mse").train_fullfused(0.1, x, x)
    with pytest.raises(ValueError, match="softmax\\+ce"):
        FusedMLP(fm.weights, fm.biases, fm.acts, False).train_fullfused(
            0.1, x, x)


def test_train_step_validates_its_arguments():
    x, y = torch.zeros(2, 3), torch.zeros(2, 2)
    w, b = torch.zeros(2, 3), torch.zeros(2)
    with pytest.raises(ValueError, match="loss_kind"):
        K.fused_mlp_train_step(x, y, [w], [b], 0.1, ["identity"],
                               loss_kind="hinge")
    with pytest.raises(ValueError, match="activation"):
        K.fused_mlp_train_step(x, y, [w], [b], 0.1, ["gelu"])
    with pytest.raises(ValueError, match="one weight"):
        K.fused_mlp_train_step(x, y, [w], [b, b], 0.1, ["identity"])


@pytest.mark.parametrize("batch,widths,want", [
    # h_1..h_L and two dz buffers of the widest, rows padded to 4 floats,
    # and a loss per row; x is read in place
    (1000, FLAGSHIP, 1000 * (300 + 100 + 12) + 2 * 1000 * 300 + 1000),
    (100, FLAGSHIP, 100 * 412 + 2 * 100 * 300 + 100),
    (1, FLAGSHIP, 412 + 2 * 300 + 1),
    (37, (8, 3, 8), 37 * (4 + 8) + 2 * 37 * 8 + 37),
    (37, (784, 300, 784), 37 * 1084 + 2 * 37 * 784 + 37),
])
def test_train_step_scratch_floats(batch, widths, want):
    assert K.train_step_scratch_floats(batch, widths) == want


def test_flagship_scratch_at_batch_1000_is_4_mb_and_l2_resident():
    """The flagship's step scratch at B = 1000: 4.05 MB, far inside the
    H100's 50 MB L2 (the slots of the design before held 67 MB)."""
    nbytes = 4 * K.train_step_scratch_floats(1000, FLAGSHIP)
    assert nbytes == 4_052_000 and nbytes < 50e6


@pytest.mark.parametrize("n_layers,want", [
    (1, ["F0", "loss", "G0"]),
    (2, ["F0", "F1", "loss", "G1", "G0"]),
    (3, ["F0", "F1", "F2", "loss", "G2", "G1", "G0"]),
])
def test_train_stages_and_barriers(n_layers, want):
    stages = K.train_stages(n_layers)
    assert stages == want
    assert len(stages) - 1 == 2 * n_layers  # grid barriers between stages


@pytest.mark.parametrize("capacity,sms,want", [
    (264, 132, 132),   # one block per SM, though two fit
    (132, 132, 132),
    (100, 132, 100),   # never more than the card holds at once
])
def test_train_grid_is_one_block_per_sm(capacity, sms, want):
    assert K.train_grid(capacity, sms, 100, FLAGSHIP) == want


def test_train_grid_names_the_shapes_when_the_card_holds_none():
    with pytest.raises(ValueError, match="784-300-100-10 at batch 100"):
        K.train_grid(0, 132, 100, FLAGSHIP)


def test_train_step_refuses_more_layers_than_the_kernel_takes():
    n = K.MAX_LAYERS + 1
    x, y = torch.zeros(2, 4), torch.zeros(2, 4)
    ws, bs = [torch.zeros(4, 4)] * n, [torch.zeros(4)] * n
    with pytest.raises(ValueError, match=f"{n} layers exceed the kernel's "
                                         f"{K.MAX_LAYERS}"):
        K._train_step_widths(x, y, ws, bs)
    assert K._train_step_widths(x, y, ws[:2], bs[:2]) == [4, 4, 4]


@pytest.mark.parametrize("what,ys,ws,want", [
    ("targets", (3, 5), [(4, 6)], "y is \\(3, 5\\), want \\(3, 4\\)"),
    ("chain", (3, 4), [(4, 5)], "layer 0 has w \\(4, 5\\)"),
])
def test_train_step_widths_name_the_shapes(what, ys, ws, want):
    with pytest.raises(ValueError, match=want):
        K._train_step_widths(torch.zeros(3, 6), torch.zeros(*ys),
                             [torch.zeros(*s) for s in ws],
                             [torch.zeros(s[0]) for s in ws])


def test_cpu_train_step_launches_no_kernel():
    K.reset_launch_counts()
    fm = port_fused(jax_fused())
    x, y = minibatch()
    fm.train_fullfused(0.1, torch.tensor(x), torch.tensor(y))
    fm.train(0.1, torch.tensor(x), torch.tensor(y))
    assert K.launch_counts() == {"fused_linear": 0, "fused_mlp_forward": 0,
                                 "fused_mlp_train_step": 0,
                                 "fused_linear_w8": 0, "fused_linear_w8a8": 0,
                                 "fused_mlp_w8a8_forward": 0,
                                 "fused_rnn_step": 0,
                                 "fused_rnn_step.seq": 0, "ring_all_reduce": 0,
                                 "bidir_ring": 0, "ring_all_reduce.ring": 0,
                                 "bidir_ring.ring": 0}
