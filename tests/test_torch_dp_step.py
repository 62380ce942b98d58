"""The port's data-parallel whole step (``dp_megakernel_train_step`` over a
``RankGroup``) against the JAX package's on the 8-device CPU mesh, against
the port's single ``fused_mlp_train_step`` on the whole batch, and the rank
group's placement rules.

On CPU ranks each rank's step is the plain train step and the ring is its
plain version.  Tolerances: 2e-6 against the JAX dp step and the single
step in f32 (the JAX test's, ``tests/test_collective_kernels.py:247-278``:
averaging the updated parameters is the mean-gradient step up to f32
rounding); 1e-12 in f64 at the flagship's full width."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tensor_ops_tpu.parallel import collective_kernels as JC
from tensor_ops_tpu_torch.ops import kernels as K
from tensor_ops_tpu_torch.parallel import (RankGroup, dp_megakernel_train_step,
                                           ring_all_reduce)
from tensor_ops_tpu_torch.parallel import collective_kernels as C

N_DEV = 8
DIMS, ACTS, LR = (16, 32, 10), ("logistic", "identity"), 0.05
FLAGSHIP = (784, 300, 100, 10)
FLAGSHIP_ACTS = ("logistic", "logistic", "identity")

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < N_DEV, reason="needs the 8-device CPU mesh")


def jax_test_case():
    """The JAX test's inputs (dims 16-32-10, B = 32, seed 3), f32."""
    r = np.random.default_rng(3)
    ws = [(r.normal(size=(DIMS[k + 1], DIMS[k])) * 0.3).astype(np.float32)
          for k in range(2)]
    bs = [(r.normal(size=(DIMS[k + 1],)) * 0.1).astype(np.float32)
          for k in range(2)]
    B = N_DEV * 4
    xb = r.uniform(0, 1, size=(B, DIMS[0])).astype(np.float32)
    yb = np.eye(DIMS[-1])[r.integers(0, DIMS[-1], size=B)].astype(np.float32)
    return xb, yb, ws, bs


@pytest.fixture(scope="module")
def jax_dp():
    """The JAX dp step's (loss, ws, bs) per ``bidirectional``, computed on
    first use (interpret mode)."""
    cache = {}

    def get(bidirectional):
        if bidirectional not in cache:
            xb, yb, ws, bs = jax_test_case()
            mesh = Mesh(np.array(jax.devices()[:N_DEV]), ("data",))
            step = JC.dp_megakernel_train_step(mesh, list(ACTS), lr=LR,
                                               bidirectional=bidirectional)
            loss, nws, nbs = step(jnp.asarray(xb), jnp.asarray(yb),
                                  tuple(map(jnp.asarray, ws)),
                                  tuple(map(jnp.asarray, bs)))
            cache[bidirectional] = (float(loss), [np.asarray(w) for w in nws],
                                    [np.asarray(b) for b in nbs])
        return cache[bidirectional]

    return get


def port_dp(n, inputs, bidirectional, dtype=torch.float32, dims_acts=ACTS,
            lr=LR):
    xb, yb, ws, bs = (torch.as_tensor(np.asarray(a), dtype=dtype)
                      if not isinstance(a, list) else
                      [torch.as_tensor(np.asarray(t), dtype=dtype) for t in a]
                      for a in inputs)
    step = dp_megakernel_train_step(RankGroup(devices=["cpu"] * n),
                                    dims_acts, lr=lr,
                                    bidirectional=bidirectional)
    return step, step(xb, yb, ws, bs), (xb, yb, ws, bs)


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=atol,
                               atol=atol)


@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["bidir", "one-way"])
def test_dp_step_matches_jax_dp_step(jax_dp, bidirectional):
    j_loss, j_ws, j_bs = jax_dp(bidirectional)
    _, (loss, ws, bs), _ = port_dp(N_DEV, jax_test_case(), bidirectional)
    assert loss.ndim == 0 and loss.dtype == torch.float32
    close(float(loss), j_loss, 2e-6)
    for got, want in zip(ws + bs, j_ws + j_bs):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        close(got.numpy(), want, 2e-6)


@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["bidir", "one-way"])
def test_dp_step_matches_single_step_on_the_whole_batch(bidirectional):
    step, (loss, ws, bs), (xb, yb, w0, b0) = port_dp(
        N_DEV, jax_test_case(), bidirectional)
    loss_1, ws_1, bs_1 = K.fused_mlp_train_step(xb, yb, w0, b0, LR, ACTS)
    close(float(loss), float(loss_1), 2e-6)
    for got, want in zip(ws + bs, ws_1 + bs_1):
        close(got.numpy(), want.numpy(), 2e-6)
    # every rank holds its own copy of the parameters, all bit-identical
    assert len(step.replicas) == N_DEV
    for r_ws, r_bs in step.replicas:
        assert all(torch.equal(a, b) for a, b in zip(r_ws + r_bs, ws + bs))


@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["bidir", "one-way"])
def test_flagship_dp_step_equals_single_step_in_f64(bidirectional):
    """The flagship at full width, R = 4 ranks of 25 rows, one step in f64:
    the dp step is the single step on the 100-row batch within 1e-12."""
    r = np.random.default_rng(11)
    ws = [r.normal(size=(FLAGSHIP[k + 1], FLAGSHIP[k])) / np.sqrt(FLAGSHIP[k])
          for k in range(3)]
    bs = [r.normal(size=FLAGSHIP[k + 1]) * 0.3 for k in range(3)]
    xb = r.uniform(0, 1, size=(100, FLAGSHIP[0]))
    yb = np.eye(10)[r.integers(0, 10, size=100)]
    _, (loss, nws, nbs), (x, y, w0, b0) = port_dp(
        4, (xb, yb, ws, bs), bidirectional, torch.float64, FLAGSHIP_ACTS,
        0.3)
    loss_1, ws_1, bs_1 = K.fused_mlp_train_step(x, y, w0, b0, 0.3,
                                                FLAGSHIP_ACTS)
    assert loss.dtype == torch.float64
    assert abs(float(loss) - float(loss_1)) <= 1e-12
    for got, want in zip(nws + nbs, ws_1 + bs_1):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["bidir", "one-way"])
def test_replicas_are_the_ring_sum_times_inverse_n_bit_for_bit(bidirectional,
                                                               dtype):
    """The 1/n the collective applies to each finished sum gives the bits of
    the ring protocol's sum followed by a separate ``* (1 / n)``: every
    rank's replica, unchanged bit for bit."""
    step, _, (x, y, w0, b0) = port_dp(4, jax_test_case(), bidirectional,
                                      dtype)
    ring = (C.bidir_ring_ref if bidirectional else
            lambda xs, _: C.ring_all_reduce_ref(xs))
    parts = [K.fused_mlp_train_step(x[8 * r:8 * (r + 1)], y[8 * r:8 * (r + 1)],
                                    w0, b0, LR, ACTS) for r in range(4)]
    want = [[t * 0.25 for t in ring([p[k][i] for p in parts], "ar")]
            for k in (1, 2) for i in range(2)]
    for r, (r_ws, r_bs) in enumerate(step.replicas):
        got = r_ws + r_bs
        assert all(g.dtype == dtype and torch.equal(g, wnt[r])
                   for g, wnt in zip(got, want))


def test_loss_is_the_rank_order_mean():
    xb, yb, ws, bs = jax_test_case()
    _, (loss, _, _), (x, y, w0, b0) = port_dp(4, (xb, yb, ws, bs), True)
    parts = [K.fused_mlp_train_step(x[8 * r:8 * (r + 1)], y[8 * r:8 * (r + 1)],
                                    w0, b0, LR, ACTS)[0] for r in range(4)]
    assert torch.equal(loss, (((parts[0] + parts[1]) + parts[2]) + parts[3])
                       * 0.25)


def test_dp_step_refuses_a_batch_that_does_not_split():
    xb, yb, ws, bs = jax_test_case()
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        port_dp(3, (xb, yb, ws, bs), True)


def test_rank_group_runs_on_the_cpu_only_when_asked(monkeypatch):
    g = RankGroup(devices=["cpu"] * 3)
    assert g.size == 3
    assert g.devices == (torch.device("cpu"),) * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"devices=\['cpu'\] \* n"):
        RankGroup(4)
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        RankGroup(devices=["cpu", "cuda:0"])


@pytest.mark.parametrize("cards,want", [
    (1, ["cuda:0"] * 4),
    (4, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    (2, ["cuda:0", "cuda:1", "cuda:0", "cuda:1"]),
])
def test_rank_group_goes_round_robin_over_the_cards(monkeypatch, cards, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    asked = []
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: asked.append((a, b)) or True)
    g = RankGroup(4)
    assert [str(d) for d in g.devices] == want
    # only ring neighbours on distinct cards are asked about
    assert all(a != b for a, b in asked) and (len(asked) > 0) == (cards > 1)


def test_rank_group_refuses_neighbours_without_peer_access(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: {a, b} != {1, 2})
    with pytest.raises(ValueError, match=r"ring neighbours 1 \(cuda:1\) and 2 "
                                         r"\(cuda:2\) .* without peer access"):
        RankGroup(4)
    # ranks 1 and 2 are not neighbours in this order: accepted
    g = RankGroup(devices=["cuda:1", "cuda:0", "cuda:2", "cuda:3"])
    assert g.size == 4


def test_cpu_dp_step_launches_no_kernel():
    K.reset_launch_counts()
    for bidirectional in (True, False):
        port_dp(4, jax_test_case(), bidirectional)
    assert set(K.launch_counts().values()) == {0}
    assert ring_all_reduce([torch.ones(3)] * 2)[0].tolist() == [2.0] * 3
    assert set(K.launch_counts().values()) == {0}
