"""The port's ``fit_sequences`` on a model axis with the recurrent chain
split (``parallel.tp_seq``), for the placements ``param_specs`` gives the
Elman cell beyond ``tests/test_torch_seq_tp.py``'s net, against the JAX
package's ``fit_sequences`` on ``make_mesh(8)`` = ``(2, 4)`` (GSPMD
partitions its scan) and the port on one device, on the CPU in f64:

* ``4 -> [12] -> 4``: the cell's input weight column-parallel (its partial
  products all-reduced once a sequence), the bias replicated, the output
  layer row-parallel;
* ``1 -> [12, 12] -> 1``: two stacked cells, the second one's input weight
  column-parallel on the first one's output;
* ZeRO-2 and ZeRO-3 with adam;
* one bf16 step (``mixed_precision``) against the JAX package's bf16 step,
  within ``tests/test_torch_mixed_precision.py``'s bound (four bf16
  roundings of each leaf's largest gradient);
* ``remat_every`` and ``offload_activations`` on the split;
* a recurrent graph built without ``gen_net`` keeps the gathered route,
  with its one warning.

Kernel 9's calls are counted on the CPU ranks (each call of more than one
rank launches once on the card) and held to the design's count; every
all-gather moves an activation (its per-rank block holds the data rank's
8 rows), never a weight.  Widths of 12 over 4 model ranks make every
weight block's shape differ from every activation block's."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensor_ops_tpu as T
from tensor_ops_tpu.backend.rng import Rng as JRng
from tensor_ops_tpu.models import act_logistic as j_logistic
from tensor_ops_tpu.models import optim as JO
from tensor_ops_tpu.models import squared_error as j_sq
from tensor_ops_tpu.models.recurrent import gen_net as j_gen_rnet
from tensor_ops_tpu.models.trainer import fit_sequences as j_fit_seq
from tensor_ops_tpu.parallel.mesh import make_mesh as j_make_mesh
from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng as TRng
from tensor_ops_tpu_torch.models import act_logistic as t_logistic
from tensor_ops_tpu_torch.models import optim as TO
from tensor_ops_tpu_torch.models import recurrent as TR
from tensor_ops_tpu_torch.models import squared_error as t_sq
from tensor_ops_tpu_torch.models.trainer import fit_sequences as t_fit_seq
from tensor_ops_tpu_torch.parallel import make_mesh as t_make_mesh
from test_torch_seq_tp import collective_calls, host, same_runs
from torch_threads import one_torch_thread  # noqa: F401

JB = T.JaxBackend(dtype=jnp.float64)
TB = TorchBackend(torch.float64, "cpu")
BF16_TOL = 2.0 ** -6   # tests/test_torch_mixed_precision.py's bound
B_RANK = 8             # sequences a data rank: batch 16 over dp = 2
N = 6                  # timesteps


def tmesh():
    return t_make_mesh(8, devices=["cpu"] * 8)


def seq_data(i, o, n_seq=32, seed=3):
    r = np.random.default_rng(seed)
    return (r.uniform(-1, 1, size=(n_seq, N, i)),
            r.uniform(0, 1, size=(n_seq, N, o)))


def nets(i, hidden, o, seed=3):
    """The JAX package's chain of Elman cells (logistic output and state)
    and a logistic ffLayer out, and the port's with its leaves."""
    lg = [(h, j_logistic(), j_logistic()) for h in hidden]
    jn = j_gen_rnet(JB, i, o, lg, j_logistic(), None, JRng(JB, seed=seed))
    tl = [(h, t_logistic(), t_logistic()) for h in hidden]
    tmpl = TR.gen_net(TB, i, o, tl, t_logistic(), None, TRng(TB, 0))
    tn = TR.RecurrentNetwork(
        tmpl.op, tuple(TB.asarray(np.asarray(s)) for s in jn.states),
        tuple(TB.asarray(np.asarray(p)) for p in jn.params), tmpl.arch)
    return jn, tn


KW = dict(batch_size=16, rate_state=0.01, rate_param=0.1, epochs=2,
          log_every=1, verbose=False)
STEPS = 4   # 32 sequences, batch 16, 2 epochs


def split_runs(i, hidden, o, **kw):
    """The JAX run on make_mesh(8), the port's on one device and on (2, 4)
    (its warnings and kernel-9 calls kept)."""
    XS, TS = seq_data(i, o)
    kw = dict(KW, **kw)
    jn, tn = nets(i, hidden, o)
    j = j_fit_seq(jn, j_sq(o), JB, XS, TS, mesh=j_make_mesh(8), **kw)
    single = t_fit_seq(nets(i, hidden, o)[1], t_sq(o), TB, XS, TS, **kw)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        t, calls = collective_calls(lambda: t_fit_seq(
            tn, t_sq(o), TB, XS, TS, mesh=tmesh(), **kw))
    return j, single, t, [str(x.message) for x in w], calls


def weight_blocks(res):
    """Each model-sharded leaf's per-rank block shape."""
    return {tuple(x.shards[0].shape) for x in res.net.params
            if "model" in x.spec}


def check_split(got, want, calls, per_group, leaves, msgs):
    """The curve and leaves at 1e-9, no warning of the model axis, kernel
    9's calls as the design predicts (``per_group``: the all-reduces and
    all-gathers of one data group's step, then the loss and each leaf's
    gradient on each model rank reduced over the data axis), every
    all-gather an activation's, and the state weight on (model, None)."""
    same_runs(got, want)
    assert not [m for m in msgs if "model" in m], msgs
    dp, tp = 2, 4
    ar = [c for c in calls if c[0] == "ar"]
    ag = [c for c in calls if c[0] == "ag"]
    assert len(ar) == STEPS * (1 + tp * leaves + dp * per_group[0])
    assert len(ag) == STEPS * dp * per_group[1]
    assert not [c for c in calls if c[0] == "rs"]
    blocks = weight_blocks(got)
    assert all(B_RANK in shape and shape not in blocks for _, shape in ag)
    k = len(got.net.states)
    assert got.net.params[0].spec == ("model", None)
    assert all(s.spec == (None,) for s in got.net.states[:k])


@pytest.fixture(scope="module")
def col_runs():
    return split_runs(4, [12], 4)


def test_column_parallel_input_weight_matches_jax(col_runs):
    """``4 -> [12] -> 4``: wS (model, None), wX (None, model), b
    replicated, the output layer row-parallel.  Per data group and step:
    wX's partial products all-reduced once, the state gathered at each
    timestep, the row-split output gathered for the loss; backward, the
    output layer's input cotangent all-reduced, the state's at each
    timestep, and the cell's sliced (wX x + b) cotangent gathered."""
    j, single, t, msgs, calls = col_runs
    specs = [x.spec for x in t.net.params]
    assert specs == [("model", None), (None, "model"), (None,),
                     ("model", None), ("model",)]
    check_split(t, j, calls, (N + 2, N + 2), 6, msgs)
    same_runs(t, single)


@pytest.mark.parametrize("opts", [
    dict(remat_every=2), dict(remat_every=3, offload_activations=True),
    dict(offload_activations=True)], ids=["remat2", "remat3-offload",
                                          "offload"])
def test_memory_options_act_on_the_split(col_runs, opts):
    """``remat_every`` and ``offload_activations`` on the split cell: the
    curve and leaves at 1e-9 against the JAX run and the split without
    them, no warning; the backward recomputes each block's timesteps from
    its kept entry state, so the state's all-gathers grow by N per data
    group and step, and nothing else moves."""
    j, _, plain, _, plain_calls = col_runs
    XS, TS = seq_data(4, 4)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        t, calls = collective_calls(lambda: t_fit_seq(
            nets(4, [12], 4)[1], t_sq(4), TB, XS, TS, mesh=tmesh(),
            **KW, **opts))
    assert not [str(m.message) for m in w if "model" in str(m.message)]
    same_runs(t, j)
    same_runs(t, plain)

    def count(cs, phase):
        return sum(c[0] == phase for c in cs)

    assert count(calls, "ar") == count(plain_calls, "ar")
    assert count(calls, "ag") == count(plain_calls, "ag") + STEPS * 2 * N
    assert t.net.params[0].spec == ("model", None)


def test_a_remat_block_must_divide_the_sequence_length():
    """``remat_every`` that divides no block of the N timesteps raises
    ``ShapeError`` on the split, as the single-device scan does."""
    from tensor_ops_tpu_torch.ops.shapes import ShapeError

    XS, TS = seq_data(4, 4)
    with pytest.raises(ShapeError, match="remat_every"):
        t_fit_seq(nets(4, [12], 4)[1], t_sq(4), TB, XS, TS, mesh=tmesh(),
                  remat_every=4, **KW)


def test_two_stacked_cells_match_jax():
    """``1 -> [12, 12] -> 1``: both state weights row-parallel, the second
    cell's input weight column-parallel on the first cell's output (whole
    on every rank, sliced), the output layer column-parallel.  Per data
    group and step: the two cells' state gathers at each timestep and two
    all-reduces of partial products; backward, the two cells' state
    cotangents at each timestep, two all-reduces, and three all-gathers
    (the output layer's and the second cell's input cotangents, and its
    sliced (wX x + b) cotangent)."""
    j, single, t, msgs, calls = split_runs(1, [12, 12], 1)
    specs = [x.spec for x in t.net.params]
    assert specs == [("model", None), ("model", None), ("model",),
                     ("model", None), (None, "model"), (None,),
                     (None, "model"), (None,)]
    check_split(t, j, calls, (2 * N + 2, 2 * N + 3), 10, msgs)
    same_runs(t, single)


def test_validation_runs_split_and_matches_jax():
    """``val`` on the mesh runs each data group's sequences through the
    split chain (no weight gathered: every all-gather is an activation's,
    or the per-sequence losses' onto rank 0): ``val_loss`` equals the JAX
    run's at 1e-9."""
    val = seq_data(4, 4, n_seq=16, seed=8)
    j, single, t, msgs, calls = split_runs(4, [12], 4, val=val)
    assert len(t.history) == len(j.history) == STEPS
    for g, w, s in zip(t.history, j.history, single.history):
        assert abs(g["val_loss"] - w["val_loss"]) <= 1e-9, (g, w)
        assert abs(g["val_loss"] - s["val_loss"]) <= 1e-9, (g, s)
    assert not [m for m in msgs if "model" in m], msgs
    blocks = weight_blocks(t)
    assert all(B_RANK in shape and shape not in blocks
               for phase, shape in calls if phase == "ag")


@pytest.mark.parametrize("stage", [2, 3])
def test_zero_stage_with_adam_matches_jax(stage):
    """adam with ZeRO-2 / ZeRO-3 over the data axis, the cell split over
    the model axis: the curve and leaves at 1e-9 against the JAX run and
    one device, every leaf on the JAX run's spec."""
    XS, TS = seq_data(4, 4)
    base = dict(KW, rate_param=0.05)
    jn, tn = nets(4, [12], 4)
    j = j_fit_seq(jn, j_sq(4), JB, XS, TS, mesh=j_make_mesh(8),
                  optimizer=JO.adam(), zero_stage=stage, **base)
    single = t_fit_seq(nets(4, [12], 4)[1], t_sq(4), TB, XS, TS,
                       optimizer=TO.adam(), **base)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        t = t_fit_seq(tn, t_sq(4), TB, XS, TS, mesh=tmesh(),
                      optimizer=TO.adam(), zero_stage=stage, **base)
    assert not [str(m.message) for m in w if "model" in str(m.message)]
    same_runs(t, j)
    same_runs(t, single)
    # each leaf on the JAX run's spec: wS on (model, None) at ZeRO-2, its
    # free dimension over the data axis too at ZeRO-3
    for a, b in zip(t.net.params, j.net.params):
        spec = tuple(b.sharding.spec)
        assert a.spec == spec + (None,) * (b.ndim - len(spec))
    assert t.net.params[0].spec == (("model", None) if stage == 2
                                    else ("model", "data"))


def test_bf16_step_matches_jax():
    """One bf16 dual-rate step (``mixed_precision="bf16"``) of the split
    cell against the JAX package's bf16 step on make_mesh(8): each leaf's
    gradient within four bf16 roundings of its largest, the masters in
    f64 and the state weight on (model, None)."""
    XS, TS = seq_data(4, 4, n_seq=16)
    kw = dict(KW, epochs=1, mixed_precision="bf16")
    jn, tn = nets(4, [12], 4)
    j = j_fit_seq(jn, j_sq(4), JB, XS, TS, mesh=j_make_mesh(8), **kw)
    t = t_fit_seq(tn, t_sq(4), TB, XS, TS, mesh=tmesh(), **kw)
    assert len(t.history) == len(j.history) == 1
    loss_t, loss_j = t.history[0]["loss"], j.history[0]["loss"]
    assert abs(loss_t - loss_j) <= BF16_TOL * abs(loss_j)
    k = len(jn.states)
    rates = [KW["rate_state"]] * k + [KW["rate_param"]] * len(jn.params)
    before = list(jn.states) + list(jn.params)
    after_t = list(t.net.states) + list(t.net.params)
    after_j = list(j.net.states) + list(j.net.params)
    for p0, a, b, rate in zip(before, after_t, after_j, rates):
        p0 = np.asarray(p0)
        ga, gb = (p0 - host(a)) / rate, (p0 - np.asarray(b)) / rate
        assert np.abs(ga - gb).max() <= BF16_TOL * np.abs(gb).max()
    assert t.net.params[0].dtype == torch.float64
    assert t.net.params[0].spec == ("model", None)


def test_a_recurrent_graph_built_another_way_runs_gathered_with_one_warning():
    """A recurrent graph composed by hand (no ``gen_net`` arch to read its
    layers from) runs on its leaves gathered over the model axis, with one
    warning naming it, and equals the one-device run at 1e-9."""
    def hand_net():
        rng = TRng(TB, 5)
        cell = TR.fully_connected(t_logistic(), TB, 1, 8, rng)
        return cell.then(TR.ff_layer(TB, 8, 1, rng))

    XS, TS = seq_data(1, 1, n_seq=16)
    kw = dict(KW, epochs=1)
    assert hand_net().arch is None
    single = t_fit_seq(hand_net(), t_sq(1), TB, XS, TS, **kw)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        t = t_fit_seq(hand_net(), t_sq(1), TB, XS, TS, mesh=tmesh(), **kw)
    gathered = [str(m.message) for m in w
                if "all-gathered over the model" in str(m.message)]
    assert len(gathered) == 1 and "not a gen_net chain" in gathered[0]
    same_runs(t, single)


def test_chip_smoke_predicts_phase_24s_launches():
    """``chip_smoke.tp_seq_predicted`` (phase 24's ``want`` on the card) is
    the count the executor makes on the CPU ranks, for a net whose leaves
    take the placements phase 24's 32 -> [512] -> 32 takes at (2, 2) (wS
    row-, wX column-parallel, b replicated, the output layer
    row-parallel), with adam as phase 24 drives it."""
    import chip_smoke

    XS, TS = seq_data(4, 4)
    mesh = t_make_mesh(4, shape=(2, 2), devices=["cpu"] * 4)
    t, calls = collective_calls(lambda: t_fit_seq(
        nets(4, [8], 4)[1], t_sq(4), TB, XS, TS, mesh=mesh,
        optimizer=TO.adam(), **dict(KW, epochs=1)))
    assert [x.spec for x in t.net.params] == [
        ("model", None), (None, "model"), (None,), ("model", None),
        ("model",)]
    got = {p: sum(c[0] == p for c in calls) for p in ("ar", "rs", "ag")}
    assert got == chip_smoke.tp_seq_predicted(2, 2, N, 6, 2)


def test_chip_smoke_predicts_phase_24s_launches_with_remat():
    """``chip_smoke.tp_seq_predicted(recompute=True)``, phase 24's ``want``
    for its dual-rate sgd run with ``remat_every`` and
    ``offload_activations``, is the count the executor makes on the CPU
    ranks for the net of the test above."""
    import chip_smoke

    XS, TS = seq_data(4, 4)
    mesh = t_make_mesh(4, shape=(2, 2), devices=["cpu"] * 4)
    t, calls = collective_calls(lambda: t_fit_seq(
        nets(4, [8], 4)[1], t_sq(4), TB, XS, TS, mesh=mesh, remat_every=3,
        offload_activations=True, **dict(KW, epochs=1)))
    got = {p: sum(c[0] == p for c in calls) for p in ("ar", "rs", "ag")}
    assert got == chip_smoke.tp_seq_predicted(2, 2, N, 6, 2, recompute=True)
