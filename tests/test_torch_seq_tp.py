"""The port's ``fit_sequences`` on a mesh with a model axis against the JAX
package's, on the CPU in f64, as ``tests/test_fit_mesh.py:502-600`` runs
it at ``make_mesh(8)`` = ``(2, 4)``: the loss curve, the final states and
params at 1e-9 against the JAX run and one device, the Elman state weight
trained on ``(model, None)``; adam with a crash/resume chain; accumulation;
mixed precision.

The params are placed by ``param_specs`` and the states replicated; the
cell runs split over the model axis (``parallel.tp_seq``): each model rank
its rows of the state weight, the state all-gathered at each timestep, no
weight gathered at any use and no warning.  ``tests/test_torch_seq_tp_split.py``
holds the other placements the rule gives (a column-parallel input weight,
two stacked cells, ZeRO-3, bf16)."""

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
from tensor_ops_tpu_torch.models import squared_error as t_sq
from tensor_ops_tpu_torch.models.recurrent import RecurrentNetwork
from tensor_ops_tpu_torch.models.recurrent import gen_net as t_gen_rnet
from tensor_ops_tpu_torch.models.trainer import fit_sequences as t_fit_seq
from tensor_ops_tpu_torch.parallel import make_mesh as t_make_mesh
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-9
JB = T.JaxBackend(dtype=jnp.float64)
TB = TorchBackend(torch.float64, "cpu")


def tmesh():
    return t_make_mesh(8, devices=["cpu"] * 8)


def seq_data(n_seq=32, n=6, seed=3):
    r = np.random.default_rng(seed)
    t = np.linspace(0, 1, n + 1)
    waves = np.sin(2 * np.pi * t[None, :] + r.uniform(0, np.pi,
                                                      size=(n_seq, 1)))
    return waves[:, :-1, None], waves[:, 1:, None]


def jrnet(seed=3):
    return j_gen_rnet(JB, 1, 1, [(8, j_logistic(), j_logistic())],
                      j_logistic(), None, JRng(JB, seed=seed))


def trnet(seed=3):
    jn = jrnet(seed)
    tmpl = t_gen_rnet(TB, 1, 1, [(8, t_logistic(), t_logistic())],
                      t_logistic(), None, TRng(TB, 0))
    return RecurrentNetwork(
        tmpl.op, tuple(TB.asarray(np.asarray(s)) for s in jn.states),
        tuple(TB.asarray(np.asarray(p)) for p in jn.params), tmpl.arch)


def host(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def same_runs(got, want, atol=ATOL):
    assert len(got.history) == len(want.history) > 0
    for g, w in zip(got.history, want.history):
        assert abs(g["loss"] - w["loss"]) <= atol, (g, w)
    for a, b in zip(tuple(got.net.states) + tuple(got.net.params),
                    tuple(want.net.states) + tuple(want.net.params)):
        if atol == 0:
            np.testing.assert_array_equal(host(a), host(b))
        else:
            np.testing.assert_allclose(host(a), host(b), atol=atol, rtol=0)


KW = dict(batch_size=16, rate_state=0.01, rate_param=0.1, epochs=3,
          log_every=1, verbose=False)


def collective_calls(fn):
    """``fn()`` with each kernel-9 call of more than one rank recorded as
    ``(phase, per-rank input shape)``: what launches on the card."""
    from tensor_ops_tpu_torch.parallel import collective_kernels as CK

    seen, real = [], CK._collective

    def spy(xs, phase, *a, **k):
        if len(xs) > 1:
            seen.append((phase, tuple(xs[0].shape)))
        return real(xs, phase, *a, **k)

    CK._collective = spy
    try:
        return fn(), seen
    finally:
        CK._collective = real


@pytest.fixture(scope="module")
def dual_rate():
    """tests/test_fit_mesh.py:502's runs: the JAX package on make_mesh(8)
    and the port on one device and on make_mesh(8) (its warnings and
    kernel-9 calls kept)."""
    XS, TS = seq_data()
    j = j_fit_seq(jrnet(), j_sq(1), JB, XS, TS, mesh=j_make_mesh(8), **KW)
    single = t_fit_seq(trnet(), t_sq(1), TB, XS, TS, **KW)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        t, calls = collective_calls(lambda: t_fit_seq(
            trnet(), t_sq(1), TB, XS, TS, mesh=tmesh(), **KW))
    return j, single, t, [str(x.message) for x in w], calls


def test_fit_sequences_make_mesh_8_matches_jax_and_single(dual_rate):
    """The curve, final states and params on (2, 4) equal the JAX mesh run
    and one device at 1e-9; the (8, 8) Elman state weight trains
    row-parallel, as the JAX run's does."""
    j, single, t, *_ = dual_rate
    assert len(t.history) == len(single.history) > 3
    same_runs(t, single)
    same_runs(t, j)
    k = len(t.net.states)
    specs = tuple(x.spec for x in t.net.states + t.net.params)
    assert specs[k] == ("model", None)
    assert tuple(j.net.params[0].sharding.spec) == ("model", None)
    assert all(s == (None,) * len(s) for s in specs[:k])


def test_fit_sequences_cell_runs_split_without_warning(dual_rate):
    """The cell runs split (``parallel.tp_seq``): no warning, and kernel 9's
    calls are the design's.  Per step and data group (n = 6 timesteps, B =
    8 sequences a data rank): the state's all-gather at each timestep, the
    output layer's (column-parallel, (1, 8)) all-reduce of its partial
    products and, backward, the all-gather of its sliced input's
    cotangent and the all-reduce of the state's partial cotangents at each
    timestep; then the loss and each of the 6 leaves' gradients on each of
    the 4 model ranks reduced over the data axis.  The gathered route made
    one all-gather a model-sharded leaf a data group a step instead of
    the per-timestep calls."""
    *_, msgs, calls = dual_rate
    assert not [m for m in msgs if "model" in m], msgs
    steps, dp, tp, n, leaves = 6, 2, 4, 6, 6
    ar = [c for c in calls if c[0] == "ar"]
    ag = [c for c in calls if c[0] == "ag"]
    assert len(ar) == steps * (1 + tp * leaves + dp * (n + 1))
    assert len(ag) == steps * dp * (n + 1)
    assert not [c for c in calls if c[0] == "rs"]


def test_fit_sequences_make_mesh_8_adam_resume(tmp_path):
    """tests/test_fit_mesh.py:529: adam with the clip on (2, 4), and a
    crash/resume chain (resumed from other weights) that reproduces the
    straight run bit for bit; the straight run equals the JAX one at
    1e-9."""
    XS, TS = seq_data()
    kw = dict(batch_size=16, rate_param=0.05, clip_norm=1.0, log_every=1,
              verbose=False, checkpoint_every=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        full = t_fit_seq(trnet(4), t_sq(1), TB, XS, TS, epochs=4,
                         optimizer=TO.adam(), mesh=tmesh(),
                         checkpoint_path=str(tmp_path / "a.npz"), **kw)
        ck = str(tmp_path / "b.npz")
        t_fit_seq(trnet(4), t_sq(1), TB, XS, TS, epochs=2,
                  optimizer=TO.adam(), mesh=tmesh(), checkpoint_path=ck,
                  **kw)
        resumed = t_fit_seq(trnet(777), t_sq(1), TB, XS, TS, epochs=4,
                            optimizer=TO.adam(), mesh=tmesh(),
                            checkpoint_path=ck, resume=True, **kw)
    assert full.steps == resumed.steps == 8
    for a, b in zip(tuple(resumed.net.states) + tuple(resumed.net.params),
                    tuple(full.net.states) + tuple(full.net.params)):
        np.testing.assert_array_equal(host(a), host(b))
    j = j_fit_seq(jrnet(4), j_sq(1), JB, XS, TS, epochs=4,
                  optimizer=JO.adam(), mesh=j_make_mesh(8),
                  checkpoint_path=str(tmp_path / "j.npz"), **kw)
    same_runs(full, j)


def test_fit_sequences_make_mesh_8_accum_and_mixed():
    """tests/test_fit_mesh.py:574: accum_steps=2 equals the plain run at
    1e-9 on (2, 4); mixed_precision="bf16" trains with the masters in
    their dtype and the Elman weight on its model spec."""
    XS, TS = seq_data()
    kw = dict(epochs=2, batch_size=16, optimizer=TO.adam(), rate_param=0.05,
              log_every=1, verbose=False, mesh=tmesh())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plain = t_fit_seq(trnet(), t_sq(1), TB, XS, TS, **kw)
        accum = t_fit_seq(trnet(), t_sq(1), TB, XS, TS, accum_steps=2, **kw)
        mp = t_fit_seq(trnet(), t_sq(1), TB, XS, TS, epochs=2, batch_size=16,
                       rate_state=0.01, rate_param=0.1,
                       mixed_precision="bf16", log_every=1, verbose=False,
                       mesh=tmesh())
    same_runs(accum, plain)
    assert all(np.isfinite(h["loss"]) for h in mp.history)
    assert mp.net.params[0].dtype == torch.float64
    assert mp.net.params[0].spec == ("model", None)


def test_fit_sequences_val_on_a_2x2_mesh_matches_jax():
    """``val`` of a mesh ``fit_sequences`` runs on the mesh (each data rank
    its sequences, the per-sequence losses gathered to rank 0) and equals
    the JAX run's ``val_loss``; the returned leaves stay Sharded."""
    XS, TS = seq_data()
    XV, TV = seq_data(n_seq=9, seed=8)  # 9 rows: padded to 10 over dp 2
    kw = dict(batch_size=16, rate_state=0.01, rate_param=0.1, epochs=2,
              log_every=1, verbose=False, val=(XV, TV))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = j_fit_seq(jrnet(), j_sq(1), JB, XS, TS,
                      mesh=j_make_mesh(4, shape=(2, 2)), **kw)
        t = t_fit_seq(trnet(), t_sq(1), TB, XS, TS,
                      mesh=t_make_mesh(4, shape=(2, 2),
                                       devices=["cpu"] * 4), **kw)
    assert len(t.history) == len(j.history) > 2
    for g, w in zip(t.history, j.history):
        assert abs(g["loss"] - w["loss"]) <= ATOL
        assert abs(g["val_loss"] - w["val_loss"]) <= ATOL, (g, w)
    assert all(hasattr(x, "spec") for x in t.net.states + t.net.params)
