"""The port's ``fit_sequences`` on a mesh's data axis against the JAX
package's, on the CPU in f64: the recurrent loop on a ``(4, 1)`` mesh
(states replicated, params by ``param_specs``), dual-rate SGD and adam,
crash/resume, accumulation and bf16, the ZeRO ladder over the joint states
and params, ``offload_opt_state`` and ``offload_activations``.

The port runs on ``make_mesh(4, shape=(4, 1), devices=["cpu"] * 4)``, the
JAX package on a mesh of the same shape of its CPU devices (its tests run
these cases at ``(2, 4)`` or ``(4, 2)``: tensor parallelism is ROADMAP.md
Queue 1 item 9b), from the same network and sequences; losses, states,
params and the ``.state`` files' moments agree to 1e-9, and the JAX tests'
own equalities (bit for bit for offload and resume) hold."""

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
from tensor_ops_tpu.utils import checkpoint as JC
from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng as TRng
from tensor_ops_tpu_torch.models import act_logistic as t_logistic
from tensor_ops_tpu_torch.models import optim as TO
from tensor_ops_tpu_torch.models import squared_error as t_sq
from tensor_ops_tpu_torch.models.recurrent import RecurrentNetwork
from tensor_ops_tpu_torch.models.recurrent import gen_net as t_gen_rnet
from tensor_ops_tpu_torch.models.trainer import fit_sequences as t_fit_seq
from tensor_ops_tpu_torch.parallel import make_mesh as t_make_mesh
from tensor_ops_tpu_torch.utils import checkpoint as TC
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-9
JB = T.JaxBackend(dtype=jnp.float64)
TB = TorchBackend(torch.float64, "cpu")


def jmesh(dp=4):
    return j_make_mesh(dp, shape=(dp, 1))


def tmesh(dp=4):
    return t_make_mesh(dp, shape=(dp, 1), devices=["cpu"] * dp)


def seq_data(n_seq=32, n=6, seed=3):
    r = np.random.default_rng(seed)
    t = np.linspace(0, 1, n + 1)
    waves = np.sin(2 * np.pi * t[None, :] + r.uniform(0, np.pi,
                                                      size=(n_seq, 1)))
    return waves[:, :-1, None], waves[:, 1:, None]


def jrnet(seed=3, h=8):
    return j_gen_rnet(JB, 1, 1, [(h, j_logistic(), j_logistic())],
                      j_logistic(), None, JRng(JB, seed=seed))


def trnet(jn):
    h = int(np.asarray(jn.states[0]).shape[0])
    tmpl = t_gen_rnet(TB, 1, 1, [(h, t_logistic(), t_logistic())],
                      t_logistic(), None, TRng(TB, 0))
    return RecurrentNetwork(
        tmpl.op, tuple(TB.asarray(np.asarray(s)) for s in jn.states),
        tuple(TB.asarray(np.asarray(p)) for p in jn.params), tmpl.arch)


def host(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module")
def runs():
    """The runs several cases read, each made once per module
    (:func:`shared`)."""
    return {}


def shared(runs, key, make):
    """``runs[key]``, made by ``make()`` the first time a case asks."""
    if key not in runs:
        runs[key] = make()
    return runs[key]


def same_runs(got, want, atol=ATOL):
    assert len(got.history) == len(want.history) > 0
    for g, w in zip(got.history, want.history):
        assert g["step"] == w["step"]
        assert abs(g["loss"] - w["loss"]) <= atol, (g, w)
    for a, b in zip(tuple(got.net.states) + tuple(got.net.params),
                    tuple(want.net.states) + tuple(want.net.params)):
        if atol == 0:
            np.testing.assert_array_equal(host(a), host(b))
        else:
            np.testing.assert_allclose(host(a), host(b), atol=atol, rtol=0)


def both(tmp_path, seed=3, XS=None, TS=None, opt=None, **kw):
    """The JAX and the port's mesh runs of one configuration (each writing
    its ``.state`` at the end, held to each other); (port, JAX) results."""
    if XS is None:
        XS, TS = seq_data()
    kw = dict(dict(epochs=2, batch_size=16, rate_state=0.01, rate_param=0.1,
                   log_every=1, verbose=False, prefetch=0), **kw)
    steps = kw["epochs"] * (XS.shape[0] // kw["batch_size"])
    out = []
    for tag, fit, net, mesh, sq, O in (
            ("j", j_fit_seq, jrnet(seed), jmesh(), j_sq, JO),
            ("t", t_fit_seq, trnet(jrnet(seed)), tmesh(), t_sq, TO)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out.append(fit(net, sq(1), JB if tag == "j" else TB, XS, TS,
                           mesh=mesh, checkpoint_every=steps,
                           checkpoint_path=str(tmp_path / f"{tag}.npz"),
                           optimizer=getattr(O, opt)() if opt else None,
                           **kw))
    got, _ = TC.load_arrays(str(tmp_path / "t.npz.state"))
    want, _ = JC.load_arrays(str(tmp_path / "j.npz.state"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0,
                                   err_msg=k)
    same_runs(out[1], out[0])
    return out[1], out[0]


def test_fit_sequences_mesh_matches_jax_and_single_device(tmp_path):
    """test_fit_mesh.py:502 at (4, 1): dual-rate SGD on the mesh equals the
    JAX mesh run and the port's single-device run at 1e-9."""
    t_mesh, _ = both(tmp_path, epochs=3)
    XS, TS = seq_data()
    single = t_fit_seq(trnet(jrnet()), t_sq(1), TB, XS, TS, epochs=3,
                       batch_size=16, rate_state=0.01, rate_param=0.1,
                       log_every=1, verbose=False)
    assert len(single.history) > 3
    same_runs(t_mesh, single)


def test_fit_sequences_mesh_adam_resume(tmp_path):
    """Adam and clip on the sequence mesh: a crash/resume chain equals the
    straight run bit for bit, and the straight run the JAX package's."""
    XS, TS = seq_data()
    kw = dict(batch_size=16, rate_param=0.05, optimizer=TO.adam(),
              clip_norm=1.0, log_every=1, verbose=False, mesh=tmesh(),
              checkpoint_every=2)
    full = t_fit_seq(trnet(jrnet(4)), t_sq(1), TB, XS, TS, epochs=4,
                     checkpoint_path=str(tmp_path / "a.npz"), **kw)
    ck = str(tmp_path / "b.npz")
    t_fit_seq(trnet(jrnet(4)), t_sq(1), TB, XS, TS, epochs=2,
              checkpoint_path=ck, **kw)
    resumed = t_fit_seq(trnet(jrnet(777)), t_sq(1), TB, XS, TS, epochs=4,
                        checkpoint_path=ck, resume=True, **kw)
    assert full.steps == resumed.steps == 8
    for a, b in zip(tuple(resumed.net.states) + tuple(resumed.net.params),
                    tuple(full.net.states) + tuple(full.net.params)):
        np.testing.assert_array_equal(host(a), host(b))
    t_run, _ = both(tmp_path, seed=4, opt="adam", epochs=4, clip_norm=1.0,
                    rate_param=0.05)
    same_runs(t_run, full)


def test_fit_sequences_mesh_validation():
    """Eager errors: a batch that does not split over the data ranks; a
    pipeline axis; ZeRO or offload with dual-rate SGD (stateless)."""
    XS, TS = seq_data()
    with pytest.raises(ValueError, match="data-axis"):
        t_fit_seq(trnet(jrnet()), t_sq(1), TB, XS, TS, batch_size=15,
                  mesh=tmesh(), verbose=False)

    from tensor_ops_tpu_torch.parallel.pipeline import make_pipeline_mesh

    with pytest.raises(ValueError, match="pipeline"):
        t_fit_seq(trnet(jrnet()), t_sq(1), TB, XS, TS, batch_size=16,
                  mesh=make_pipeline_mesh(2, devices=["cpu"] * 2),
                  verbose=False)
    with pytest.raises(ValueError, match="stateless"):
        t_fit_seq(trnet(jrnet()), t_sq(1), TB, XS, TS, batch_size=16,
                  mesh=tmesh(), shard_opt_state=True, verbose=False)


def test_fit_sequences_mesh_accum_and_mixed():
    """test_fit_mesh.py:574 at (4, 1): accumulation equals the plain run at
    1e-9; a bf16 run trains on full-precision masters."""
    XS, TS = seq_data()
    kw = dict(epochs=2, batch_size=16, optimizer=TO.adam(), rate_param=0.05,
              log_every=1, verbose=False, mesh=tmesh())
    plain = t_fit_seq(trnet(jrnet()), t_sq(1), TB, XS, TS, **kw)
    accum = t_fit_seq(trnet(jrnet()), t_sq(1), TB, XS, TS, accum_steps=2,
                      **kw)
    same_runs(accum, plain)
    net = trnet(jrnet())
    mp = t_fit_seq(net, t_sq(1), TB, XS, TS, epochs=2, batch_size=16,
                   rate_state=0.01, rate_param=0.1, mixed_precision="bf16",
                   log_every=1, verbose=False, mesh=tmesh())
    assert all(np.isfinite(h["loss"]) for h in mp.history)
    assert mp.net.params[0].dtype == net.params[0].dtype == torch.float64


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_fit_sequences_zero_ladder(runs, tmp_path, stage):
    """ZeRO over the joint states + params (test_zero1.py:216,
    test_zero2.py:219, test_zero3.py:243 at (4, 1)): each stage equals the
    JAX run at that stage (moments and all) and the replicated run at
    1e-9; at stage 3 with EMA.  Stages 1 and 2 share their replicated
    run."""
    XS, TS = seq_data(n_seq=16, n=8, seed=8)
    kw = dict(epochs=2, batch_size=8, rate_param=0.05, rate_state=0.01,
              ema_decay=0.9 if stage == 3 else None)
    t_z, _ = both(tmp_path, seed=7, XS=XS, TS=TS, opt="adam",
                  zero_stage=stage, **kw)
    rep = shared(runs, ("replicated", kw["ema_decay"]), lambda: t_fit_seq(
        trnet(jrnet(7)), t_sq(1), TB, XS, TS, mesh=tmesh(),
        optimizer=TO.adam(), log_every=1, verbose=False, **kw))
    same_runs(t_z, rep)


def test_fit_sequences_offload_bit_identical():
    """offload_opt_state on the recurrent loop (test_offload.py:156), alone
    and on the mesh at ZeRO-3: bit-equal to the on-device run."""
    XS, TS = seq_data(n_seq=16, n=8, seed=9)
    kw = dict(epochs=2, batch_size=8, optimizer=TO.adam(), rate_param=0.05,
              rate_state=0.01, verbose=False, log_every=1)
    for mesh_kw in ({}, dict(mesh=tmesh(), zero_stage=3)):
        runs = [t_fit_seq(trnet(jrnet(8)), t_sq(1), TB, XS, TS,
                          offload_opt_state=off, **mesh_kw, **kw)
                for off in (True, False)]
        same_runs(runs[0], runs[1], atol=0)


def test_offload_activations_on_mesh(tmp_path):
    """offload_activations and offload_opt_state together on the mesh
    (test_scan_offload.py:114 at (4, 1)): bit-equal to the plain mesh run,
    and equal to the JAX package's run of both offloads."""
    XS, TS = seq_data()
    kw = dict(epochs=1, batch_size=16, rate_state=0.01, rate_param=0.05,
              optimizer=TO.adam(), log_every=1, verbose=False, mesh=tmesh())
    off = t_fit_seq(trnet(jrnet(4)), t_sq(1), TB, XS, TS,
                    offload_activations=True, offload_opt_state=True, **kw)
    plain = t_fit_seq(trnet(jrnet(4)), t_sq(1), TB, XS, TS, **kw)
    same_runs(off, plain, atol=0)
    t_run, _ = both(tmp_path, seed=4, epochs=1, opt="adam", rate_param=0.05,
                    offload_activations=True, offload_opt_state=True)
    same_runs(t_run, off)
