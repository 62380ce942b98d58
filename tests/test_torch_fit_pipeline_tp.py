"""The port's ``fit`` on a ``(data, stage, model)`` mesh (pipeline mode with
the tensor-parallel partitions) against the JAX package's, on the CPU in
f64.

Each case runs the port's ``fit`` on a ``["cpu"] * 8`` mesh and the JAX
package's ``fit`` from the same parameters (drawn by the JAX package) and
the same numpy data: losses and returned parameters agree to 1e-9.  The JAX
package's own tests hold its 3-D-mesh runs to its one-device run at 1e-9,
so its one-device run is the reference, except where a 3-D artifact is
compared (the ``.state`` files, passed between the packages in both
directions, and the partitions' warnings); that keeps the JAX package's
3-D-mesh runs, whose collectives the 8 CPU devices rendezvous for under
XLA's 40 s termination timeout, out of the test run's load.  The ports of
``tests/test_fit_mesh.py``'s model-axis pipeline cases, the placement of
the body stacks over both axes, and the ZeRO ladder and offload on the 3-D
mesh."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensor_ops_tpu as T
import tensor_ops_tpu.parallel.ir_pipeline as JI
import tensor_ops_tpu.parallel.pipeline as JP
from tensor_ops_tpu.backend.rng import Rng as JRng
from tensor_ops_tpu.models import act_logistic as j_logistic
from tensor_ops_tpu.models import act_softmax as j_softmax
from tensor_ops_tpu.models import cross_entropy as j_xent
from tensor_ops_tpu.models import gen_net as j_gen_net
from tensor_ops_tpu.models import optim as JO
from tensor_ops_tpu.models.trainer import fit as j_fit
from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng as TRng
from tensor_ops_tpu_torch.models import act_logistic as t_logistic
from tensor_ops_tpu_torch.models import act_softmax as t_softmax
from tensor_ops_tpu_torch.models import cross_entropy as t_xent
from tensor_ops_tpu_torch.models import gen_net as t_gen_net
from tensor_ops_tpu_torch.models import optim as TO
from tensor_ops_tpu_torch.models.trainer import fit as t_fit
from tensor_ops_tpu_torch.parallel import ir_pipeline as TI
from tensor_ops_tpu_torch.parallel import pipeline as TP
from tensor_ops_tpu_torch.parallel.mesh import MODEL_AXIS, STAGE_AXIS
from tensor_ops_tpu_torch.utils.checkpoint import (load_meta,
                                                   network_from_arrays)
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-9
JB = T.JaxBackend(dtype=jnp.float64)
TB = TorchBackend(torch.float64, "cpu")

multi = pytest.mark.skipif(len(jax.devices()) < 8,
                           reason="needs the 8-device CPU mesh")


def nets(widths, seed):
    """``(jax net, port net)``: the logistic chain of ``widths`` with a
    softmax head drawn by the JAX package from ``seed``, the port's graph of
    the same chain holding its parameters."""
    hidden = widths[1:-1]
    jn = j_gen_net(JB, widths[0], widths[-1],
                   [(h, j_logistic()) for h in hidden], j_softmax(),
                   JRng(JB, seed=seed))
    tmpl = t_gen_net(TB, widths[0], widths[-1],
                     [(h, t_logistic()) for h in hidden], t_softmax(),
                     TRng(TB, 0))
    return jn, network_from_arrays(
        {f"param_{k}": np.asarray(p) for k, p in enumerate(jn.params)}, {},
        tmpl, TB)


def deep_uniform(seed):
    """9 hidden 16-wide layers: 8 identical body segments."""
    return nets((12,) + (16,) * 9 + (2,), seed)


def meshes(shape=(2, 2, 2)):
    return (JP.make_3d_pipeline_mesh(*shape),
            TP.make_3d_pipeline_mesh(*shape, devices=["cpu"] * int(
                np.prod(shape))))


def classes(n, seed):
    r = np.random.default_rng(seed)
    return r.uniform(0, 1, size=(n, 12)), np.eye(2)[r.integers(0, 2,
                                                                size=n)]


def both(pair, X, Y, shape=(2, 2, 2), opt=None, **kw):
    """The JAX package's ``fit`` on one device and the port's on the mesh
    of ``shape``."""
    _, tm = meshes(shape)
    jo = {} if opt is None else {"optimizer": getattr(JO, opt)()}
    to = {} if opt is None else {"optimizer": getattr(TO, opt)()}
    jr = j_fit(pair[0], j_xent(2), JB, X, Y, **jo, **{
        k: v for k, v in kw.items()
        if not k.startswith(("pipeline", "zero", "shard_opt", "offload"))})
    tr = t_fit(pair[1], t_xent(2), TB, X, Y, mesh=tm, **to, **kw)
    return jr, tr


def jax_warnings(pair, M):
    """The JAX package's warnings when it partitions ``pair``'s chain for
    its (2, 2, 2) mesh (its ``fit`` builds this loss first)."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        JI.make_ir_pipeline_loss(pair[0], j_xent(2), JB, meshes()[0], M)
    return [str(x.message) for x in w]


def assert_close(a, b, atol=ATOL):
    assert a.steps == b.steps
    assert len(a.history) == len(b.history)
    for ha, hb in zip(a.history, b.history):
        assert abs(ha["loss"] - hb["loss"]) <= atol, (ha, hb)
    for x, y in zip(a.net.params, b.net.params):
        if atol == 0:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        else:
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       atol=atol, rtol=0)


@multi
def test_fit_3d_mesh_tp_shards_ir_pipeline_body():
    """fit on (2, 2, 2) row-splits the staged-IR body over the model axis
    (no idle warning): its losses and parameters equal the JAX package's
    one-device run at 1e-9, and the body stacks lie over both the stage and
    the model axis."""
    X, Y = classes(64, 11)
    kw = dict(epochs=2, batch_size=16, lr=0.05, verbose=False, prefetch=0,
              log_every=1)
    pair = deep_uniform(12)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        jr, tr = both(pair, X, Y, pipeline_microbatches=4, **kw)
        assert jax_warnings(pair, 4) == []
    assert_close(tr, jr)
    _, tm = meshes()
    sp = TI.shard_pipelined_params(TI.partition_network(pair[1], 2, tm), tm)
    for x in sp.body_params:
        assert x.spec[:2] == (STAGE_AXIS, MODEL_AXIS), x.spec
        # each rank holds its stage's 4 segments, half of each's rows
        assert x.shards[0].shape[:2] == (4, 8)
        assert len({tuple(s.flatten()[:3].tolist()) for s in x.shards}) == 4


@multi
def test_fit_3d_mesh_warns_when_body_not_shardable():
    """A 15-wide body does not split over 2 model ranks: it trains with
    the model axis idle, and says so, as the JAX package does (the same
    losses)."""
    pair = nets((12, 15, 15, 15, 2), 30)
    r = np.random.default_rng(31)
    X, Y = r.uniform(0, 1, size=(32, 12)), np.eye(2)[r.integers(0, 2,
                                                                 size=32)]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        jr, tr = both(pair, X, Y, epochs=1, batch_size=16, verbose=False,
                      prefetch=0, pipeline_microbatches=4, log_every=1)
    msgs = [str(x.message) for x in w]
    assert sum("model axis will sit idle" in m for m in msgs) == 1, msgs
    assert any("model axis will sit idle" in m for m in jax_warnings(pair, 4))
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    assert_close(tr, jr)


@multi
def test_pipeline_resume_tp_change_rejected(tmp_path):
    """A hetero-tp partition holds one packed leaf, so a model-axis change
    across a resume passes the leaf count: the packed shape in the layout
    string refuses it by name (the JAX package's string)."""
    X, Y = classes(64, 71)
    ck = str(tmp_path / "tpchange.npz")
    kw = dict(batch_size=16, lr=0.05, verbose=False, prefetch=0,
              pipeline_microbatches=2)
    _, tn = nets((12, 16, 8, 2), 72)
    t_fit(tn, t_xent(2), TB, X, Y, epochs=1, mesh=meshes()[1],
          checkpoint_path=ck, checkpoint_every=2, **kw)
    part = TI.partition_network(tn, 2, meshes()[1])
    assert isinstance(part, TI.HeteroTpPipelinedNetwork)
    assert load_meta(ck + ".state")["layout"] == (
        f"pipeline:gpipe:S2:P2x2x{part.lmax}")
    with pytest.raises(ValueError, match="layout"):
        t_fit(tn, t_xent(2), TB, X, Y, epochs=2,
              mesh=meshes((4, 2, 1))[1], checkpoint_path=ck,
              checkpoint_every=2, resume=True, **kw)


@multi
def test_hetero_3d_mesh_warns_idle_model_axis():
    """Widths that do not divide the model axis (12->9->6->2) fall back to
    the model-replicated heterogeneous cut, with the warning (the JAX
    package's partition warns too); the losses equal the JAX package's
    one-device run."""
    pair = nets((12, 9, 6, 2), 45)
    r = np.random.default_rng(46)
    X, Y = r.uniform(0, 1, size=(32, 12)), np.eye(2)[r.integers(0, 2,
                                                                 size=32)]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        jr, tr = both(pair, X, Y, epochs=1, batch_size=16, verbose=False,
                      prefetch=0, pipeline_microbatches=4, log_every=1)
    assert sum("model axis" in str(x.message) for x in w) == 1
    assert any("model axis" in m for m in jax_warnings(pair, 4))
    assert_close(tr, jr)


# name: (chain, fit options); each against the JAX package's one-device run
ZERO = {
    "zero1": (deep_uniform, dict(shard_opt_state=True)),
    "zero2": (deep_uniform, dict(zero_stage=2)),
    "zero3": (deep_uniform, dict(zero_stage=3)),
    "hetero tp zero3 + offload": (lambda s: nets((12, 16, 8, 2), s),
                                  dict(zero_stage=3, offload_opt_state=True)),
}


@multi
@pytest.mark.parametrize("name", list(ZERO))
def test_fit_3d_mesh_zero_ladder(name):
    """The ZeRO rungs and offload on (2, 2, 2): adam's losses and
    parameters equal the JAX package's one-device run at 1e-9."""
    chain, zkw = ZERO[name]
    X, Y = classes(64, 17)
    jr, tr = both(chain(18), X, Y, opt="adam", epochs=1, batch_size=16,
                  lr=0.01, verbose=False, prefetch=0, log_every=1,
                  pipeline_microbatches=2, **zkw)
    assert_close(tr, jr)


@multi
@pytest.mark.parametrize("chain", ["uniform", "hetero tp"])
def test_state_files_resume_across_packages(tmp_path, chain):
    """An epoch's ``.state`` file of either package, on (2, 2, 2), resumes
    in the other to the same second epoch (1e-9)."""
    pair = deep_uniform(21) if chain == "uniform" else nets((12, 16, 8, 2),
                                                            22)
    X, Y = classes(64, 23)
    jm, tm = meshes()
    kw = dict(batch_size=16, lr=0.01, verbose=False, prefetch=0,
              pipeline_microbatches=2, checkpoint_every=4)
    ckj, ckt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j_fit(pair[0], j_xent(2), JB, X, Y, epochs=1, mesh=jm,
          optimizer=JO.adam(), checkpoint_path=ckj, **kw)
    t_fit(pair[1], t_xent(2), TB, X, Y, epochs=1, mesh=tm,
          optimizer=TO.adam(), checkpoint_path=ckt, **kw)
    assert load_meta(ckj + ".state")["layout"] == \
        load_meta(ckt + ".state")["layout"]
    jr = j_fit(pair[0], j_xent(2), JB, X, Y, epochs=2, mesh=jm,
               optimizer=JO.adam(), checkpoint_path=ckt, resume=True, **kw)
    tr = t_fit(pair[1], t_xent(2), TB, X, Y, epochs=2, mesh=tm,
               optimizer=TO.adam(), checkpoint_path=ckj, resume=True, **kw)
    assert tr.steps == jr.steps == 8
    for a, b in zip(tr.net.params, jr.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                                   rtol=0)


@multi
@pytest.mark.parametrize("chain", ["tp body", "idle model axis"])
def test_fit_3d_mesh_clip_norm(chain):
    """``clip_norm`` on (2, 2, 2) counts each gradient block once: with the
    body row-split over the model axis, and with a chain the model axis
    leaves idle (its stage leaves whole on both model ranks); adam's
    losses and parameters equal the JAX package's one-device run at
    1e-9."""
    pair = deep_uniform(51) if chain == "tp body" else nets(
        (12, 15, 15, 15, 2), 52)
    X, Y = classes(64, 53)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jr, tr = both(pair, X, Y, opt="adam", epochs=1, batch_size=16,
                      lr=0.05, verbose=False, prefetch=0, log_every=1,
                      pipeline_microbatches=2, clip_norm=0.05)
    assert_close(tr, jr)
