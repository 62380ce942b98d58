"""The port's ``fit`` against the JAX package's, on the CPU in f64.

A 12-8-4 network is built once by the JAX package and its parameters are
copied into the port's graph; both packages train it on the same numpy
data with the same loader seed.  History (steps, epochs, losses to 1e-9,
validation accuracy exactly, validation loss to 1e-9) and the final
parameters (1e-9) must agree, as the JAX package's own trainer tests hold
its backends (``tests/test_trainer.py``).  The crash/resume property is
bit-exact on both of the port's backends, and ``.state`` files pass
between the packages."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensor_ops_tpu as T
from tensor_ops_tpu.backend.rng import Rng as JRng
from tensor_ops_tpu.models import act_logistic as j_logistic
from tensor_ops_tpu.models import act_softmax as j_softmax
from tensor_ops_tpu.models import cross_entropy as j_xent
from tensor_ops_tpu.models import gen_net as j_gen_net
from tensor_ops_tpu.models import optim as JO
from tensor_ops_tpu.models.feedforward import Network as JNetwork
from tensor_ops_tpu.models.trainer import fit as j_fit
from tensor_ops_tpu.utils import checkpoint as JC
from tensor_ops_tpu_torch import NumpyBackend, TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng as TRng
from tensor_ops_tpu_torch.models import Network
from tensor_ops_tpu_torch.models import act_logistic as t_logistic
from tensor_ops_tpu_torch.models import act_softmax as t_softmax
from tensor_ops_tpu_torch.models import cross_entropy as t_xent
from tensor_ops_tpu_torch.models import gen_net as t_gen_net
from tensor_ops_tpu_torch.models import optim as TO
from tensor_ops_tpu_torch.models.trainer import fit as t_fit
from tensor_ops_tpu_torch.utils import checkpoint as TC
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-9
I, H, O = 12, 8, 4
JB = T.JaxBackend(dtype=jnp.float64)
JNB = T.NumpyBackend()
TB = TorchBackend(torch.float64, "cpu")
TNB = NumpyBackend()


def data(n, seed):
    r = np.random.default_rng(seed)
    X = r.uniform(-1, 1, size=(n, I))
    labels = (X[:, :O] > 0).sum(axis=1) % O
    return X, np.eye(O)[labels], labels


def jnet(be, seed=0):
    return j_gen_net(be, I, O, [(H, j_logistic())], j_softmax(),
                     JRng(JB, seed=seed))


def tnet(be, params):
    """The port's 12-8-4 graph holding ``params`` (numpy arrays) on ``be``."""
    tmpl = t_gen_net(TB, I, O, [(H, t_logistic())], t_softmax(), TRng(TB, 0))
    return Network(tmpl.op, tuple(be.asarray(np.asarray(p)) for p in params),
                   tmpl.act_names)


def host(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def same_history(got, want, atol=ATOL):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["step"], g["epoch"]) == (w["step"], w["epoch"])
        assert abs(g["loss"] - w["loss"]) <= atol
        assert set(g) == set(w)
        if "val_acc" in w:
            assert g["val_acc"] == w["val_acc"]
        if "val_loss" in w:
            assert abs(g["val_loss"] - w["val_loss"]) <= atol


def same_params(got, want, atol=ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(host(g), host(w), rtol=0, atol=atol)


# (name, port optimizer, JAX optimizer, keyword arguments of both fits);
# X has 70 rows: 5 steps an epoch at batch 16, the last one ragged
CASES = {
    "sgd": (TO.sgd, JO.sgd, dict(lr=0.5)),
    "momentum+clip": (lambda: TO.momentum(0.8), lambda: JO.momentum(0.8),
                      dict(lr=0.2, clip_norm=0.3)),
    "adam+cosine": (TO.adam, JO.adam,
                    dict(lr=0.05, lr_schedule=("cosine", 0.05, 15))),
    "adamw+clip+cosine": (lambda: TO.adamw(weight_decay=0.1),
                          lambda: JO.adamw(weight_decay=0.1),
                          dict(lr=0.05, clip_norm=0.5,
                               lr_schedule=("cosine", 0.05, 15))),
    "adam+val_acc+early_stop": (TO.adam, JO.adam,
                                dict(lr=0.05, val="accuracy",
                                     early_stop_patience=2)),
    "sgd+val_loss+early_stop": (TO.sgd, JO.sgd,
                                dict(lr=2.0, val="loss",
                                     early_stop_patience=1)),
}


def fit_both(case, t_be, j_be, epochs=3, log_every=1):
    t_opt, j_opt, kw = CASES[case]
    X, Y, _ = data(70, 1)
    Xv, Yv, Lv = data(30, 2)
    common = dict(epochs=epochs, batch_size=16, seed=3, log_every=log_every,
                  verbose=False)
    out = {}
    jn = jnet(JB)
    for package, be, fit, opts in (("j", j_be, j_fit, JO),
                                   ("t", t_be, t_fit, TO)):
        args = dict(common, lr=kw["lr"])
        if "clip_norm" in kw:
            args["clip_norm"] = kw["clip_norm"]
        if "lr_schedule" in kw:
            _, base, steps = kw["lr_schedule"]
            args["lr_schedule"] = opts.cosine_schedule(base, steps)
        if "val" in kw:
            args["val_metric"] = kw["val"]
            args["val"] = (Xv, Lv if kw["val"] == "accuracy" else Yv)
            args["early_stop_patience"] = kw["early_stop_patience"]
        if package == "j":
            net = JNetwork(jn.op, tuple(be.asarray(np.asarray(p))
                                        for p in jn.params), jn.act_names)
            res = fit(net, j_xent(O), be, X, Y, optimizer=j_opt(), **args)
        else:
            res = fit(tnet(be, jn.params), t_xent(O), be, X, Y,
                      optimizer=t_opt(), **args)
        out[package] = res
    return out["t"], out["j"]


@pytest.mark.parametrize("case", list(CASES))
def test_fit_matches_jax_fit(case):
    """The port's fit on TorchBackend(f64, cpu) against the JAX fit on its
    f64 backend (chained by default: the JAX package's chained run equals
    its unchained one exactly)."""
    t, j = fit_both(case, TB, JB)
    assert t.steps == j.steps
    same_history(t.history, j.history)
    same_params(t.net.params, j.net.params)
    if "early_stop" in case:
        assert t.steps < 15  # the early stop fired (at the same step)


@pytest.mark.parametrize("case", ["sgd", "adamw+clip+cosine",
                                  "sgd+val_loss+early_stop"])
def test_fit_numpy_backend_matches_jax_numpy_backend(case):
    """The port's NumPy oracle against the JAX package's, both looping
    over the samples of each batch."""
    t, j = fit_both(case, TNB, JNB, epochs=2, log_every=2)
    assert t.steps == j.steps
    same_history(t.history, j.history)
    same_params(t.net.params, j.net.params)
    assert all(isinstance(p, np.ndarray) for p in t.net.params)


@pytest.mark.parametrize("cfg", [
    # (n_rows, batch, epochs, crash_epochs, optimizer)
    (96, 32, 3, 1, "adam"),
    (100, 32, 4, 2, "sgd"),       # ragged last batch (4 rows)
    (64, 16, 5, 3, "momentum"),
    (80, 40, 2, 1, "adam"),
])
@pytest.mark.parametrize("be", [TB, TNB], ids=["torch", "numpy"])
def test_fit_resume_equivalence_property(tmp_path, cfg, be):
    """For any (dataset size, batch, budget, crash point, optimizer), the
    crash/resume chain equals the uninterrupted run bit for bit (the JAX
    package's property, ``tests/test_trainer.py``)."""
    n_rows, batch, epochs, crash, opt_name = cfg
    opts = {"adam": TO.adam, "sgd": TO.sgd, "momentum": TO.momentum}
    X, Y, _ = data(n_rows, n_rows)
    params = jnet(JNB, seed=1).params
    ck = str(tmp_path / f"p{n_rows}.npz")
    kw = dict(batch_size=batch, lr=0.05, verbose=False)
    if be is TNB:
        kw["log_every"] = 1000  # the oracle is slow: log only step 1
    t_fit(tnet(be, params), t_xent(O), be, X, Y, epochs=crash,
          optimizer=opts[opt_name](), checkpoint_path=ck, checkpoint_every=1,
          **kw)
    resumed = t_fit(tnet(be, jnet(JNB, seed=77).params), t_xent(O), be, X,
                    Y, epochs=epochs, optimizer=opts[opt_name](),
                    checkpoint_path=ck, checkpoint_every=1, resume=True, **kw)
    straight = t_fit(tnet(be, params), t_xent(O), be, X, Y, epochs=epochs,
                     optimizer=opts[opt_name](), **kw)
    assert resumed.steps == straight.steps == epochs * (-(-n_rows // batch))
    for a, b in zip(resumed.net.params, straight.net.params):
        np.testing.assert_array_equal(host(a), host(b))


def test_jax_state_resumes_in_the_port(tmp_path):
    """A ``.state`` written by the JAX fit (adam, at the end of epoch 1)
    resumes in the port's fit, which ends within 1e-9 of the JAX straight
    2-epoch run."""
    X, Y, _ = data(70, 1)
    jn = jnet(JB, seed=4)
    ck = str(tmp_path / "j.npz")
    kw = dict(batch_size=16, lr=0.05, seed=5, verbose=False)
    j_fit(jn, j_xent(O), JB, X, Y, epochs=1, optimizer=JO.adam(),
          checkpoint_path=ck, checkpoint_every=5, **kw)
    straight = j_fit(jn, j_xent(O), JB, X, Y, epochs=2, optimizer=JO.adam(),
                     **kw)
    resumed = t_fit(tnet(TB, jnet(JB, seed=9).params), t_xent(O), TB, X, Y,
                    epochs=2, optimizer=TO.adam(), checkpoint_path=ck,
                    resume=True, **kw)
    assert resumed.steps == straight.steps == 10
    assert resumed.history[0]["step"] == 6
    same_params(resumed.net.params, straight.net.params)


def test_port_state_loads_in_jax(tmp_path):
    """A ``.state`` written by the port's fit loads through the JAX
    ``load_train_state`` into a JAX adam state: same step, same leaves, the
    step count an int, and the same optimizer key."""
    X, Y, _ = data(70, 1)
    jn = jnet(JB, seed=4)
    ck = str(tmp_path / "t.npz")
    res = t_fit(tnet(TB, jn.params), t_xent(O), TB, X, Y, epochs=1,
                batch_size=16, lr=0.05, optimizer=TO.adam(),
                checkpoint_path=ck, checkpoint_every=5, verbose=False)
    opt = JO.adam()
    params, (t, m, v), step = JC.load_train_state(
        ck + ".state", opt.init(jn.params), opt_key=opt.struct_key(),
        expect_meta={"layout": "flat"})
    assert step == 5 and t == 5 and isinstance(t, int)
    same_params(params, res.net.params, atol=0)
    assert len(m) == len(v) == len(jn.params)
    meta = JC.load_meta(ck + ".state")
    assert json.loads(meta["opt_key"]) == json.loads(
        json.dumps(TO.adam().struct_key()))
    with pytest.raises(ValueError, match="optimizer mismatch"):
        JC.load_train_state(ck + ".state", opt.init(jn.params),
                            opt_key=JO.adam(b1=0.5).struct_key())


@pytest.mark.parametrize("template_of", [
    lambda p: torch.as_tensor(p, dtype=torch.float32),
    lambda p: np.asarray(p, dtype=np.float64)], ids=["torch_f32", "numpy"])
def test_load_train_state_restores_onto_the_template(tmp_path, template_of):
    """The port's ``load_train_state`` gives each optimizer leaf the
    template leaf's type, dtype and device (adam's step the template's: a
    0-d int32 tensor beside tensor parameters, an int beside NumPy ones),
    with the values of a JAX-written file."""
    X, Y, _ = data(70, 1)
    jn = jnet(JB, seed=4)
    ck = str(tmp_path / "j.npz")
    j_fit(jn, j_xent(O), JB, X, Y, epochs=1, batch_size=16, lr=0.05,
          optimizer=JO.adam(), checkpoint_path=ck, checkpoint_every=5,
          verbose=False)
    opt = TO.adam()
    template = opt.init(tuple(template_of(np.array(p)) for p in jn.params))
    _, (t, m, v), step = TC.load_train_state(
        ck + ".state", template, opt_key=opt.struct_key(),
        expect_meta={"layout": "flat"})
    _, (_, jm, jv), _ = JC.load_train_state(ck + ".state",
                                            JO.adam().init(jn.params))
    assert step == int(t) == 5 and type(t) is type(template[0])
    if isinstance(t, torch.Tensor):
        assert t.dtype == template[0].dtype == torch.int32 and t.ndim == 0
    for got, want, tmpl in zip(m + v, jm + jv, template[1] + template[2]):
        assert type(got) is type(tmpl) and got.dtype == tmpl.dtype
        np.testing.assert_array_equal(
            np.asarray(got), np.asarray(want).astype(np.asarray(got).dtype))


def test_prefetch_is_identical_to_no_prefetch():
    X, Y, _ = data(70, 1)
    params = jnet(JNB, seed=2).params
    # chain_steps=1: a chained run gathers its batches on the device and
    # builds no prefetcher
    runs = [t_fit(tnet(TB, params), t_xent(O), TB, X, Y, epochs=2,
                  batch_size=16, lr=0.3, log_every=1, prefetch=depth,
                  chain_steps=1, verbose=False) for depth in (2, 0)]
    assert [h["loss"] for h in runs[0].history] == \
        [h["loss"] for h in runs[1].history]
    for a, b in zip(runs[0].net.params, runs[1].net.params):
        assert torch.equal(a, b)


ACCEPTED = [dict(mixed_precision=True), dict(mixed_precision="bf16"),
            dict(chain_steps=4), dict(chain_shuffle="device")]


def _option_id(kw):
    return next(iter(kw)) + "=" + str(next(iter(kw.values())))


@pytest.mark.parametrize("kw", ACCEPTED, ids=[_option_id(k) for k in ACCEPTED])
def test_ported_options_train(kw):
    """The options ROADMAP items 5 and 6 ported (mixed precision, chained
    steps, the device shuffle) run and train."""
    X, Y, _ = data(80, 1)
    res = t_fit(tnet(TB, jnet(JNB).params), t_xent(O), TB, X, Y, epochs=4,
                batch_size=20, lr=0.5, log_every=4, verbose=False, **kw)
    assert res.steps == 16
    assert res.history[-1]["loss"] < res.history[0]["loss"]


def _cpu_mesh(n, shape=None):
    from tensor_ops_tpu_torch.parallel import make_mesh

    return make_mesh(n, shape=shape, devices=["cpu"] * n)


def _StageMesh(tp=1):
    """A pipeline mesh: a stage axis (``parallel.pipeline``), with a model
    axis of ``tp``."""
    from tensor_ops_tpu_torch.parallel.pipeline import make_3d_pipeline_mesh

    return make_3d_pipeline_mesh(1, 2, tp, devices=["cpu"] * 2 * tp)


# the options once refused (naming their ROADMAP item) and the JAX
# package's own checks of the mesh and ZeRO options
REFUSED = [
    # a trace of steps 2-5 (refused before the tooling was ported; it
    # trains now, item None: tests/test_torch_profiling.py checks the trace)
    ("profile_dir=prof", dict(profile_dir="prof"), None),
    # make_mesh(4) is (1, 4): a model axis, refused before the model axis
    # was ported; it trains now (item None)
    ("mesh=a mesh", dict(mesh=_cpu_mesh(4)), None),
    # a stage axis trains pipeline-parallel (item None), and beside a model
    # axis larger than 1 too (the tensor-parallel pipelines, refused before
    # they were ported)
    ("mesh=a stage axis", dict(mesh=_StageMesh()), None),
    ("mesh=a stage axis and a model axis", dict(mesh=_StageMesh(2)), None),
    ("shard_opt_state=True", dict(shard_opt_state=True),
     r"ZeRO-1 \(shard_opt_state/zero_stage\) shards over the mesh's data"),
    ("zero_stage=2", dict(zero_stage=2),
     r"ZeRO-2 \(shard_opt_state/zero_stage\) shards over the mesh's data"),
    ("mesh=batch over 3 ranks", dict(mesh=_cpu_mesh(3, (3, 1))),
     r"batch_size \(20\) must be divisible by the data-axis size \(3\)"),
    # without a stage axis the pipeline options are unused, as in the JAX
    # package (they were refused before the pipelines were ported)
    ("pipeline_microbatches=4", dict(pipeline_microbatches=4), None),
    ("pipeline_schedule=gpipe", dict(pipeline_schedule="gpipe"), None),
    ("pipeline_chunks=2", dict(pipeline_chunks=2), None),
]


@pytest.mark.parametrize("kw,item", [r[1:] for r in REFUSED],
                         ids=[r[0] for r in REFUSED])
def test_unported_options_raise(kw, item, tmp_path, monkeypatch):
    """The mesh and ZeRO options raise the JAX package's messages where the
    configuration is wrong (ZeRO without a mesh, a batch that does not
    split over the data ranks).  A mesh with a model axis, a stage axis or
    both, the pipeline options and ``profile_dir``, once refused here
    naming their ROADMAP item, train (``item`` None): a mesh's leaves come
    back Sharded, a pipeline's as the parameter stack."""
    X, Y, _ = data(20, 1)
    monkeypatch.chdir(tmp_path)  # a relative profile_dir lands there
    if item is None:
        res = t_fit(tnet(TB, jnet(JNB).params), t_xent(O), TB, X, Y,
                    verbose=False, batch_size=20, epochs=3, lr=0.5,
                    log_every=1, **kw)
        mesh = kw.get("mesh")
        sharded = mesh is not None and "stage" not in mesh.axis_names
        assert res.steps == 3 and all(hasattr(p, "spec") == sharded
                                      for p in res.net.params)
        assert res.history[-1]["loss"] < res.history[0]["loss"]
        return
    with pytest.raises(ValueError, match=item):
        t_fit(tnet(TB, jnet(JNB).params), t_xent(O), TB, X, Y, verbose=False,
              batch_size=20, **kw)


def test_option_values_checked_as_jax_does():
    X, Y, _ = data(20, 1)
    net = tnet(TB, jnet(JNB).params)
    for kw, msg in ((dict(accum_steps=0), "accum_steps"),
                    (dict(chain_steps=0), "chain_steps"),
                    (dict(val_metric="f1", val=(X, Y)), "val_metric"),
                    (dict(early_stop_patience=2), "early_stop_patience")):
        with pytest.raises(ValueError, match=msg):
            t_fit(net, t_xent(O), TB, X, Y, verbose=False, **kw)
    # chain_steps=1 runs one step at a time, "auto" chains the windows
    for chain in (1, "auto"):
        res = t_fit(net, t_xent(O), TB, X, Y, batch_size=10, chain_steps=chain,
                    verbose=False)
        assert res.steps == 2


def test_cuda_backend_raises_without_a_card():
    """A TorchBackend on cuda where no card is present raises; fit never
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    X, Y, _ = data(20, 1)
    cuda = TorchBackend(torch.float32, "cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        tnet(cuda, jnet(JNB).params)
    # a network on the CPU handed to a cuda backend: the first batch's
    # move to the card raises, with and without the prefetcher (which
    # only an unchained run builds)
    for depth in (2, 0):
        with pytest.raises((RuntimeError, AssertionError)):
            t_fit(tnet(TB, jnet(JNB).params), t_xent(O), cuda, X, Y,
                  prefetch=depth, chain_steps=1, verbose=False)


def test_metrics_and_checkpoints_written(tmp_path):
    """The JSONL record holds one line per history entry, and the servable
    checkpoint loads through the JAX package's ``load_network``."""
    X, Y, L = data(70, 1)
    mp, ck = str(tmp_path / "m.jsonl"), str(tmp_path / "c.npz")
    jn = jnet(JB, seed=6)
    res = t_fit(tnet(TB, jn.params), t_xent(O), TB, X, Y, epochs=2,
                batch_size=16, lr=0.3, val=(X, L), log_every=2,
                metrics_path=mp, checkpoint_path=ck, checkpoint_every=5,
                verbose=False)
    recs = [json.loads(line) for line in open(mp)]
    assert [r["step"] for r in recs] == [h["step"] for h in res.history] == \
        [1, 2, 4, 6, 8, 10]
    assert all("val_acc" in r for r in recs)
    back = JC.load_network(ck, jn, JB)
    same_params(back.params, res.net.params, atol=0)
    assert TC.load_meta(ck + ".state")["step"] == 10
