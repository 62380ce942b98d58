"""The port's pipelines (``tensor_ops_tpu_torch.parallel.pipeline``) against
the JAX package's, on the CPU.

Each case builds one ``PipelineMLP`` in numpy, runs it through the JAX
function on the conftest's 8 CPU devices and through the port on
``["cpu"] * n`` ranks.  The JAX pipelines compute their products with
``preferred_element_type=float32`` (``pipeline.py:124-125,139-140,
187-192``): fed f64 arrays they still round each product to f32 (1.25e-8
from an f64 chain), so the two packages are compared in f32 at the JAX
tests' own bounds (1e-6 forward, 1e-5 after a step), and the port's f64
run is held to its own sequential net (torch autograd in f64) at 1e-9.
The ports of ``tests/test_pipeline.py``, ``tests/test_utils.py``'s pipeline
checkpoint and ``tests/test_fuzz.py``'s pipeline fuzz are here, with
kernel 9's calls per forward and per step against the schedule's
prediction."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensor_ops_tpu.parallel.pipeline as JP
from tensor_ops_tpu.utils import checkpoint as JC
from tensor_ops_tpu_torch.parallel import collective_kernels as CK
from tensor_ops_tpu_torch.parallel import pipeline as TP
from tensor_ops_tpu_torch.utils import checkpoint as TC
from torch_threads import one_torch_thread  # noqa: F401

TOL_FWD, TOL_STEP, TOL_F64 = 1e-6, 1e-5, 1e-9

multi = pytest.mark.skipif(len(jax.devices()) < 8,
                           reason="needs the 8-device CPU mesh")

J_MESH = {1: JP.make_pipeline_mesh, 2: JP.make_dp_pipeline_mesh,
          3: JP.make_3d_pipeline_mesh}
T_MESH = {1: TP.make_pipeline_mesh, 2: TP.make_dp_pipeline_mesh,
          3: TP.make_3d_pipeline_mesh}


def arrays(i, h, o, n_stages, L, seed, scale=0.5):
    """A PipelineMLP's six arrays in f64, drawn as ``PipelineMLP.init``
    draws them (biases small and nonzero, so their gradients show)."""
    r = np.random.default_rng(seed)
    return (scale * r.normal(size=(h, i)), 0.1 * r.normal(size=h),
            scale / np.sqrt(h) * r.normal(size=(n_stages, L, h, h)),
            0.1 * r.normal(size=(n_stages, L, h)),
            scale * r.normal(size=(o, h)), 0.1 * r.normal(size=o))


def batch(B, i, o, seed):
    r = np.random.default_rng(seed)
    return r.uniform(size=(B, i)), np.eye(o)[np.arange(B) % o]


def tmesh(shape):
    return T_MESH[len(shape)](*shape, devices=["cpu"] * int(np.prod(shape)))


def f32(xs):
    return [np.asarray(x, np.float32) for x in xs]


def seq_loss_t(ps, xb, yb=None):
    """The plain chain in torch (the port's own sequential net): the softmax
    output, or the loss when ``yb`` is given."""
    w_in, b_in, ws, bs, w_out, b_out = ps
    h = torch.sigmoid(xb @ w_in.T + b_in)
    for s in range(ws.shape[0]):
        for k in range(ws.shape[1]):
            h = torch.sigmoid(h @ ws[s, k].T + bs[s, k])
    p = torch.softmax(h @ w_out.T + b_out, dim=-1)
    if yb is None:
        return p
    return -torch.mean(torch.sum(yb * torch.log(p + 1e-30), dim=-1))


def seq_step_t(a, xb, yb, lr):
    """One SGD step of the sequential chain in f64 autograd."""
    ps = [torch.tensor(x, requires_grad=True) for x in a]
    loss = seq_loss_t(ps, torch.tensor(xb), torch.tensor(yb))
    gs = torch.autograd.grad(loss, ps)
    return float(loss.detach()), [(p - lr * g).detach().numpy()
                                  for p, g in zip(ps, gs)]


def jax_run(kind, shape, a, xb, yb, M, lr=1.0):
    """The JAX package's forward and one step (in f32)."""
    mesh = J_MESH[len(shape)](*shape)
    model = JP.PipelineMLP(*(jnp.asarray(x) for x in f32(a)))
    x, y = jnp.asarray(np.float32(xb)), jnp.asarray(np.float32(yb))
    if kind == "gpipe":
        m = JP.shard_pipeline_model(model, mesh)
        fwd = JP.pipeline_forward(m, mesh, x, M)
        v, new = JP.pipeline_train_step(m, mesh, M)(lr, x, y, *m.params())
    else:
        m = JP.shard_circular_model(model, mesh)
        fwd = JP.circular_pipeline_forward(m, mesh, x, M)
        v, new = JP.circular_pipeline_train_step(m, mesh, M)(
            lr, x, y, *m.params())
    return np.asarray(fwd), float(v), [np.asarray(p) for p in new]


def port_run(kind, shape, a, xb, yb, M, dtype, lr=1.0):
    """The port's forward and one step on CPU ranks, the arrays ``a`` and
    the batch in ``dtype``; the new parameters whole on the host (the
    circular layout interleaved)."""
    mesh = tmesh(shape)
    model = TP.PipelineMLP.from_arrays(*a, device="cpu")
    x, y = torch.tensor(xb, dtype=dtype), torch.tensor(yb, dtype=dtype)
    if kind == "gpipe":
        m = TP.shard_pipeline_model(model, mesh)
        fwd = TP.pipeline_forward(m, mesh, x, M)
        v, new = TP.pipeline_train_step(m, mesh, M)(lr, x, y, *m.params())
    else:
        m = TP.shard_circular_model(model, mesh)
        fwd = TP.circular_pipeline_forward(m, mesh, x, M)
        v, new = TP.circular_pipeline_train_step(m, mesh, M)(
            lr, x, y, *m.params())
    return fwd.numpy(), float(v), [np.asarray(p) for p in new]


def interleave(ps, kind, S):
    """Sequential-layout parameters in the circular layout."""
    if kind == "gpipe":
        return ps
    return [TP._interleave_chunks(p, S) if i in (2, 3) else p
            for i, p in enumerate(ps)]


# (name, schedule, mesh shape, n_stages, layers a stage, M, B): the cases
# of tests/test_pipeline.py (:36, :73, :98, :128, :158, :206, :254)
CASES = [
    ("gpipe_1d", "gpipe", (4,), 4, 2, 4, 8),
    ("gpipe_grad_1d", "gpipe", (4,), 4, 1, 4, 8),
    ("dp_pp_2d", "gpipe", (2, 4), 4, 1, 4, 16),
    ("dp_pp_tp_3d", "gpipe", (2, 2, 2), 2, 2, 2, 8),
    ("circular_1d", "circular", (4,), 8, 1, 4, 8),
    ("circular_tp_3d", "circular", (2, 2, 2), 4, 1, 2, 8),
    ("circular_fifo", "circular", (4,), 8, 1, 8, 16),
]


@multi
@pytest.mark.parametrize("name,kind,shape,n,L,M,B", CASES,
                         ids=[c[0] for c in CASES])
def test_pipeline_matches_jax_and_the_sequential_chain(name, kind, shape, n,
                                                       L, M, B):
    """Forward and one SGD step (lr 1.0) of each mesh form: the port in f32
    against the JAX package (1e-6 forward, 1e-5 loss and parameters), and
    the port in f64 against its own sequential chain (1e-9)."""
    i, h, o = 4, 8, 3
    a = arrays(i, h, o, n, L, seed=len(name))
    xb, yb = batch(B, i, o, seed=B + n)
    S = shape[1] if len(shape) > 1 else shape[0]

    jf, jv, jnew = jax_run(kind, shape, a, xb, yb, M)
    tf, tv, tnew = port_run(kind, shape, f32(a), xb, yb, M, torch.float32)
    np.testing.assert_allclose(tf, jf, atol=TOL_FWD, rtol=0)
    assert abs(tv - jv) <= TOL_STEP
    for p, q in zip(tnew, jnew):
        np.testing.assert_allclose(p, q, atol=TOL_STEP, rtol=0)

    df, dv, dnew = port_run(kind, shape, a, xb, yb, M, torch.float64)
    want = seq_loss_t([torch.tensor(x) for x in a], torch.tensor(xb))
    np.testing.assert_allclose(df, want.numpy(), atol=TOL_F64, rtol=0)
    sv, snew = seq_step_t(a, xb, yb, 1.0)
    assert abs(dv - sv) <= TOL_F64
    for p, q in zip(dnew, interleave(snew, kind, S)):
        np.testing.assert_allclose(p, q, atol=TOL_F64, rtol=0)


def _counted(fn):
    """``fn()`` with kernel 9's calls of more than one rank (what launches
    on a card) counted by phase."""
    seen = collections.Counter()
    real = CK._collective

    def spy(xs, phase, *a, **k):
        if len(xs) > 1:
            seen[phase] += 1
        return real(xs, phase, *a, **k)

    CK._collective = spy
    try:
        fn()
    finally:
        CK._collective = real
    return {p: seen[p] for p in ("ar", "rs", "ag")}


def predicted(shape, n, L, M, train):
    """Kernel 9's calls the schedule makes: an all-gather over the model
    group after each layer of each valid tick (and its reduce-scatter in
    the backward), the stage psum on each (data, model) group (and its
    transpose on the one group of each data group whose output feeds the
    loss: autograd runs no backward for an unused output), the rows gathered over the data groups (forward) or the
    loss summed over them (step), and each leaf's gradient summed over the
    ranks that hold it: the projections over every rank, the stage arrays
    over the data axis."""
    dims = dict(zip({1: ("stage",), 2: ("data", "stage"),
                     3: ("data", "stage", "model")}[len(shape)], shape))
    dp, S, tp = dims.get("data", 1), dims["stage"], dims.get("model", 1)
    gathers = dp * n * M * L if tp > 1 else 0  # S stages x V chunks = n
    psums = dp * tp if S > 1 else 0
    if not train:
        return {"ar": psums, "rs": 0, "ag": gathers + (dp > 1)}
    grads = 4 * (dp * S * tp > 1) + (2 * S * tp if dp > 1 else 0)
    return {"ar": psums + (dp if S > 1 else 0) + (dp > 1) + grads,
            "rs": gathers, "ag": gathers}


@pytest.mark.parametrize("name,kind,shape,n,L,M,B", CASES,
                         ids=[c[0] for c in CASES])
def test_kernel9_calls_per_forward_and_step(name, kind, shape, n, L, M, B):
    """The schedule's collectives, counted: each forward and each step
    makes exactly the kernel-9 calls :func:`predicted` derives."""
    a = f32(arrays(4, 8, 3, n, L, seed=1))
    xb, yb = batch(B, 4, 3, seed=2)
    got_f = _counted(lambda: port_run(kind, shape, a, xb, yb, M,
                                      torch.float32))
    want_f = predicted(shape, n, L, M, False)
    want_s = predicted(shape, n, L, M, True)
    assert got_f == {p: want_f[p] + want_s[p] for p in want_f}, (got_f,
                                                                  want_f,
                                                                  want_s)


@multi
def test_pipeline_training_converges():
    """The port of ``test_pipeline.py:48``: 300 SGD steps (lr 1.0) on
    (4,), 4 stages of 1 layer at scale 4, converge below a tenth of the
    first loss; the first step equals the JAX package's."""
    mesh = tmesh((4,))
    a = f32(arrays(4, 16, 2, 4, 1, seed=2, scale=4.0))
    r = np.random.default_rng(0)
    X = r.uniform(-1, 1, size=(64, 4)).astype(np.float32)
    Y = np.eye(2, dtype=np.float32)[(X[:, 0] > 0).astype(int)]
    model = TP.shard_pipeline_model(
        TP.PipelineMLP.from_arrays(*a, device="cpu"), mesh)
    step = TP.pipeline_train_step(model, mesh, n_microbatches=4)
    xb, yb = torch.tensor(X), torch.tensor(Y)
    params = model.params()
    losses = []
    for _ in range(301):
        v, params = step(1.0, xb, yb, *params)
        losses.append(float(v))
    _, jv, _ = jax_run("gpipe", (4,), a, X, Y, 4)
    assert abs(losses[0] - jv) <= TOL_STEP
    assert losses[-1] < 0.1 * losses[0], losses[:3] + losses[-3:]


@multi
def test_circular_schedule_guards():
    """``test_pipeline.py:301``: the same errors as the JAX package."""
    jmesh, mesh = JP.make_pipeline_mesh(4), tmesh((4,))
    for P, m, key in ((TP, mesh, "port"), (JP, jmesh, "jax")):
        good = P.PipelineMLP(*(jnp.asarray(x) if key == "jax"
                               else torch.tensor(x) for x in
                               f32(arrays(4, 8, 2, 8, 1, seed=11))))
        cm = P.shard_circular_model(good, m)
        with pytest.raises(ValueError, match="n_microbatches"):
            P.circular_pipeline_train_step(cm, m, n_microbatches=2)
        bad = P.PipelineMLP(*(jnp.asarray(x) if key == "jax"
                              else torch.tensor(x) for x in
                              f32(arrays(4, 8, 2, 6, 1, seed=12))))
        with pytest.raises(ValueError, match="divisible"):
            P.shard_circular_model(bad, m)


@multi
@pytest.mark.parametrize("seed", range(4))
def test_random_pipeline_configs(seed):
    """``test_fuzz.py:186``: random (S, V, M, layers a stage, width, batch)
    circular and GPipe configurations; the port's forward equals the JAX
    package's (1e-6, f32) and its f64 forward the sequential chain
    (1e-9)."""
    rng = np.random.default_rng(100 + seed)
    S = int(rng.choice([2, 4, 8]))
    V = int(rng.choice([1, 2]))
    L = int(rng.choice([1, 2]))
    h = int(rng.choice([4, 8]))
    i, o = int(rng.choice([3, 5])), int(rng.choice([2, 4]))
    M = int(rng.choice([S, 2 * S]))
    B = M * int(rng.choice([1, 2]))
    a = arrays(i, h, o, S * V, L, seed=seed)
    xb = rng.uniform(size=(B, i))
    jmesh, mesh = JP.make_pipeline_mesh(S), tmesh((S,))
    want = seq_loss_t([torch.tensor(x) for x in a], torch.tensor(xb)).numpy()
    jm = JP.PipelineMLP(*(jnp.asarray(x) for x in f32(a)))
    forms = [("circular", JP.shard_circular_model, TP.shard_circular_model,
              JP.circular_pipeline_forward, TP.circular_pipeline_forward)]
    if V == 1:
        forms.append(("gpipe", JP.shard_pipeline_model,
                      TP.shard_pipeline_model, JP.pipeline_forward,
                      TP.pipeline_forward))
    for name, jshard, tshard, jfwd, tfwd in forms:
        jf = np.asarray(jfwd(jshard(jm, jmesh), jmesh,
                             jnp.asarray(np.float32(xb)), M))
        for dt in (torch.float32, torch.float64):
            model = TP.PipelineMLP.from_arrays(
                *(a if dt == torch.float64 else f32(a)), device="cpu")
            got = tfwd(tshard(model, mesh), mesh, torch.tensor(xb, dtype=dt),
                       M).numpy()
            ref, tol = (jf, TOL_FWD) if dt == torch.float32 else (want,
                                                                  TOL_F64)
            np.testing.assert_allclose(got, ref, atol=tol, rtol=0,
                                       err_msg=f"{name} S={S} V={V} M={M}")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pipeline_checkpoint_roundtrip(tmp_path, writer):
    """``test_utils.py:100``: a PipelineMLP saved by one package loads in
    the other (and in itself) bit for bit, sharded leaves gathered whole."""
    a = f32(arrays(4, 8, 2, 2, 1, seed=0))
    p = str(tmp_path / "pipe.npz")
    if writer == "jax":
        JC.save_pipeline(p, JP.PipelineMLP(*(jnp.asarray(x) for x in a)))
    else:
        mesh = tmesh((2,))
        TC.save_pipeline(p, TP.shard_pipeline_model(
            TP.PipelineMLP.from_arrays(*a, device="cpu"), mesh))
    for m in (TC.load_pipeline(p, device="cpu"), JC.load_pipeline(p)):
        for x, y in zip(a, m.params()):
            np.testing.assert_array_equal(np.asarray(y), x)


def test_meshes_take_make_mesh_devices_rule():
    """The three meshes: their axes and shapes, the flat rank order
    row-major over (data, stage, model), explicit devices named several
    times, an error without enough devices, and no visible card raising
    (never a CPU fallback)."""
    m = TP.make_3d_pipeline_mesh(2, 3, 2, devices=["cpu"] * 12)
    assert m.axis_names == ("data", "stage", "model")
    assert m.shape == {"data": 2, "stage": 3, "model": 2}
    assert [m.coord(7, a) for a in m.axis_names] == [1, 0, 1]
    assert m.groups("stage")[0] == (0, 2, 4)
    assert TP.make_dp_pipeline_mesh(2, 2, devices=["cpu"] * 4).axis_names \
        == ("data", "stage")
    with pytest.raises(ValueError, match="requested 4 devices"):
        TP.make_pipeline_mesh(4, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TP.make_pipeline_mesh(2)


def test_init_draws_from_the_generator():
    """``PipelineMLP.init``: f32 leaves of the JAX shapes from an explicit
    generator (one seed, one model)."""
    a = TP.PipelineMLP.init(4, 8, 3, 2, 2, torch.Generator().manual_seed(5),
                            device="cpu")
    b = TP.PipelineMLP.init(4, 8, 3, 2, 2, torch.Generator().manual_seed(5),
                            device="cpu")
    shapes = [(8, 4), (8,), (2, 2, 8, 8), (2, 2, 8), (3, 8), (3,)]
    assert [tuple(p.shape) for p in a.params()] == shapes
    assert all(p.dtype == torch.float32 for p in a.params())
    assert all(torch.equal(x, y) for x, y in zip(a.params(), b.params()))
    assert a.n_stages == 2 and a.replace_params(b.params()).n_stages == 2
