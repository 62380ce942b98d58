"""``dryrun_multichip(n)``: one full training step on every parallelism
axis the package runs, the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``; and ``entry()``, the counterpart of
its ``entry()``.

The runs, in the JAX dry run's order and at its shapes: on an n-rank
``(data, model)`` mesh a dp + tp step of the flagship MLP (784 -> 300 ->
100 -> 10, ``sharded_train_step``) and its sharded forward, ``fit`` with
sgd, and adam replicated, at ZeRO-2, ZeRO-3 and ZeRO-3 with
``offload_opt_state`` (each held to the replicated run's losses at 1e-5);
a GPipe step of a ``PipelineMLP`` over n stages; a staged-IR pipeline step
of a ``gen_net`` chain over n stages; at n >= 4 the circular schedule
(S4 x V2) and the heterogeneous circular cut of a pyramid; the flagship's
heterogeneous cut on ``min(3, n)`` stages, held at 1e-6 to the sequential
staged-IR step; at even n >= 4 ``fit`` on a ``(data=2, stage=n/2)`` mesh
with adam at ZeRO-2; the data-parallel whole step
(``dp_megakernel_train_step``, kernels 3 and 9) on a ``(data,)`` mesh of
the n ranks; at n >= 8, on the ``(data, stage, model)`` mesh ``(2, 2,
2)``, a ``PipelineMLP`` step, ``fit`` through the staged IR, the hetero-tp
cut of a pyramid and of the flagship (held at 1e-6 to the sequential step)
and the hetero-tp circular cut of a pyramid; ``shard_fused`` + ``Predictor``
serving on the mesh and a ``reload`` of a second sharded flagship; and
``fit_sequences`` of an Elman model on the mesh.  The ranks are the
visible cards by default (several ranks may share one:
``devices=["cuda:0"] * n``), or ``devices=["cpu"] * n``; every collective
is kernel 9.

    python -m tensor_ops_tpu_torch.dryrun 8 [--cpu]
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

FLAGSHIP = (784, 300, 100, 10)


class DryRunError(RuntimeError):
    """A check of the dry run failed."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise DryRunError(msg)


def _host(x) -> np.ndarray:
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _flagship(be, seed: int = 0):
    from .backend.rng import Rng
    from .models import act_logistic, act_softmax, gen_net

    i, h1, h2, o = FLAGSHIP
    return gen_net(be, i, o, [(h1, act_logistic()), (h2, act_logistic())],
                   act_softmax(), Rng(be, seed=seed))


def entry(device: str = "cuda"):
    """``(fn, example_args)``: a batched forward of the flagship MLP
    (``gen_net`` seed 0, drawn on the CPU so that every device holds the
    same weights) and 32 rows of ``default_rng(0).uniform`` on ``device``;
    ``fn(xb, *params)`` returns the (32, 10) softmax rows, in the dtype of
    what it is given."""
    from .backend.torch_backend import TorchBackend
    from .models.training import _vmap

    net = _flagship(TorchBackend(torch.float32, "cpu"))
    params = tuple(p.to(device) for p in net.params)

    def forward(xb, *ps):
        be = TorchBackend(xb.dtype, xb.device)

        def single(x, *q):
            return net.op.apply(be, (x,) + q)[0]

        return _vmap(single, 1, len(ps))(xb, *ps)

    rows = np.random.default_rng(0).uniform(0, 1, size=(32, FLAGSHIP[0]))
    xb = torch.as_tensor(rows, dtype=torch.float32, device=device)
    return forward, (xb,) + params


def dryrun_runs(n_devices: int, devices=None):
    """The dry run, one ``(key, loss)`` pair as each run ends (a caller may
    time or count what lies between two); each check raises
    :class:`DryRunError`."""
    from .backend.rng import Rng
    from .backend.torch_backend import TorchBackend
    from .models import (FusedMLP, Predictor, act_logistic, adam,
                         cross_entropy, fit, fit_sequences, gen_net,
                         squared_error)
    from .models.recurrent import gen_net as gen_rnet
    from .models.training import make_vmapped_grads
    from .parallel import (Mesh, PipelineMLP, dp_megakernel_train_step,
                           make_3d_pipeline_mesh, make_dp_pipeline_mesh,
                           make_mesh, make_pipeline_mesh, pipeline_train_step,
                           shard_fused, shard_network, shard_pipeline_model,
                           sharded_forward, sharded_train_step)
    from .parallel.ir_pipeline import (HeteroCircularPipelinedNetwork,
                                       HeteroTpCircularPipelinedNetwork,
                                       HeteroTpPipelinedNetwork,
                                       ir_pipeline_train_step,
                                       partition_network,
                                       shard_pipelined_params)
    from .parallel.mesh import mesh_devices

    devs = mesh_devices(devices, n_devices, "dryrun_multichip")
    be = TorchBackend(torch.float32, devs[0])
    n = n_devices

    # dp + tp: the flagship's real widths (the 10-wide output does not
    # divide tp = 4, so param_specs shards its 100-wide input side)
    mesh = make_mesh(n, devices=devs)
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    i, h1, h2, o = FLAGSHIP
    net = _flagship(be)
    loss = cross_entropy(o)
    snet = shard_network(net, mesh)
    batch = 2 * dp
    g = np.random.default_rng(1)
    xb = be.asarray(g.uniform(0, 1, size=(batch, i)))
    yb = be.asarray(np.eye(o)[g.integers(0, o, size=batch)])
    v, new = sharded_train_step(net, loss, be, mesh)(0.1, xb, yb,
                                                     *snet.params)
    if tp > 1:
        split = sum(1 for p in new if p.ndim == 2 and p.mdim is not None)
        _require(split == 3, f"expected the 3 flagship weights model-sharded,"
                 f" got {split}")
    probs = sharded_forward(net, be, mesh)(xb, *new)
    _require(tuple(probs.shape) == (batch, o),
             f"sharded forward gave {tuple(probs.shape)}, want {(batch, o)}")
    yield "dp_tp", float(v)

    # fit on the mesh: sgd, then adam replicated and up the ZeRO ladder,
    # each rung's losses those of the replicated adam run within 1e-5
    Xf = g.uniform(0, 1, size=(2 * batch, i))
    Yf = np.eye(o)[g.integers(0, o, size=2 * batch)]
    kw = dict(epochs=1, batch_size=batch, lr=0.1, mesh=mesh, log_every=1,
              verbose=False)
    res = fit(net, loss, be, Xf, Yf, **kw)
    yield "fit", res.history[-1]["loss"]
    rz0 = fit(net, loss, be, Xf, Yf, optimizer=adam(), **kw)
    yield "fit_adam", rz0.history[-1]["loss"]
    for key, zkw in (("fit_zero2", dict(zero_stage=2)),
                     ("fit_zero3", dict(zero_stage=3)),
                     ("fit_zero3_offload", dict(zero_stage=3,
                                                offload_opt_state=True))):
        rz = fit(net, loss, be, Xf, Yf, optimizer=adam(), **zkw, **kw)
        for a, b in zip(rz.history, rz0.history):
            _require(abs(a["loss"] - b["loss"]) < 1e-5,
                     f"{key} diverged from the replicated run: {a} vs {b}")
        yield key, rz.history[-1]["loss"]

    # GPipe over n stages
    pmesh = make_pipeline_mesh(n, devices=devs)
    gen = torch.Generator().manual_seed(0)
    pmodel = shard_pipeline_model(
        PipelineMLP.init(i, 2 * tp, o, n_stages=n, layers_per_stage=1,
                         generator=gen, device=devs[0]), pmesh)
    pv, _ = pipeline_train_step(pmodel, pmesh, n_microbatches=2)(
        0.1, xb, yb, *pmodel.params())
    yield "gpipe", float(pv)

    # the staged-IR pipeline of a gen_net chain over n stages
    h = 8
    irnet = gen_net(be, h, h, [(h, act_logistic())] * (n - 1),
                    act_logistic(), Rng(be, seed=2))
    irstep, irpnet = ir_pipeline_train_step(irnet, cross_entropy(h), be,
                                            pmesh, n_microbatches=2)
    xh = be.asarray(g.uniform(0, 1, size=(batch, h)))
    yh = be.asarray(np.eye(h)[g.integers(0, h, size=batch)])
    iv, _ = irstep(0.1, xh, yh,
                   *shard_pipelined_params(irpnet, pmesh).flat_params())
    yield "staged_ir", float(iv)

    # the circular schedule, S4 x V2: a uniform body of 8 segments, and a
    # varied-width pyramid (no uniform run) on the hetero circular cut
    if n >= 4:
        cmesh = make_pipeline_mesh(4, devices=devs)
        cnet = gen_net(be, h, h, [(h, act_logistic())] * 9, act_logistic(),
                       Rng(be, seed=7))
        cstep, cpnet = ir_pipeline_train_step(
            cnet, cross_entropy(h), be, cmesh, n_microbatches=4,
            schedule="circular", n_chunks=2)
        xc = be.asarray(g.uniform(0, 1, size=(8, h)))
        yc = be.asarray(np.eye(h)[g.integers(0, h, size=8)])
        cv, _ = cstep(0.1, xc, yc,
                      *shard_pipelined_params(cpnet, cmesh).flat_params())
        yield "staged_ir_circular", float(cv)
        hcnet = gen_net(be, 24, 24, [(w, act_logistic())
                                     for w in (20, 16, 12, 8, 12, 16, 20)],
                        act_logistic(), Rng(be, seed=9))
        hcstep, hcpnet = ir_pipeline_train_step(
            hcnet, squared_error(24), be, cmesh, n_microbatches=4,
            schedule="circular", n_chunks=2)
        _require(isinstance(hcpnet, HeteroCircularPipelinedNetwork),
                 f"the varied-width pyramid took {type(hcpnet).__name__}, "
                 f"not the hetero circular cut")
        xhc = be.asarray(g.uniform(0, 1, size=(8, 24)))
        yhc = be.asarray(g.uniform(0, 1, size=(8, 24)))
        hcv, _ = hcstep(0.1, xhc, yhc,
                        *shard_pipelined_params(hcpnet, cmesh).flat_params())
        yield "staged_ir_circular_hetero", float(hcv)

    # the flagship's heterogeneous cut (784 -> 300 -> 100 -> 10 has no
    # uniform body): one pipelined step lands on the sequential staged-IR
    # step
    S_het = min(3, n)
    hmesh = make_pipeline_mesh(S_het, devices=devs)
    hstep, hpnet = ir_pipeline_train_step(net, loss, be, hmesh,
                                          n_microbatches=2)
    hx = be.asarray(g.uniform(0, 1, size=(4, i)))
    hy = be.asarray(np.eye(o)[g.integers(0, o, size=4)])
    vals, grads = make_vmapped_grads(net, loss, be)(hx, hy, *net.params)
    seq_loss = float(vals.mean())
    want = [_host(p) - 0.1 * _host(gr.mean(0))
            for p, gr in zip(net.params, grads)]

    def same_as_sequential(what, v, pnet, flat):
        _require(abs(float(v) - seq_loss) < 1e-6,
                 f"{what}: loss {float(v)} vs the sequential {seq_loss}")
        got = pnet.unflatten(tuple(flat)).to_network_params()
        for k, (w, nn) in enumerate(zip(want, got)):
            err = float(np.max(np.abs(w - _host(nn))))
            _require(err < 1e-6, f"{what}: leaf {k} off the sequential step "
                     f"by {err}")

    hv, hnew = hstep(0.1, hx, hy,
                     *shard_pipelined_params(hpnet, hmesh).flat_params())
    same_as_sequential("the flagship's hetero cut", hv, hpnet, hnew)
    yield "staged_ir_flagship", float(hv)

    # fit on (data=2, stage=n/2): adam at ZeRO-2 through the staged IR
    if n % 2 == 0 and n >= 4:
        ppmesh = make_dp_pipeline_mesh(2, n // 2, devices=devs)
        ppnet = gen_net(be, h, h, [(h, act_logistic())] * (n // 2),
                        act_logistic(), Rng(be, seed=3))
        Xp = g.uniform(0, 1, size=(8, h))
        Yp = np.eye(h)[g.integers(0, h, size=8)]
        rpp = fit(ppnet, cross_entropy(h), be, Xp, Yp, epochs=1,
                  batch_size=4, lr=0.05, optimizer=adam(), mesh=ppmesh,
                  pipeline_microbatches=2, log_every=1, verbose=False,
                  zero_stage=2)
        yield "fit_dp_pipeline", rpp.history[-1]["loss"]

    # the data-parallel whole step: kernel 3 on each rank's rows, kernel 9
    # over the (data,) mesh of the n ranks
    r2 = np.random.default_rng(3)
    dims = (16, 32, 8)
    mws = [torch.as_tensor(r2.normal(size=(dims[k + 1], dims[k])) * 0.3,
                           dtype=torch.float32, device=devs[0])
           for k in range(2)]
    mbs = [torch.as_tensor(r2.normal(size=(dims[k + 1],)) * 0.1,
                           dtype=torch.float32, device=devs[0])
           for k in range(2)]
    mstep = dp_megakernel_train_step(Mesh(devs, ("data",)),
                                     ["logistic", "identity"], lr=0.05)
    mB = 2 * n
    mx = torch.as_tensor(r2.uniform(0, 1, size=(mB, dims[0])),
                         dtype=torch.float32, device=devs[0])
    my = torch.as_tensor(np.eye(dims[-1])[r2.integers(0, dims[-1], size=mB)],
                         dtype=torch.float32, device=devs[0])
    mloss, _, _ = mstep(mx, my, mws, mbs)
    yield "dp_megakernel", float(mloss)

    # the 3-D (data, stage, model) mesh
    if n >= 8:
        m3devs = devs[:8]
        mesh3 = make_3d_pipeline_mesh(2, 2, 2, devices=m3devs)
        m3 = shard_pipeline_model(
            PipelineMLP.init(i, 8, o, n_stages=2, layers_per_stage=2,
                             generator=torch.Generator().manual_seed(1),
                             device=devs[0]), mesh3)
        v3, _ = pipeline_train_step(m3, mesh3, n_microbatches=2)(
            0.1, xb, yb, *m3.params())
        yield "pipeline_3d", float(v3)

        # fit through the staged IR, the body tensor-parallel
        if n % 4 == 0:
            mq = make_3d_pipeline_mesh(2, n // 4, 2, devices=devs)
            net3 = gen_net(be, h, h,
                           [(2 * h, act_logistic())] * (2 * (n // 4)),
                           act_logistic(), Rng(be, seed=3))
            X3 = g.uniform(0, 1, size=(8, h))
            Y3 = np.eye(h)[g.integers(0, h, size=8)]
            r3 = fit(net3, cross_entropy(h), be, X3, Y3, epochs=1,
                     batch_size=8, lr=0.05, mesh=mq, pipeline_microbatches=2,
                     log_every=1, verbose=False)
            yield "mesh_3d", r3.history[-1]["loss"]

        # a pyramid on the hetero-tp cut
        pyr = gen_net(be, 16, 16, [(8, act_logistic()), (4, act_logistic()),
                                   (8, act_logistic())], act_logistic(),
                      Rng(be, seed=11))
        part3 = partition_network(pyr, 2, mesh3)
        _require(isinstance(part3, HeteroTpPipelinedNetwork),
                 f"the pyramid took {type(part3).__name__}, not the hetero-"
                 f"tp cut")
        hstep3, hpnet3 = ir_pipeline_train_step(pyr, cross_entropy(16), be,
                                                mesh3, n_microbatches=2)
        xp = be.asarray(g.uniform(0, 1, size=(8, 16)))
        yp = be.asarray(np.eye(16)[g.integers(0, 16, size=8)])
        hv3, _ = hstep3(0.1, xp, yp,
                        *shard_pipelined_params(hpnet3, mesh3).flat_params())
        yield "hetero_tp_pyramid", float(hv3)

        # the flagship on the hetero-tp cut: the same sequential step
        partf = partition_network(net, 2, mesh3)
        _require(isinstance(partf, HeteroTpPipelinedNetwork),
                 f"the softmax flagship took {type(partf).__name__}, not the "
                 f"hetero-tp cut")
        fstep3, fpnet3 = ir_pipeline_train_step(net, loss, be, mesh3,
                                                n_microbatches=2)
        fv3, fnew3 = fstep3(0.1, hx, hy,
                            *shard_pipelined_params(fpnet3,
                                                    mesh3).flat_params())
        same_as_sequential("the flagship's hetero-tp cut", fv3, fpnet3,
                           fnew3)
        yield "hetero_tp_flagship", float(fv3)

        # the pyramid's S x V chunk groups over (stage, model)
        hcnet3 = gen_net(be, 24, 24, [(w, act_logistic())
                                      for w in (20, 16, 12, 8, 12, 16, 20)],
                         act_logistic(), Rng(be, seed=15))
        cstep3, cpnet3 = ir_pipeline_train_step(
            hcnet3, squared_error(24), be, mesh3, n_microbatches=2,
            schedule="circular", n_chunks=2)
        _require(isinstance(cpnet3, HeteroTpCircularPipelinedNetwork),
                 f"the pyramid took {type(cpnet3).__name__}, not the hetero "
                 f"circular x tp cut")
        xc3 = be.asarray(g.uniform(0, 1, size=(8, 24)))
        yc3 = be.asarray(g.uniform(0, 1, size=(8, 24)))
        cv3, _ = cstep3(0.1, xc3, yc3,
                        *shard_pipelined_params(cpnet3, mesh3).flat_params())
        yield "hetero_tp_circular", float(cv3)

    # serving on the mesh: shard_fused + Predictor, then a reload of a
    # second sharded flagship; the entry is the largest change the reload
    # made to a served probability
    spred = Predictor(shard_fused(FusedMLP.from_network(net), mesh),
                      buckets=(4,))
    _require(spred._sharded, "the mesh-sharded FusedMLP was not detected")
    sx = g.uniform(0, 1, size=(3, i)).astype(np.float32)
    sout = spred.predict(sx)
    _require(sout.shape == (3, o) and np.isfinite(sout).all(),
             f"served {sout.shape}, finite: {np.isfinite(sout).all()}")
    spred.reload(shard_fused(FusedMLP.from_network(_flagship(be, 17)), mesh))
    _require(spred._sharded, "the reload lost the sharded route")
    sout2 = spred.predict(sx)
    _require(sout2.shape == (3, o) and not np.allclose(sout, sout2),
             "the reloaded model served the old outputs")
    yield "serve_reload", float(np.max(np.abs(sout2 - sout)))

    # the recurrent family: fit_sequences of a 1 -> [2 tp] -> 1 Elman model
    rn = gen_rnet(be, 1, 1, [(2 * tp, act_logistic(), act_logistic())],
                  act_logistic(), None, Rng(be, seed=13))
    t = np.linspace(0, 1, 7)
    waves = np.sin(2 * np.pi * t[None, :]
                   + g.uniform(0, np.pi, size=(4 * dp, 1)))
    rres = fit_sequences(rn, squared_error(1), be, waves[:, :-1, None],
                         waves[:, 1:, None], epochs=1, batch_size=2 * dp,
                         mesh=mesh, log_every=1, verbose=False)
    yield "fit_sequences", rres.history[-1]["loss"]


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Every run of :func:`dryrun_runs`; returns ``{key: loss}`` in run
    order, and raises :class:`DryRunError` on a failed check or a
    non-finite loss."""
    out = dict(dryrun_runs(n_devices, devices))
    bad = {k: v for k, v in out.items() if not math.isfinite(v)}
    _require(not bad, f"non-finite losses: {bad}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="CPU ranks (default: the visible cards, shared "
                         "round-robin when fewer than n)")
    args = ap.parse_args(argv)
    if args.cpu:
        devices = ["cpu"] * args.n
    else:
        count = torch.cuda.device_count()
        if count == 0:
            raise SystemExit("no CUDA device is visible; pass --cpu")
        devices = [f"cuda:{r % count}" for r in range(args.n)]
    print(dryrun_multichip(args.n, devices))


if __name__ == "__main__":
    main()
