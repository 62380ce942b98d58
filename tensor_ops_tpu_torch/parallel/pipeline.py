"""Pipeline parallelism: GPipe and the circular (interleaved) schedule on a
``stage`` mesh axis, the counterpart of ``tensor_ops_tpu/parallel/pipeline.py``.

A uniform-width ffLayer chain is split into S stages whose parameters
stack into arrays with a leading stage axis (:class:`PipelineMLP`); the
input embedding (i -> h) and the output projection (h -> o) are
replicated.  The JAX package runs each stage's ticks in a ``lax.scan``
inside ``shard_map`` and lets ``jax.grad`` transpose it.  Here the
schedule is eager, in ``torch.autograd``, over the mesh's ranks in turn:

* each tick every stage rank runs its microbatch through its layers
  (plain products, as in the JAX package: no Pallas kernel sits there);
  a tick whose result the schedule masks out is skipped, not computed and
  dropped, so the outputs and gradients are the same with less work;
* the hand-off to the next stage (``lax.ppermute``) is the tensor handed
  to that stage's rank: nothing on one card, a peer copy (``Tensor.to``)
  across cards, whose backward is the reverse shift;
* the closing ``lax.psum`` over the stage axis, the all-gather over the
  model axis between a tensor-parallel stage's layers and its transpose (a
  reduce-scatter), and the reduction of each replicated leaf's gradient
  over the ranks that hold it are kernel 9's collectives
  (:mod:`.collective_kernels`), one call per group of ranks.

Each data group (one data rank, all its stage and model ranks) runs its
rows of every microbatch; the embedding runs on its stage-0 ranks, the
projection, softmax and loss once, on its stage-0, model-0 rank (the
"home" rank), so every gradient a rank holds is its share of the sum.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List

import numpy as np
import torch

from .collective_kernels import (ring_all_gather, ring_all_reduce_bidir,
                                 ring_reduce_scatter)
from .mesh import (DATA_AXIS, MODEL_AXIS, STAGE_AXIS, Mesh, Sharded,
                   _split_rows, mesh_devices, place)

def make_pipeline_mesh(n_stages: int, devices=None) -> Mesh:
    """A 1-D ``(stage,)`` mesh.  ``devices`` as for ``make_mesh``: the
    visible cards by default (an error without one), or an explicit list
    that may name a card several times or be ``["cpu"] * n``."""
    devs = mesh_devices(devices, n_stages, "make_pipeline_mesh")
    return Mesh(devs, (STAGE_AXIS,))


def make_dp_pipeline_mesh(n_data: int, n_stages: int, devices=None) -> Mesh:
    """2-D ``(data, stage)`` mesh: the batch over ``data``, the layers over
    ``stage`` (dp x pp in one train step)."""
    devs = mesh_devices(devices, n_data * n_stages, "make_dp_pipeline_mesh")
    return Mesh(np.asarray(devs, dtype=object).reshape(n_data, n_stages),
                (DATA_AXIS, STAGE_AXIS))


def make_3d_pipeline_mesh(n_data: int, n_stages: int, n_model: int,
                          devices=None) -> Mesh:
    """3-D ``(data, stage, model)`` mesh: the batch over ``data``, the layer
    chain over ``stage``, each stage's hidden width over ``model`` (dp x pp
    x tp in one train step)."""
    devs = mesh_devices(devices, n_data * n_stages * n_model,
                        "make_3d_pipeline_mesh")
    return Mesh(np.asarray(devs, dtype=object).reshape(
        n_data, n_stages, n_model), (DATA_AXIS, STAGE_AXIS, MODEL_AXIS))


@dataclass
class PipelineMLP:
    """S pipeline stages x L layers a stage of width h, and the replicated
    projections in and out.  ``stage_ws``: (S, L, h, h); ``stage_bs``:
    (S, L, h); logistic hidden activations, softmax output.  The leaves are
    tensors, or :class:`~.mesh.Sharded` leaves once placed on a mesh
    (:func:`shard_pipeline_model`)."""

    w_in: Any    # (h, i)
    b_in: Any    # (h,)
    stage_ws: Any  # (S, L, h, h)
    stage_bs: Any  # (S, L, h)
    w_out: Any   # (o, h)
    b_out: Any   # (o,)

    @property
    def n_stages(self) -> int:
        return self.stage_ws.shape[0]

    @classmethod
    def init(cls, i: int, h: int, o: int, n_stages: int,
             layers_per_stage: int, generator: torch.Generator,
             scale: float = 0.5, device="cuda") -> "PipelineMLP":
        """Random f32 parameters drawn from ``generator`` (normal weights
        scaled as the JAX package's, zero biases), on ``device``."""
        def normal(*shape, s):
            return (s * torch.randn(shape, generator=generator,
                                    dtype=torch.float32)).to(device)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return cls(
            w_in=normal(h, i, s=scale), b_in=zeros(h),
            stage_ws=normal(n_stages, layers_per_stage, h, h,
                            s=scale / np.sqrt(h)),
            stage_bs=zeros(n_stages, layers_per_stage, h),
            w_out=normal(o, h, s=scale), b_out=zeros(o))

    @classmethod
    def from_arrays(cls, *arrays, device="cuda") -> "PipelineMLP":
        """From six host arrays (``w_in, b_in, stage_ws, stage_bs, w_out,
        b_out``; e.g. the JAX package's ``params()``), copied onto
        ``device`` in their own dtypes."""
        return cls(*(torch.tensor(np.asarray(a), device=device)
                     for a in arrays))

    def params(self):
        return (self.w_in, self.b_in, self.stage_ws, self.stage_bs,
                self.w_out, self.b_out)

    def replace_params(self, params) -> "PipelineMLP":
        return PipelineMLP(*params)


def _pipeline_specs(mesh: Mesh):
    """The specs of the six leaves: the stage arrays over the stage axis,
    and over the model axis on their output dimension when the mesh has
    one; the projections replicated."""
    m = MODEL_AXIS if MODEL_AXIS in mesh.axis_names else None
    return ((None, None), (None,), (STAGE_AXIS, None, m, None),
            (STAGE_AXIS, None, m), (None, None), (None,))


def _host(x):
    return np.asarray(x) if isinstance(x, Sharded) else x


def shard_pipeline_model(model: PipelineMLP, mesh: Mesh) -> PipelineMLP:
    """The model's leaves placed on ``mesh`` (:class:`~.mesh.Sharded`):
    the stage arrays over the stage axis (and the model axis, if present),
    the rest replicated."""
    specs = _pipeline_specs(mesh)
    return PipelineMLP(*(place(_host(x), s, mesh)
                         for x, s in zip(model.params(), specs)))


def _interleave_chunks(stage_arr, S: int):
    """Permute global chunks (S_total = S*V) so chunk v*S + d lands at
    sharded position d*V + v (device d's local chunk v).  Works on numpy
    arrays and tensors."""
    total = stage_arr.shape[0]
    V = total // S
    rest = tuple(stage_arr.shape[1:])
    return (stage_arr.reshape((V, S) + rest)
            .swapaxes(0, 1)
            .reshape((total,) + rest))


def shard_circular_model(model: PipelineMLP, mesh: Mesh) -> PipelineMLP:
    """Shard a PipelineMLP for the circular schedule: stage chunks are
    round-robin interleaved across devices before the stage-axis shard."""
    S = mesh.shape[STAGE_AXIS]
    if model.n_stages % S != 0:
        raise ValueError(
            f"circular pipeline needs n_stages ({model.n_stages}) divisible "
            f"by the stage-axis size ({S})")
    ws = _interleave_chunks(_host(model.stage_ws), S)
    bs = _interleave_chunks(_host(model.stage_bs), S)
    perm = PipelineMLP(_host(model.w_in), _host(model.b_in), ws, bs,
                       _host(model.w_out), _host(model.b_out))
    return shard_pipeline_model(perm, mesh)


# ---------------------------------------------------------------------------
# Kernel 9 in autograd
# ---------------------------------------------------------------------------


class _StageSum(torch.autograd.Function):
    """``lax.psum`` over a stage group: kernel 9's all-reduce of the stage
    ranks' outputs; its transpose, the all-reduce of the cotangents (the
    loss is taken on one rank of the group, so the sum is that cotangent
    on every stage rank)."""

    @staticmethod
    def forward(ctx, *xs):
        return tuple(_sum16(list(xs)))

    @staticmethod
    def backward(ctx, *gs):
        return tuple(_sum16([g.contiguous() for g in gs]))


def _sum16(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Kernel 9's all-reduce, a 16-bit float crossing as f32 (the kernels
    move f32 and int32; a stage psum adds zeros to one rank's value, so
    the round trip is exact)."""
    dt = xs[0].dtype
    if dt in (torch.bfloat16, torch.float16):
        return [y.to(dt) for y in ring_all_reduce_bidir([x.float()
                                                          for x in xs])]
    return ring_all_reduce_bidir(xs)


class _FeatureGather(torch.autograd.Function):
    """``lax.all_gather(..., MODEL_AXIS, axis=1, tiled=True)`` over a model
    group: kernel 9's ``ag`` of the ranks' feature blocks; its transpose,
    the reduce-scatter (``rs``) of the cotangents, which each model rank
    holds as its partial share of the sum.  16-bit floats cross as f32
    (the gather is exact both ways; the sums of the transpose are taken
    in f32 and rounded once)."""

    @staticmethod
    def forward(ctx, *xs):
        return tuple(_as16(ring_all_gather, [x.contiguous() for x in xs]))

    @staticmethod
    def backward(ctx, *gs):
        return tuple(_as16(ring_reduce_scatter, [g.contiguous()
                                                 for g in gs]))


def _as16(fn, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Kernel 9's ``fn`` along dimension 1 (the kernels move f32 and
    int32): a 16-bit float operand through f32 and back."""
    dt = xs[0].dtype
    if dt in (torch.bfloat16, torch.float16):
        return [y.to(dt) for y in fn([x.float() for x in xs], dim=1)]
    return fn(xs, dim=1)


def _group_op(fn, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    return list(fn.apply(*xs)) if len(xs) > 1 else list(xs)


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------


class _Layout:
    """The ranks of a mesh by (data, stage, model) coordinate (an axis the
    mesh lacks has size 1); with ``home_column`` only model rank 0 of each
    (data, stage) pair, the ranks that run a partition which leaves the
    model axis idle."""

    def __init__(self, mesh: Mesh, home_column: bool = False):
        if STAGE_AXIS not in mesh.axis_names:
            raise ValueError(f"a pipeline needs a mesh with a stage axis "
                             f"(make_pipeline_mesh), got {mesh!r}")
        self.mesh = mesh
        self.dp = mesh.shape.get(DATA_AXIS, 1)
        self.S = mesh.shape[STAGE_AXIS]
        self.tp = mesh.shape.get(MODEL_AXIS, 1)
        self.rank = np.zeros((self.dp, self.S, self.tp), dtype=np.int64)
        for r in range(mesh.size):
            self.rank[mesh.coord(r, DATA_AXIS), mesh.coord(r, STAGE_AXIS),
                      mesh.coord(r, MODEL_AXIS)] = r
        if home_column:
            self.rank, self.tp = self.rank[:, :, :1], 1

    def dev(self, r: int) -> torch.device:
        return self.mesh.rank_devices[r]


def _stage_fn(ws, bs, xs, tp: int):
    """One stage chunk on its model group: L logistic ffLayers.  ``ws[m]``
    (L, h/tp, h) and ``bs[m]`` (L, h/tp) are model rank m's rows, ``xs[m]``
    the whole input on its device; with tp > 1 each layer's blocks are
    all-gathered over the group (``_stage_fn_tp``)."""
    for k in range(ws[0].shape[0]):
        a = [torch.sigmoid(torch.addmm(b[k], x, w[k].T))
             for w, b, x in zip(ws, bs, xs)]
        xs = _group_op(_FeatureGather, a) if tp > 1 else a
    return xs


def _schedule(lay: _Layout, d: int, stage: Callable, inject, M: int,
              V: int, fifo: bool) -> List[List[torch.Tensor]]:
    """Data group ``d``'s ticks: T = V*M + S - 1 of them; at tick t stage
    rank s runs its local chunk v = (t-s) // M on microbatch (t-s) % M
    (``stage(s, v, xs) -> ys``, one tensor per model rank in and out)
    when 0 <= t-s < V*M, and skips the tick otherwise.  Stage 0 takes
    chunk 0's input from ``inject`` (one list per microbatch, one tensor
    per model rank) and a wrapped chunk's from stage S-1, through a FIFO of
    depth M - S when ``fifo`` and M > S (the circular schedule's; read at
    slot t % F before the value that just arrived is written there).  Each
    tick's outputs are handed to the next stage's ranks.  Returns, per
    stage rank, its outputs stacked by microbatch (zeros but on the last
    stage: the schedule collects there), one tensor per model rank."""
    S, tp = lay.S, lay.tp
    ranks = lay.rank[d]
    F = M - S if fifo else 0
    queue = [None] * max(F, 0)
    state = [None] * S
    outputs = [None] * M
    for t in range(V * M + S - 1):
        x_wrap = state[0]
        if F > 0:
            slot = t % F
            x_wrap, queue[slot] = queue[slot], state[0]
        ys = [None] * S
        for s in range(S):
            k = t - s
            if not 0 <= k < V * M:
                continue  # masked out by the schedule: skipped
            v, m = divmod(k, M)
            if s == 0:
                x_in = inject[m] if v == 0 else x_wrap
            else:
                x_in = state[s]
            ys[s] = stage(s, v, x_in)
            if s == S - 1 and v == V - 1:
                outputs[m] = ys[s]
        # the ring shift: stage s's outputs to stage s+1's ranks
        state = [None if ys[(s - 1) % S] is None else
                 [y.to(lay.dev(r)) for y, r in zip(ys[(s - 1) % S],
                                                   ranks[s])]
                 for s in range(S)]
    last = [torch.cat([outputs[m][j] for m in range(M)]) for j in range(tp)]
    return [last if s == S - 1 else
            [torch.zeros(y.shape, dtype=y.dtype, device=lay.dev(r))
             for y, r in zip(last, ranks[s])] for s in range(S)]


def _stage_sum(lay: _Layout, outs) -> None:
    """``lax.psum`` over each (data, model) stage group of one data group's
    schedule outputs (:func:`_schedule`), in place: every stage rank then
    holds the last stage's outputs."""
    for j in range(lay.tp):
        summed = _group_op(_StageSum, [outs[s][j] for s in range(lay.S)])
        for s in range(lay.S):
            outs[s][j] = summed[s]


def _pipelined(lay: _Layout, leaves, xb, M: int, V: int, fifo: bool):
    """The embed -> pipelined body -> project -> softmax chain on every data
    group; returns, per data group, its softmax output (its rows of each
    microbatch, microbatch by microbatch) on its home rank."""
    B = xb.shape[0]
    if B % M:
        raise ValueError(f"the batch ({B} rows) does not split into "
                         f"{M} microbatches")
    w_in, b_in, ws_all, bs_all, w_out, b_out = leaves
    probs = []
    for d in range(lay.dp):
        ranks = lay.rank[d]
        home = int(ranks[0][0])
        x = _split_rows(xb, lay.dp, d, lay.dev(home), chunks=M)
        emb = [torch.sigmoid(torch.addmm(b_in[r], x.to(lay.dev(r)),
                                         w_in[r].T)) for r in ranks[0]]
        inject = [[e.reshape(M, -1, e.shape[-1])[m] for e in emb]
                  for m in range(M)]

        def stage(s, v, xs, ranks=ranks):
            rs = ranks[s]
            return _stage_fn([ws_all[r][v] for r in rs],
                             [bs_all[r][v] for r in rs], xs, lay.tp)

        outs = _schedule(lay, d, stage, inject, M, V, fifo)
        _stage_sum(lay, outs)
        z = torch.addmm(b_out[home], outs[0][0], w_out[home].T)
        probs.append(torch.softmax(z, dim=-1))
    return probs


def _leaves_on(model_or_params, lay: _Layout, grad: bool):
    """Each leaf's per-rank tensors (placing plain tensors or arrays by the
    pipeline's specs first), as autograd leaves when ``grad``."""
    specs = _pipeline_specs(lay.mesh)
    placed = tuple(p if isinstance(p, Sharded) else place(_host(p), s,
                                                          lay.mesh)
                   for p, s in zip(model_or_params, specs))
    if not grad:
        return placed, [p.shards for p in placed]
    return placed, [[x.detach().requires_grad_() for x in p.shards]
                    for p in placed]


def _gather_rows(lay: _Layout, probs, M: int) -> torch.Tensor:
    """The data groups' outputs as the batch's rows, in order, on rank 0's
    device (kernel 9's ``ag`` over the home ranks when dp > 1)."""
    if lay.dp == 1:
        return probs[0]
    rows = ring_all_gather(probs)[0]
    o = rows.shape[-1]
    return (rows.reshape(lay.dp, M, -1, o).transpose(0, 1)
            .reshape(-1, o))


def _check_circular(mesh: Mesh, M: int) -> int:
    S = mesh.shape[STAGE_AXIS]
    if M < S:
        raise ValueError(
            f"circular schedule requires n_microbatches ({M}) >= stage-axis "
            f"size ({S}); M > S buffers the wrap in a depth-(M-S) FIFO")
    return S


def _forward(model: PipelineMLP, mesh: Mesh, xb, M: int, V: int,
             fifo: bool) -> torch.Tensor:
    lay = _Layout(mesh)
    _, leaves = _leaves_on(model.params(), lay, grad=False)
    with torch.no_grad():
        xb = torch.as_tensor(xb, dtype=leaves[0][0].dtype)
        return _gather_rows(lay, _pipelined(lay, leaves, xb, M, V, fifo), M)


def pipeline_forward(model: PipelineMLP, mesh: Mesh, xb,
                     n_microbatches: int) -> torch.Tensor:
    """Batched forward through the GPipe schedule; ``xb``: (B, i), B
    divisible by ``n_microbatches``.  Returns the softmax output on rank
    0's device."""
    return _forward(model, mesh, xb, n_microbatches, 1, fifo=False)


def circular_pipeline_forward(model: PipelineMLP, mesh: Mesh, xb,
                              n_microbatches: int) -> torch.Tensor:
    """Circular-schedule inference (see :func:`circular_pipeline_train_step`;
    ``model`` sharded with :func:`shard_circular_model`).  M < S, which the
    JAX package's forward does not check (the wrap would then be read
    before it arrives), raises as the train step does."""
    S = _check_circular(mesh, n_microbatches)
    return _forward(model, mesh, xb, n_microbatches, model.n_stages // S,
                    fifo=True)


def _make_step(mesh: Mesh, M: int, V: int, fifo: bool) -> Callable:
    """``step(lr, xb, yb, *params) -> (loss, new_params)``: cross-entropy on
    the softmax output, backward through the schedule in autograd, each
    leaf's gradient summed over the ranks that hold a copy of its block
    (kernel 9's ``ar``, one call per group: the projections over every
    rank, the stage arrays over the data axis), then ``p - lr * g`` on
    every rank.  The loss comes back as a 0-d tensor on rank 0's device,
    the parameters as :class:`~.mesh.Sharded` leaves."""
    lay = _Layout(mesh)

    def step(lr, xb, yb, *params):
        placed, leaves = _leaves_on(params, lay, grad=True)
        dt = leaves[0][0].dtype
        xb = torch.as_tensor(xb, dtype=dt)
        yb = torch.as_tensor(yb, dtype=dt)
        B = xb.shape[0]
        probs = _pipelined(lay, leaves, xb, M, V, fifo)
        losses = []
        for d, p in enumerate(probs):
            y = _split_rows(yb, lay.dp, d, p.device, chunks=M)
            losses.append(-torch.sum(y * torch.log(p + 1e-30)) / B)
        torch.autograd.backward(losses)
        with torch.no_grad():
            vals = [v.detach().reshape(1) for v in losses]
            loss = (ring_all_reduce_bidir(vals)[0] if lay.dp > 1
                    else vals[0]).reshape(())
            new = []
            for p, ls in zip(placed, leaves):
                grads = [x.grad if x.grad is not None else torch.zeros_like(x)
                         for x in ls]
                axes = [a for a in mesh.axis_names
                        if a not in p.spec and mesh.shape[a] > 1]
                if axes:
                    for group in mesh.groups(axes):
                        for r, g in zip(group, ring_all_reduce_bidir(
                                [grads[r] for r in group])):
                            grads[r] = g
                new.append(Sharded(p.spec, [x.detach() - lr * g for x, g
                                            in zip(ls, grads)],
                                   mesh, p.shape))
        return loss, tuple(new)

    return step


def pipeline_train_step(model: PipelineMLP, mesh: Mesh,
                        n_microbatches: int) -> Callable:
    """GPipe SGD step ``fn(lr, xb, yb, *params) -> (loss, new_params)``:
    cross-entropy on the softmax output, gradients through the schedule
    (see :func:`_make_step`)."""
    return _make_step(mesh, n_microbatches, 1, fifo=False)


def circular_pipeline_train_step(model: PipelineMLP, mesh: Mesh,
                                 n_microbatches: int) -> Callable:
    """Circular-schedule SGD step; ``model`` must be sharded with
    :func:`shard_circular_model`.  ``n_microbatches`` >= the stage-axis
    size S: M == S consumes wrapped activations the tick they arrive,
    M > S buffers them in a depth-(M-S) ring FIFO (more microbatches ->
    smaller bubble (S-1)/(VM+S-1))."""
    S = _check_circular(mesh, n_microbatches)
    return _make_step(mesh, n_microbatches, model.n_stages // S, fifo=True)
