"""Device meshes and sharded training on both axes: the counterpart of
``tensor_ops_tpu/parallel/mesh.py``.

The JAX package annotates leaves with ``NamedSharding``s and lets XLA insert
the collectives.  There is no partitioner here: a :class:`Mesh` is a 2-D
``(data, model)`` grid of torch devices, a sharded leaf (:class:`Sharded`)
holds its spec and one tensor per rank, and every cross-rank reduction and
gather is an explicit call of the bidirectional ring collectives (kernel 9,
:mod:`.collective_kernels`), one call per group of ranks along the axis it
runs on: :func:`reshard` moves a leaf from one spec to another (a slice of
each rank's whole copy, which moves nothing, or an all-gather),
:func:`reduce_mean` takes the ranks' gradients to their mean over the data
axis on a spec (an all-reduce, or a reduce-scatter over the data
dimension).  The ZeRO rules (``zero1_place``, ``zero2_grad_constrain``,
``zero3_param_place``, ...) are the JAX package's, on specs: one rule picks
the dimension a leaf shards over the data axis, and the "constrain"
functions they return reshard leaves onto the specs they carry (``.specs``).

The model axis (tensor parallelism) places the weights by ``param_specs``
(Megatron's alternation of row- and column-parallel layers); the forward
and backward of a network on it are :mod:`.tp`'s executor, which the JAX
package has no counterpart of (GSPMD partitions its programs).
``make_mesh(4)`` factors as ``(1, 4)``, as in the JAX package.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .collective_kernels import (_canonical, ring_all_gather,
                                 ring_all_reduce_bidir, ring_reduce_scatter)

DATA_AXIS = "data"
MODEL_AXIS = "model"
STAGE_AXIS = "stage"

Spec = Tuple[Optional[str], ...]


class Mesh:
    """An n-D grid of torch devices with one name per axis (``axis_names``,
    ``(data, model)`` by default for a 2-D grid; the pipelines add a
    ``stage`` axis: ``(stage,)``, ``(data, stage)``, ``(data, stage,
    model)``).  ``shape`` maps each axis name to its size, as a JAX mesh's
    does.  A device may appear several times: ranks that share one card
    run one after another on its current stream.

    Ranks are numbered in one flat order, row-major over the axes (``r = d
    * tp + m`` for data rank d and model rank m on a ``(data, model)``
    grid): a :class:`Sharded` leaf's ``shards[r]`` lies on
    ``rank_devices[r]``."""

    def __init__(self, devices, axis_names: Optional[Sequence[str]] = None):
        given = np.asarray(devices, dtype=object)
        if given.ndim == 0 or given.size == 0 or any(
                isinstance(d, (list, tuple)) for d in given.reshape(-1)):
            raise ValueError("a mesh is a non-empty (rectangular) grid of "
                             "devices")
        grid = np.empty(given.shape, dtype=object)
        grid.reshape(-1)[:] = [_canonical(torch.device(d))
                               for d in given.reshape(-1)]
        if axis_names is None:
            if grid.ndim != 2:
                raise ValueError(f"a {grid.ndim}-D mesh needs axis_names")
            axis_names = (DATA_AXIS, MODEL_AXIS)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != grid.ndim or len(
                set(self.axis_names)) != grid.ndim:
            raise ValueError(f"axis names {self.axis_names} for a "
                             f"{grid.ndim}-D grid of devices")
        self.devices = _tuples(grid.tolist())
        self.shape = dict(zip(self.axis_names, grid.shape))
        self.rank_devices = tuple(grid.reshape(-1))
        self.size = len(self.rank_devices)

    @property
    def data_devices(self) -> Tuple[torch.device, ...]:
        """The devices of the first data group: one per data rank."""
        return tuple(self.rank_devices[r] for r in self.groups(DATA_AXIS)[0])

    def groups(self, axes) -> Tuple[Tuple[int, ...], ...]:
        """The flat ranks of each group along ``axes`` (one axis name or
        several): the ranks that differ only in their coordinates on those
        axes, one group for each coordinate of the other axes (row-major),
        each in row-major order over ``axes``.  On a ``(data, model)`` grid
        the data axis has one group per model rank m (``d * tp + m`` over
        d), the model axis one per data rank d (``d * tp + m`` over m).
        An axis the mesh lacks counts as size 1."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        axes = tuple(a for a in axes if a in self.shape)
        sizes = tuple(self.shape.values())
        idx = np.arange(self.size).reshape(sizes)
        inner = [self.axis_names.index(a) for a in axes]
        outer = [i for i in range(len(sizes)) if i not in inner]
        idx = idx.transpose(outer + inner).reshape(
            -1, int(np.prod([sizes[i] for i in inner], dtype=np.int64)))
        return tuple(tuple(int(r) for r in g) for g in idx)

    def coord(self, r: int, axis: str) -> int:
        """Rank ``r``'s index along ``axis`` (0 for an axis the mesh
        lacks)."""
        if axis not in self.shape:
            return 0
        sizes = tuple(self.shape.values())
        return int(np.unravel_index(r, sizes)[self.axis_names.index(axis)])

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.devices == other.devices
                and self.axis_names == other.axis_names)

    def __hash__(self) -> int:
        return hash((self.devices, self.axis_names))

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return (f"Mesh({axes}, devices="
                f"{[str(d) for d in self.rank_devices]})")


def _tuples(x):
    return tuple(_tuples(y) for y in x) if isinstance(x, list) else x


def mesh_devices(devices: Optional[Sequence], need: Optional[int],
                 what: str) -> list:
    """The first ``need`` (default: all) of ``devices``, by default the
    visible CUDA cards
    (raising without one: it never falls back to the CPU).  An explicit
    list may name a device several times (several ranks on one card) or be
    ``["cpu"] * n``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what}: no CUDA device is visible; pass devices=['cpu'] "
                f"* n to place the ranks on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if need is None:
        return devices
    if len(devices) < need:
        raise ValueError(
            f"requested {need} devices but only {len(devices)} available "
            f"(pass devices=[...] naming a card several times to place "
            f"several ranks on it)")
    return devices[:need]


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A 2-D ``(data, model)`` mesh.  With no explicit shape, the device
    count n factors as (n // tp, tp) with tp the largest of 4 and 2 that
    divides n (the JAX package's rule); ``shape=(n, 1)`` is a data axis
    alone.

    ``devices`` defaults to the visible CUDA cards; with none visible this
    raises (it never falls back to the CPU).  An explicit list may name a
    device several times: ``devices=["cuda:0"] * 4`` puts 4 ranks on one
    card, ``devices=["cpu"] * n`` runs the ranks on the CPU."""
    devices = mesh_devices(devices, n_devices, "make_mesh")
    n = len(devices)
    if shape is None:
        tp = 1
        for cand in (4, 2):
            if n % cand == 0 and n >= cand:
                tp = cand
                break
        shape = (n // tp, tp)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {tuple(shape)} != device count {n}")
    return Mesh([devices[i * shape[1]:(i + 1) * shape[1]]
                 for i in range(shape[0])])


def param_specs(param_stack: Sequence[Tuple[int, ...]], mesh) -> Tuple[Spec, ...]:
    """Megatron-style specs for an alternating ffLayer chain (the JAX
    package's rule): layer-k weight ``(o, i)`` prefers ``o`` over the model
    axis for even k and ``i`` for odd k; when the preferred dim does not
    divide by the model-axis size the other one is taken, and when neither
    does the weight is replicated with a warning.  Biases follow their
    weight's output sharding.  One entry per dimension."""
    tp = mesh.shape.get(MODEL_AXIS, 1)
    specs = []
    layer = 0
    for shape in param_stack:
        if len(shape) == 2:
            prefer_row = layer % 2 == 0
            row_ok = shape[0] % tp == 0
            col_ok = shape[1] % tp == 0
            if (prefer_row and row_ok) or (row_ok and not col_ok):
                specs.append((MODEL_AXIS, None))
            elif col_ok:
                specs.append((None, MODEL_AXIS))
            else:
                warnings.warn(
                    f"tensor parallelism: weight {shape} has no dim "
                    f"divisible by the model-axis size {tp}; replicating "
                    f"it (pad the layer width to a multiple of {tp} to "
                    f"shard it)", stacklevel=2)
                specs.append((None, None))
            layer += 1
        elif len(shape) == 1:
            prev = specs[-1] if specs else ()
            if len(prev) >= 1 and prev[0] == MODEL_AXIS and shape[0] % tp == 0:
                specs.append((MODEL_AXIS,))
            else:
                specs.append((None,))
        else:
            specs.append((None,) * len(shape))
    return tuple(specs)


def batch_spec() -> Spec:
    return (DATA_AXIS, None)


def _full(spec, ndim: int) -> Spec:
    spec = tuple(spec or ())
    return spec + (None,) * (ndim - len(spec))


def _axis_dim(spec, axis: str) -> Optional[int]:
    return spec.index(axis) if axis in spec else None


def _data_dim(spec) -> Optional[int]:
    return _axis_dim(spec, DATA_AXIS)


class Sharded:
    """One leaf on a mesh: ``spec`` (one entry per dimension: ``None`` or
    one of the mesh's axis names, each axis on one dimension at most) and
    ``shards``, one tensor per rank in the mesh's flat order
    (:attr:`Mesh.rank_devices`), on that rank's device: the rank's block of
    each dimension the spec marks (its data rank's block of the data
    dimension, its model rank's of the model dimension, its stage rank's
    of the stage dimension), the whole extent of every other.  ``shape`` is the whole leaf's.  Nothing updates
    a shard in place; ``scalar * leaf`` and ``leaf + leaf`` apply shard by
    shard to leaves of one spec (the Polyak update).  ``np.asarray(leaf)``
    gathers the whole leaf to one host array."""

    __slots__ = ("spec", "shards", "shape", "mesh")

    def __init__(self, spec, shards, mesh: Mesh, shape=None):
        self.shards = list(shards)
        x0 = self.shards[0]
        self.spec = _full(spec, x0.dim())
        self.mesh = mesh
        n = mesh.size
        if len(self.shards) != n:
            raise ValueError(f"a leaf on {mesh!r} holds {n} shards, got "
                             f"{len(self.shards)}")
        if shape is None:
            shape = list(x0.shape)
            for axis in mesh.axis_names:
                d = _axis_dim(self.spec, axis)
                if d is not None:
                    shape[d] *= mesh.shape[axis]
        self.shape = tuple(shape)

    @property
    def dim(self) -> Optional[int]:
        """The dimension sharded over the data axis (None: replicated)."""
        return _data_dim(self.spec)

    @property
    def mdim(self) -> Optional[int]:
        """The dimension sharded over the model axis, when that axis is
        larger than 1 (None: whole on every model rank)."""
        if self.mesh.shape.get(MODEL_AXIS, 1) == 1:
            return None
        return _axis_dim(self.spec, MODEL_AXIS)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def rank_nbytes(self, r: int) -> int:
        """Bytes rank ``r`` holds of this leaf."""
        return self.shards[r].numel() * self.shards[r].element_size()

    def blocks(self):
        """``(rank, index)`` for one rank holding each block of the leaf:
        the first rank (coordinate 0 on every axis the spec does not
        mark) of each block, and the slices of the whole leaf it holds."""
        mesh = self.mesh
        for r in range(mesh.size):
            idx = [slice(None)] * self.ndim
            for axis in mesh.axis_names:
                c = mesh.coord(r, axis)
                d = _axis_dim(self.spec, axis)
                if d is None:
                    if c:
                        break
                    continue
                w = self.shape[d] // mesh.shape[axis]
                idx[d] = slice(c * w, (c + 1) * w)
            else:
                yield r, tuple(idx)

    def numpy(self) -> np.ndarray:
        """The whole leaf as one host array (each block copied to the host
        once; bf16 widened to f32, as checkpoints store it)."""
        out = None
        for r, idx in self.blocks():
            x = self.shards[r].detach().cpu()
            x = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
            if out is None:
                out = np.empty(self.shape, x.dtype)
            out[idx] = x
        return out

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def full(self) -> torch.Tensor:
        """The whole leaf on rank 0's device, and on no other: rank 0's
        copy when no axis shards it, else each block copied to rank 0's
        device once (a peer copy across cards; no collective runs)."""
        x0 = self.shards[0]
        if all(self.mesh.shape[a] == 1 or _axis_dim(self.spec, a) is None
               for a in self.mesh.axis_names):
            return x0
        out = torch.empty(self.shape, dtype=x0.dtype, device=x0.device)
        for r, idx in self.blocks():
            out[idx] = self.shards[r].to(x0.device)
        return out

    def map(self, fn: Callable, *others) -> "Sharded":
        """``fn`` shard by shard over this leaf and ``others`` (leaves of
        the same spec, or scalars), the result on this leaf's spec."""
        for o in others:
            if isinstance(o, Sharded) and o.spec != self.spec:
                raise ValueError(f"shard-wise op on specs {self.spec} and "
                                 f"{o.spec}")
        shards = [fn(x, *(o.shards[r] if isinstance(o, Sharded) else o
                          for o in others))
                  for r, x in enumerate(self.shards)]
        return Sharded(self.spec, shards, self.mesh, self.shape)

    def __add__(self, o):
        return self.map(lambda a, b: a + b, o)

    def __rmul__(self, o):
        return self.map(lambda a, b: b * a, o)

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, spec={self.spec}, "
                f"dtype={self.dtype}, ranks={len(self.shards)})")


def place(x, spec, mesh: Mesh, dtype: Optional[torch.dtype] = None) -> Sharded:
    """``x`` (a tensor or an array) placed on ``mesh`` by ``spec``: each
    rank gets a copy of its block (or of the whole leaf) in memory of its
    own on its device, in ``dtype`` (default: ``x``'s)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    spec = _full(spec, t.dim())
    cuts = []
    for axis in mesh.axis_names:
        d, n = _axis_dim(spec, axis), mesh.shape[axis]
        if d is None:
            continue
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"over {n} {axis} ranks")
        cuts.append((axis, d, t.shape[d] // n))
    shards = []
    for r, dev in enumerate(mesh.rank_devices):
        part = t
        for axis, d, s in cuts:
            part = part.narrow(d, mesh.coord(r, axis) * s, s)
        out = torch.empty(part.shape, dtype=dtype or t.dtype, device=dev)
        shards.append(out.copy_(part))
    return Sharded(spec, shards, mesh, tuple(t.shape))


def place_host(host, spec, mesh: Mesh) -> Sharded:
    """A host array placed on ``mesh`` by ``spec`` (single process: every
    rank of the mesh is this process's)."""
    return place(np.asarray(host), spec, mesh)


# ---------------------------------------------------------------------------
# Collectives on the data axis (kernel 9)
# ---------------------------------------------------------------------------


def _words(xs):
    """Tensors of 1- and 2-byte elements (adam8bit's int8 codes, bf16
    activations) travel as int32 words of several elements along the last
    dimension: the kernels move f32 and int32, and a gather only moves
    bytes.  Returns the words (or ``xs``) and the dtype to view them back
    as (None when they were not packed)."""
    x0 = xs[0]
    k = 4 // x0.element_size()
    if k > 1 and x0.dim() and x0.shape[-1] % k == 0:
        return [x.contiguous().view(torch.int32) for x in xs], x0.dtype
    return xs, None


def _all_gather(xs, d: int):
    """Kernel 9's ``ag`` of the ranks' blocks along dimension ``d``, in any
    dtype: packed into int32 words where it can (:func:`_words`), else a
    16-bit float through f32 (exact both ways)."""
    ys, packed = _words(xs)
    if packed is not None:
        return [y.contiguous().view(packed)
                for y in ring_all_gather(list(ys), dim=d)]
    dt = xs[0].dtype
    if dt in (torch.bfloat16, torch.float16):
        return [y.to(dt) for y in ring_all_gather([x.float() for x in xs],
                                                   dim=d)]
    return ring_all_gather(list(xs), dim=d)


def _gather_axis(shards, mesh: Mesh, axis: str, d: int) -> list:
    """Each group along ``axis`` all-gathers its ranks' blocks of dimension
    ``d`` (one kernel-9 call a group); returns the whole blocks in the
    flat rank order."""
    out = list(shards)
    for group in mesh.groups(axis):
        for r, y in zip(group, _all_gather([shards[r] for r in group], d)):
            out[r] = y
    return out


def reshard(leaf: Sharded, spec, own: bool = False) -> Sharded:
    """``leaf`` on ``spec``, axis by axis: unchanged where an axis keeps its
    dimension (or has one rank); a dimension an axis no longer shards is
    first all-gathered over that axis's groups (kernel 9's ``ag``); a
    dimension an axis is to shard is sliced from each rank's whole extent,
    which moves nothing.  ``own=True`` (what a resident leaf needs) makes
    each moved shard contiguous memory of its own: a slice's whole copy can
    then be freed, and a leaf gathered along another than its leading
    dimension is stored in its own layout (a product's GEMM takes another
    algorithm, and other roundings, on a transposed operand)."""
    spec = _full(spec, leaf.ndim)
    mesh = leaf.mesh
    moves = [(axis, _axis_dim(leaf.spec, axis), _axis_dim(spec, axis))
             for axis in mesh.axis_names]
    moves = [m for m in moves if m[1] != m[2] and mesh.shape[m[0]] > 1]
    shards, sliced = leaf.shards, False
    for axis, d_from, _ in moves:
        if d_from is not None:
            shards = _gather_axis(shards, mesh, axis, d_from)
    for axis, _, d_to in moves:
        if d_to is not None:
            s = leaf.shape[d_to] // mesh.shape[axis]
            shards = [x.narrow(d_to, mesh.coord(r, axis) * s, s)
                      for r, x in enumerate(shards)]
            sliced = True
    if own and moves:
        shards = [x.clone(memory_format=torch.contiguous_format) if sliced
                  else x.contiguous() for x in shards]
    return Sharded(spec, shards, mesh, leaf.shape)


def reduce_mean(xs, spec, mesh: Mesh) -> Sharded:
    """The mean over the data axis of the ranks' tensors ``xs`` (one per
    rank in the flat order, each the rank's block of the dimensions the
    spec's other axes mark), on ``spec``: each data group (one per rank of
    the other axes)
    makes its own call, an all-reduce (``ar``) for a spec without the data
    axis, a reduce-scatter (``rs``) over its data dimension otherwise; the
    1/dp is the collective's scale.  With equal shards of a global batch,
    the mean of the ranks' batch means is the global batch mean."""
    spec = _full(spec, xs[0].dim())
    d = _data_dim(spec)
    dp = mesh.shape.get(DATA_AXIS, 1)
    shape = list(xs[0].shape)
    for axis in mesh.axis_names:
        m = _axis_dim(spec, axis)
        if axis != DATA_AXIS and m is not None:
            shape[m] *= mesh.shape[axis]
    out = list(xs)
    for group in mesh.groups(DATA_AXIS):
        part = [xs[r] for r in group]
        if d is None:
            red = ring_all_reduce_bidir(part, scale=1.0 / dp)
        else:
            red = ring_reduce_scatter(part, scale=1.0 / dp, dim=d)
        for r, y in zip(group, red):
            out[r] = y
    return Sharded(spec, out, mesh, tuple(shape))


# ---------------------------------------------------------------------------
# The ZeRO rules
# ---------------------------------------------------------------------------


def _leaf_spec(x) -> Optional[Spec]:
    """A leaf's spec now: its own for a :class:`Sharded`, none for a tensor
    or array; ``None`` for what is no array (a Python scalar)."""
    if isinstance(x, Sharded):
        return x.spec
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return (None,) * x.ndim
    return None


def _data_extended_sharding(x, mesh: Mesh, dp: int) -> Optional[Spec]:
    """The shared ZeRO dim-choice rule (the JAX package's): extend a leaf's
    spec by the data axis on the FIRST spec-free dimension the dp size
    divides.  ``None`` (leave untouched) for scalars, empty leaves,
    non-divisible leaves and leaves already sharded over data.  A
    ``MODEL_AXIS`` entry counts as used even on a model axis of 1."""
    spec = _leaf_spec(x)
    if spec is None:
        return None
    return extend_spec(spec, tuple(x.shape), dp)


def extend_spec(spec, shape, dp: int) -> Optional[Spec]:
    """The rule of :func:`_data_extended_sharding` on a spec and a shape."""
    if dp <= 1 or not shape or math.prod(shape) == 0:
        return None
    spec = list(_full(spec, len(shape)))
    if DATA_AXIS in spec:
        return None
    for ax in range(len(shape)):
        if spec[ax] is None and shape[ax] % dp == 0:
            spec[ax] = DATA_AXIS
            return tuple(spec)
    return None


def _dp(mesh: Mesh) -> int:
    return dict(mesh.shape).get(DATA_AXIS, 1)


def _tree_leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _tree_leaves(t)]
    return [] if tree is None else [tree]


def _tree_unflatten(template, leaves):
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, (tuple, list)):
            vals = [build(x) for x in t]
            if hasattr(t, "_fields"):
                return type(t)(*vals)
            return type(t)(vals)
        return next(it)

    return build(template)


class Pin:
    """A reshard of a same-length tuple of leaves onto ``specs`` (one spec or
    ``None``, leave untouched, per leaf): the port's form of the JAX
    package's in-step sharding pins.  Calling it reshards with ``own=True``
    (the result is resident); ``specs`` tells a step which reduction or
    gather a leaf takes."""

    def __init__(self, specs, what: str):
        self.specs, self.what = tuple(specs), what

    def __call__(self, leaves):
        leaves = tuple(leaves)
        if len(leaves) != len(self.specs):
            raise ValueError(f"{self.what}: expected {len(self.specs)} "
                             f"leaves, got {len(leaves)}")
        return tuple(x if sh is None else reshard(x, sh, own=True)
                     for x, sh in zip(leaves, self.specs))


class TreePin(Pin):
    """:class:`Pin` over the leaves of a pytree of tuples (an optimizer
    state), which must keep its structure across the update."""

    def __call__(self, tree):
        leaves = _tree_leaves(tree)
        if len(leaves) != len(self.specs):
            raise ValueError(
                f"{self.what} changed structure across the update "
                f"({len(self.specs)} leaves at init, {len(leaves)} after)")
        return _tree_unflatten(tree, super().__call__(leaves))


def pin_shardings(shs, what: str = "leaves") -> Optional[Pin]:
    """A :class:`Pin` onto ``shs``, or ``None`` when there is nothing to
    pin (every entry ``None``)."""
    shs = tuple(shs)
    if not any(sh is not None for sh in shs):
        return None
    return Pin(shs, what)


def pin_inherited(tree, what: str = "optimizer state") -> Optional[TreePin]:
    """A pin keeping every :class:`Sharded` leaf of a same-structure tree on
    the spec it holds NOW (the ZeRO-3 optimizer state, whose moments
    inherited their params' data-extended specs), or ``None`` when no leaf
    is sharded over the data axis."""
    shs = [x.spec if isinstance(x, Sharded) and x.dim is not None else None
           for x in _tree_leaves(tree)]
    if not any(sh is not None for sh in shs):
        return None
    return TreePin(shs, what)


def zero1_shardings(opt_state, mesh: Mesh):
    """ZeRO-1 specs for an optimizer-state tree: each array leaf's inherited
    spec (a moment built from a placed param carries its param's) extended
    by the data axis (:func:`_data_extended_sharding`).  Returns
    ``(flat_specs, template)``: a spec or ``None`` per flattened leaf, and
    the tree whose structure they follow."""
    dp = _dp(mesh)
    return [_data_extended_sharding(x, mesh, dp)
            for x in _tree_leaves(opt_state)], opt_state


def zero1_place(opt_state, mesh: Mesh):
    """Place an optimizer-state tree by its ZeRO-1 specs and return
    ``(placed_state, constrain)``; ``constrain`` (a :class:`TreePin`) keeps
    the updated state on them, or is ``None`` when nothing sharded (no data
    axis, dp == 1, or no divisible leaf), which the caller treats as a
    loud no-op."""
    shs, _ = zero1_shardings(opt_state, mesh)
    if not any(sh is not None for sh in shs):
        return opt_state, None
    pin = TreePin(shs, "shard_opt_state requires a structure-stable "
                       "optimizer: optimizer state")
    return pin(opt_state), pin


def zero2_grad_shardings(leaves, mesh: Mesh):
    """ZeRO-2 gradient specs: each placed training leaf's spec extended by
    the same rule as the ZeRO-1 moments, so a gradient shard and its
    moments' shards coincide dimension for dimension and the update needs
    no collective.  A gradient with a spec reduces by reduce-scatter."""
    dp = _dp(mesh)
    return tuple(_data_extended_sharding(x, mesh, dp) for x in leaves)


def zero2_grad_constrain(leaves, mesh: Mesh) -> Optional[Pin]:
    """A :class:`Pin` onto the ZeRO-2 gradient specs of the placed
    ``leaves``, or ``None`` when nothing can shard."""
    return pin_shardings(zero2_grad_shardings(leaves, mesh),
                         what="zero_stage=2 gradient shards")


def zero3_param_place(leaves, mesh: Mesh):
    """ZeRO-3 parameter sharding: each placed training leaf's spec extended
    by the data axis (the same rule), so between steps each rank holds
    only its 1/dp block of every divisible leaf.  Returns ``(placed,
    unshard, constrain, specs)``: the resharded leaves, the gather at use
    (a :class:`Pin` back onto the original specs: an all-gather each), the
    pin of the updated leaves onto their shards, and the extended spec or
    ``None`` per leaf (also the gradients' specs).  When nothing can shard
    the leaves come back untouched with both pins ``None``."""
    flat = tuple(leaves)
    shs = tuple(_data_extended_sharding(x, mesh, _dp(mesh)) for x in flat)
    if not any(sh is not None for sh in shs):
        return flat, None, None, shs
    orig = tuple(None if sh is None else x.spec for x, sh in zip(flat, shs))
    placed = tuple(x if sh is None else reshard(x, sh, own=True)
                   for x, sh in zip(flat, shs))
    return (placed, Pin(orig, "zero_stage=3 gathered params"),
            Pin(shs, "zero_stage=3 param shards"), shs)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def check_mesh(mesh, caller: str) -> Mesh:
    """Refuse what this package cannot train or serve on: anything but a
    :class:`Mesh`, and groups of ranks (along any axis) that are not all on
    the CPU or all on CUDA cards with peer access between ring
    neighbours."""
    from .collective_kernels import RankGroup

    if not isinstance(mesh, Mesh):
        raise ValueError(f"{caller}: mesh must be a tensor_ops_tpu_torch "
                         f"parallel.Mesh (make_mesh), got {mesh!r}")
    for axis in mesh.axis_names:
        for group in mesh.groups(axis):
            RankGroup(devices=[mesh.rank_devices[r] for r in group])
    return mesh


def _placed(params, specs, mesh: Mesh) -> tuple:
    return tuple(p if isinstance(p, Sharded) else place(p, s, mesh)
                 for p, s in zip(params, specs))


def shard_network(net, mesh: Mesh):
    """The network with its parameters placed on ``mesh`` by
    :func:`param_specs` (as :class:`Sharded` leaves)."""
    from ..models.feedforward import Network

    check_mesh(mesh, "shard_network")
    specs = param_specs(net.param_stack, mesh)
    return Network(net.op, tuple(place(p, s, mesh)
                                 for p, s in zip(net.params, specs)),
                   net.act_names)


def shard_fused(fm, mesh: Mesh):
    """Tensor-parallel serving: a ``FusedMLP`` whose weights and biases
    are placed by :func:`param_specs` (Megatron's alternation over the
    model axis, replicated over the data axis) as :class:`Sharded` leaves.
    Its ``run_xla`` then runs each layer's row- or column-parallel form
    with kernel 9's collectives between them (:func:`.tp.fused_forward`),
    and ``Predictor`` routes every request there: the fused kernels cannot
    take sharded weights.  Use when one model's weights exceed a card."""
    from ..models.fast import FusedMLP

    check_mesh(mesh, "shard_fused")
    stack = []
    for w, b in zip(fm.weights, fm.biases):
        stack += [tuple(w.shape), tuple(b.shape)]
    specs = param_specs(tuple(stack), mesh)
    ws = tuple(place(w, specs[2 * k], mesh) for k, w in enumerate(fm.weights))
    bs = tuple(place(b, specs[2 * k + 1], mesh)
               for k, b in enumerate(fm.biases))
    return FusedMLP(ws, bs, fm.acts, fm.softmax_out, fm.precision,
                    fm.loss_kind)


def _rank_backend(be, device):
    from ..backend.torch_backend import TorchBackend

    return be if torch.device(be.device) == device else TorchBackend(
        be.dtype, device)


def _split_rows(xb, dp: int, r: int, device, chunks: int = 1):
    """Rank ``r``'s rows of a global batch: of each of ``chunks`` equal
    chunks, its r-th of dp equal parts (the batch sharded over the data
    axis, chunk by chunk), on ``device``."""
    rest = tuple(xb.shape[1:])
    rows = xb.shape[0] - xb.shape[0] % chunks
    micro = rows // chunks
    if micro % dp:
        raise ValueError(
            f"a batch of {xb.shape[0]} rows ({chunks} chunk(s) of {micro}) "
            f"does not split evenly over the {dp} data ranks")
    part = xb[:rows].reshape((chunks, dp, micro // dp) + rest)[:, r]
    return part.reshape((-1,) + rest).to(device)


def _replicas(mesh: Mesh):
    """The model groups of ``mesh`` (one per data and stage coordinate, in
    the flat order; on a ``(data, model)`` grid one per data rank), each
    with its data rank: every group runs its data rank's rows on its own
    copy of the leaves, which ``param_specs`` replicates over a stage
    axis."""
    return [(g, mesh.coord(g[0], DATA_AXIS)) for g in mesh.groups(MODEL_AXIS)]


def group_executors(net, be, mesh: Mesh, compute=None) -> list:
    """One :class:`~.tp.TpNetwork` per model group (:func:`_replicas`), the
    leaves on ``param_specs``."""
    from .tp import TpNetwork

    specs = param_specs(net.param_stack, mesh)
    return [TpNetwork(net, specs, [mesh.rank_devices[r] for r in g], be,
                      compute) for g, _ in _replicas(mesh)]


def sharded_train_step(net, loss, be, mesh: Mesh) -> Callable:
    """Multi-rank minibatch SGD ``fn(rate, xb, yb, *params) -> (mean_loss,
    new_params)``: the batch splits over the data ranks; each data rank
    takes its rows' mean gradient on its copy of the params (on a model
    axis > 1 through :mod:`.tp`'s executor on its model group, each rank
    its blocks); each leaf's gradients are reduced over the data axis to
    their mean (kernel 9, scale 1/dp, one call per model rank) before
    every rank takes the same step.  On a mesh with a stage axis every
    leaf is replicated over it, as the JAX package's ``param_specs``
    leaves it: each stage coordinate's model groups take the same step on
    their own copies.  ``params`` are :class:`Sharded` leaves
    (:func:`shard_network`) or tensors, which are placed first; the new
    params come back as :class:`Sharded` leaves and the loss as a 0-d
    tensor on rank 0's device."""
    from ..models.training import make_mean_grads

    check_mesh(mesh, "sharded_train_step")
    specs = param_specs(net.param_stack, mesh)
    dp = mesh.shape.get(DATA_AXIS, 1)
    reps = _replicas(mesh)
    if mesh.shape.get(MODEL_AXIS, 1) > 1:
        from .tp import group_vag

        vags = [group_vag(t, loss)
                for t in group_executors(net, be, mesh)]
    else:
        mgs = [make_mean_grads(net, loss,
                               _rank_backend(be, mesh.rank_devices[g[0]]))
               for g, _ in reps]
        vags = [lambda x, y, ps, mg=mg: mg(x, y, *ps) for mg in mgs]

    def step(rate, xb, yb, *params):
        params = _placed(params, specs, mesh)
        n = len(params)
        vals, grads = [], [None] * mesh.size
        for (g, d), vag in zip(reps, vags):
            dev = mesh.rank_devices[g[0]]
            v, gr = vag(_split_rows(xb, dp, d, dev),
                        _split_rows(yb, dp, d, dev),
                        tuple(p.shards[r] for r in g for p in params))
            if mesh.coord(g[0], STAGE_AXIS) == 0:
                vals.append(v.reshape(1))
            for m, r in enumerate(g):
                grads[r] = gr[m * n:(m + 1) * n]
        v = ring_all_reduce_bidir(vals, scale=1.0 / dp)[0].reshape(())
        new = []
        for i, p in enumerate(params):
            g = reduce_mean([gr[i] for gr in grads], p.spec, mesh)
            new.append(p.map(lambda a, b: a - rate * b, g))
        return v, tuple(new)

    return step


def sharded_forward(net, be, mesh: Mesh) -> Callable:
    """Multi-rank batched inference ``fn(xb, *params) -> yb``: each data
    rank runs its rows of the batch (on a model axis > 1 through
    :mod:`.tp`'s executor on its model group; on a stage axis the model
    groups of stage 0, the others holding the same copies); the rows come
    back in order on rank 0's device (a gather of outputs, not a
    reduction)."""
    from ..models.training import _vmap

    check_mesh(mesh, "sharded_forward")
    specs = param_specs(net.param_stack, mesh)
    dp = mesh.shape.get(DATA_AXIS, 1)
    reps = [(k, g, d) for k, (g, d) in enumerate(_replicas(mesh))
            if mesh.coord(g[0], STAGE_AXIS) == 0]
    runs = None
    if mesh.shape.get(MODEL_AXIS, 1) > 1:
        runs = group_executors(net, be, mesh)

    def fwd(xb, *params):
        params = _placed(params, specs, mesh)
        outs = []
        for k, g, d in reps:
            dev = mesh.rank_devices[g[0]]
            x = _split_rows(xb, dp, d, dev)
            if runs is not None:
                ps = [tuple(p.shards[r] for p in params) for r in g]
                outs.append(runs[k].forward(x, ps))
                continue
            be_r = _rank_backend(be, dev)

            def single(x, *ps, be_r=be_r):
                return net.op.apply(be_r, (x,) + ps)[0]

            run = _vmap(single, 1, len(params))
            outs.append(run(x, *(p.shards[g[0]] for p in params)))
        rows = ring_all_gather([o.reshape(o.shape[0], -1) for o in outs])[0]
        return rows.reshape((xb.shape[0],) + tuple(outs[0].shape[1:]))

    return fwd
