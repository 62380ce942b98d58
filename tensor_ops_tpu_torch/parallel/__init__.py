"""Data parallelism: the ring collectives (kernels 8 and 9), the
data-parallel whole-step trainer, and the mesh's data axis (``mesh``:
:func:`make_mesh`, :func:`param_specs`, the sharded leaf :class:`Sharded`,
the ZeRO rules, :func:`sharded_train_step` and :func:`sharded_forward`,
which ``fit`` and ``fit_sequences`` train on).  Still to port from the JAX
package's ``parallel``: the model axis (tensor parallelism and
``shard_fused``, ROADMAP.md Queue 1 item 9b), the pipelines (``pipeline``,
``ir_pipeline``, item 9c), and ``plan`` and ``distributed`` with training in
several processes (item 9d)."""

from .collective_kernels import (RankGroup, dp_megakernel_train_step,
                                 ring_all_gather, ring_all_reduce,
                                 ring_all_reduce_bidir, ring_reduce_scatter)
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, Sharded, batch_spec,
                   make_mesh, param_specs, place, place_host, shard_network,
                   sharded_forward, sharded_train_step, zero1_place,
                   zero1_shardings, zero2_grad_constrain, zero3_param_place)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "RankGroup",
    "Sharded",
    "batch_spec",
    "dp_megakernel_train_step",
    "make_mesh",
    "param_specs",
    "place",
    "place_host",
    "ring_all_gather",
    "ring_all_reduce",
    "ring_all_reduce_bidir",
    "ring_reduce_scatter",
    "shard_network",
    "sharded_forward",
    "sharded_train_step",
    "zero1_place",
    "zero1_shardings",
    "zero2_grad_constrain",
    "zero3_param_place",
]
