"""Parallelism: the ring collectives (kernels 8 and 9), the data-parallel
whole-step trainer, the device mesh (``mesh``: :class:`Mesh`, an n-D grid
of named axes; :func:`make_mesh`, :func:`param_specs`, the sharded leaf
:class:`Sharded`, the ZeRO rules, :func:`sharded_train_step`,
:func:`sharded_forward` and :func:`shard_fused`, which ``fit``,
``fit_sequences`` and ``Predictor`` run on), the tensor-parallel executor
of the model axis (``tp``) and the segment matching it runs on
(``ir_pipeline``), and the GPipe and circular pipelines on a ``stage``
axis (``pipeline``).  Still to port from the JAX package's ``parallel``:
the staged-IR pipelines (the rest of ``ir_pipeline``, ROADMAP.md Queue 1
items 9c-2 and 9c-3), and ``plan`` and ``distributed`` with training in
several processes (item 9d)."""

from .collective_kernels import (RankGroup, dp_megakernel_train_step,
                                 ring_all_gather, ring_all_reduce,
                                 ring_all_reduce_bidir, ring_reduce_scatter)
from .mesh import (DATA_AXIS, MODEL_AXIS, STAGE_AXIS, Mesh, Sharded, batch_spec,
                   make_mesh, param_specs, place, place_host, shard_fused,
                   shard_network, sharded_forward, sharded_train_step,
                   zero1_place, zero1_shardings, zero2_grad_constrain,
                   zero3_param_place)
from .tp import TpNetwork

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "STAGE_AXIS",
    "Mesh",
    "RankGroup",
    "Sharded",
    "TpNetwork",
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
    "shard_fused",
    "shard_network",
    "sharded_forward",
    "sharded_train_step",
    "zero1_place",
    "zero1_shardings",
    "zero2_grad_constrain",
    "zero3_param_place",
]
