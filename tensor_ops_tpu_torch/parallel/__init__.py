"""Parallelism: the ring collectives (kernels 8 and 9), the data-parallel
whole-step trainer, the device mesh (``mesh``: :class:`Mesh`, an n-D grid
of named axes; :func:`make_mesh`, :func:`param_specs`, the sharded leaf
:class:`Sharded`, the ZeRO rules, :func:`sharded_train_step`,
:func:`sharded_forward` and :func:`shard_fused`, which ``fit``,
``fit_sequences`` and ``Predictor`` run on), the tensor-parallel executor
of the model axis (``tp``), the GPipe and circular pipelines of a
``PipelineMLP`` on a ``stage`` axis (``pipeline``) and the staged-IR
pipelines of any ``gen_net`` chain (``ir_pipeline``, ``fit``'s pipeline
mode), on a ``(data, stage, model)`` mesh tensor-parallel too, and the mesh
planner (``plan``: :func:`plan_meshes`, :func:`describe_plans`), and
training in several processes (``distributed``: :func:`init_distributed`
wires them; a mesh then spans every process's ranks)."""

from .distributed import (init_distributed, process_count, process_index,
                          shutdown_distributed)
from .collective_kernels import (RankGroup, dp_megakernel_train_step,
                                 ring_all_gather, ring_all_reduce,
                                 ring_all_reduce_bidir, ring_reduce_scatter)
from .mesh import (DATA_AXIS, MODEL_AXIS, STAGE_AXIS, Mesh, Sharded, batch_spec,
                   make_mesh, param_specs, place, place_host, shard_fused,
                   shard_network, sharded_forward, sharded_train_step,
                   zero1_place, zero1_shardings, zero2_grad_constrain,
                   zero3_param_place)
from .ir_pipeline import (describe_partition, ir_pipeline_grads,
                          ir_pipeline_train_step, make_ir_pipeline_loss,
                          partition_network, partition_network_circular,
                          shard_pipelined_params, split_network,
                          split_network_circular, split_network_hetero,
                          split_network_hetero_circular,
                          split_network_hetero_tp,
                          split_network_hetero_tp_circular, unchain)
from .pipeline import (PipelineMLP, make_3d_pipeline_mesh,
                       make_dp_pipeline_mesh, make_pipeline_mesh,
                       pipeline_forward, pipeline_train_step,
                       shard_pipeline_model)
from .plan import describe_plans, plan_meshes
from .tp import TpNetwork

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "STAGE_AXIS",
    "Mesh",
    "PipelineMLP",
    "RankGroup",
    "Sharded",
    "TpNetwork",
    "batch_spec",
    "describe_partition",
    "describe_plans",
    "dp_megakernel_train_step",
    "init_distributed",
    "ir_pipeline_grads",
    "ir_pipeline_train_step",
    "make_3d_pipeline_mesh",
    "make_dp_pipeline_mesh",
    "make_ir_pipeline_loss",
    "make_mesh",
    "make_pipeline_mesh",
    "param_specs",
    "partition_network",
    "partition_network_circular",
    "pipeline_forward",
    "plan_meshes",
    "pipeline_train_step",
    "process_count",
    "process_index",
    "place",
    "place_host",
    "ring_all_gather",
    "ring_all_reduce",
    "ring_all_reduce_bidir",
    "ring_reduce_scatter",
    "shard_fused",
    "shard_network",
    "shard_pipeline_model",
    "shard_pipelined_params",
    "shutdown_distributed",
    "sharded_forward",
    "sharded_train_step",
    "split_network",
    "split_network_circular",
    "split_network_hetero",
    "split_network_hetero_circular",
    "split_network_hetero_tp",
    "split_network_hetero_tp_circular",
    "unchain",
    "zero1_place",
    "zero1_shardings",
    "zero2_grad_constrain",
    "zero3_param_place",
]
