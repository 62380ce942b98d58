"""Data parallelism over a group of ranks: the ring collectives (kernels 8
and 9) and the data-parallel whole-step trainer.  The rest of the JAX
package's ``parallel`` (``distributed``, ``mesh``, ``pipeline``,
``ir_pipeline``, ``plan``) is not ported yet."""

from .collective_kernels import (RankGroup, dp_megakernel_train_step,
                                 ring_all_gather, ring_all_reduce,
                                 ring_all_reduce_bidir, ring_reduce_scatter)

__all__ = [
    "RankGroup",
    "dp_megakernel_train_step",
    "ring_all_gather",
    "ring_all_reduce",
    "ring_all_reduce_bidir",
    "ring_reduce_scatter",
]
