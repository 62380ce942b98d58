"""tensor-ops-tpu-torch: the PyTorch / CUDA port of ``tensor_ops_tpu``,
for one NVIDIA H100 (Hopper, ``sm_90a``).

The JAX package beside it is the reference this package is tested
against, module by module; this package imports ``torch`` and numpy and
never ``jax``.  Its layout mirrors the JAX package's:

* ``ops.shapes``  — shape/stack algebra (copied: framework-free)
* ``ops.ir``      — the staged ``TOp`` IR + transposition AD (copied)
* ``ops.prim``    — the primitive op library (copied)
* ``ops.loops``   — ``ScanOp``, ``MappedOp``, ``Remat``: the recurrence and
  batching IR nodes
* ``ops.kernels`` — the hand-written CUDA kernels and their plain versions
* ``backend``     — the 13-primitive Tensor seam: ``TorchBackend``
* ``engine``      — cached graph callables (eager execution)
* ``models``      — activations/losses, feed-forward and recurrent
  networks and their training, ``FusedMLP``, ``QuantizedMLP``,
  ``FusedRNN``, ``Predictor``, ``SequencePredictor``
* ``apps``        — the serving CLI (``apps.serve``) and the MNIST
  trainer (``apps.mnist``)
"""

from .backend.base import (Backend, CustomDistribution, Distribution,
                           beta, custom, exponential, gamma, normal, uniform)
from .backend.torch_backend import TorchBackend
from .ops import prim
from .ops.ir import TOp, grad, run, value_and_grad, vjp
from .ops.shapes import Shape, ShapeError, Stack
from .ops.vfunc import VFunc, vfunc1, vfunc2, vfuncN
from . import engine

__version__ = "0.1.0"

__all__ = [
    "Backend",
    "CustomDistribution",
    "Distribution",
    "Shape",
    "ShapeError",
    "Stack",
    "TOp",
    "TorchBackend",
    "VFunc",
    "beta",
    "custom",
    "engine",
    "exponential",
    "gamma",
    "grad",
    "normal",
    "prim",
    "run",
    "uniform",
    "value_and_grad",
    "vfunc1",
    "vfunc2",
    "vfuncN",
    "vjp",
]
