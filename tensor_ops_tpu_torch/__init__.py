"""tensor-ops-tpu-torch: the PyTorch / CUDA port of ``tensor_ops_tpu``,
for one NVIDIA H100 (Hopper, ``sm_90a``).

The JAX package beside it is the reference this package is tested
against, module by module; this package imports ``torch`` and numpy and
never ``jax``.  Its layout mirrors the JAX package's:

* ``ops.shapes``  — shape/stack algebra (copied: framework-free)
* ``ops.ir``      — the staged ``TOp`` IR + transposition AD (copied)
* ``ops.prim``    — the primitive op library (copied)
* ``ops.introspect`` — op-graph rendering and statistics (copied)
* ``ops.loops``   — ``ScanOp``, ``MappedOp``, ``Remat``: the recurrence and
  batching IR nodes
* ``ops.kernels`` — the hand-written CUDA kernels and their plain versions
* ``backend``     — the 13-primitive Tensor seam: ``TorchBackend`` and the
  float64 NumPy oracle ``NumpyBackend``
* ``engine``      — cached graph callables (eager execution)
* ``tensor``      — the value-level helper API (``Tensor.hs``)
* ``testing``     — the oracles and gradient checkers (``loop_gmul``,
  ``check_grads``, ``check_grads_vs_autograd``)
* ``models``      — activations/losses, feed-forward and recurrent
  networks and their training (the batched loss graph among them), the
  optimizers (``adam8bit`` among them) and the loops ``fit`` and
  ``fit_sequences`` (mixed precision; windows of steps replayed from one
  CUDA graph, ``models.chain``), the autoencoder, ``FusedMLP``,
  ``QuantizedMLP``, ``FusedRNN``, ``FusedAutoencoder``, ``Predictor``,
  ``SequencePredictor``
* ``parallel``    — the ring collectives, the ``(data, model)`` mesh and
  its sharded training and serving, and the GPipe / circular pipelines on
  a ``stage`` axis (``parallel.pipeline``)
* ``utils.native`` — the C++ runtime's threaded loader and kernels
* ``apps``        — the serving CLI (``apps.serve``), the MNIST trainer
  (``apps.mnist``) and the dots demo (``apps.dots``)
"""

from .backend.base import (Backend, CustomDistribution, Distribution,
                           beta, custom, exponential, gamma, normal, uniform)
from .backend.numpy_backend import NumpyBackend
from .backend.torch_backend import TorchBackend
from .ops import prim
from .ops.ir import TOp, grad, run, value_and_grad, vjp
from .ops.shapes import Shape, ShapeError, Stack
from .ops.vfunc import VFunc, vfunc1, vfunc2, vfuncN
from . import engine, tensor

__version__ = "0.1.0"

__all__ = [
    "Backend",
    "CustomDistribution",
    "Distribution",
    "NumpyBackend",
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
    "tensor",
    "run",
    "uniform",
    "value_and_grad",
    "vfunc1",
    "vfunc2",
    "vfuncN",
    "vjp",
]
