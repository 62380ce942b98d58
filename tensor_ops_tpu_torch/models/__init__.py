"""The models ported so far: activations and losses, feed-forward
networks and their batched training (``training``, and the batched loss
graph of ``batched``), the optimizers (``optim``, ``adam8bit`` among them)
and the production loops ``fit`` and ``fit_sequences`` (``trainer``, with
mixed precision and step chaining, ``chain``), recurrent networks
(``recurrent``), the autoencoder (``autoencoder``), the kernel-fused
``FusedMLP``, ``FusedRNN`` and ``FusedAutoencoder``, the int8
``QuantizedMLP``, and the ``Predictor`` and ``SequencePredictor`` that serve
them.  ``fit`` trains pipeline-parallel on a mesh with a ``stage`` axis, and
tensor-parallel beside it on a ``(data, stage, model)`` mesh
(``parallel.ir_pipeline``)."""

from . import (autoencoder, batched, chain, fast, feedforward, neuralnet,
               optim, recurrent, serve, trainer, training)
from .neuralnet import (
    Activation,
    act_logistic,
    act_map,
    act_map2,
    act_relu,
    act_softmax,
    act_tanh,
    activation_by_name,
    cross_entropy,
    logistic,
    softmax,
    squared_error,
)
from .feedforward import Network, ff_layer, gen_net, lift_net, unchain
from .recurrent import RecurrentNetwork, fully_connected, stateless
from .fast import FusedAutoencoder, FusedMLP, FusedRNN, QuantizedMLP
from .serve import Predictor, SequencePredictor
from .autoencoder import Encoder
from .optim import adam, adam8bit, adamw, momentum, sgd
from .trainer import FitResult, FitSeqResult, fit, fit_sequences
