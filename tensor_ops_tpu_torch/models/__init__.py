"""The models ported so far: activations and losses, feed-forward
networks and their batched training (``training``), recurrent networks
(``recurrent``), the kernel-fused ``FusedMLP`` and ``FusedRNN``, the int8
``QuantizedMLP``, and the ``Predictor`` and ``SequencePredictor`` that serve
them.  ``fit``, the optimizers and the autoencoder come in later slices
(ROADMAP.md, Queue 1)."""

from . import fast, feedforward, neuralnet, recurrent, serve, training
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
from .fast import FusedMLP, FusedRNN, QuantizedMLP
from .serve import Predictor, SequencePredictor
