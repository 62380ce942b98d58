"""The models ported so far: activations and losses, feed-forward
networks and their batched training (``training``), the kernel-fused
``FusedMLP``, the int8 ``QuantizedMLP`` and the ``Predictor`` that serves
them.  ``fit``, the
optimizers, recurrent and autoencoder models come in later slices
(ROADMAP.md, Queue 1)."""

from . import fast, feedforward, neuralnet, serve, training
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
from .fast import FusedMLP, QuantizedMLP
from .serve import Predictor
