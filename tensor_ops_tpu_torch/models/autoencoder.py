"""Autoencoders — rebuild of
``src/TensorOps/Learn/NeuralNet/AutoEncoder.hs``: an encoder/decoder pair
of feed-forward networks trained jointly on reconstruction loss by
composing one staged graph (duplicate input, run encode>>decode, swap,
loss) and transposing it once (``encGrad``, ``AutoEncoder.hs:112-142``).
The JAX package's ``tensor_ops_tpu/models/autoencoder.py``, on this
package's IR and engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

from .. import engine
from ..backend.base import Backend
from ..ops import prim as P
from ..ops.ir import First, Second, TOp
from .feedforward import Network


@dataclass
class Encoder:
    """``Encoder t i o`` (``AutoEncoder.hs:37-40``)."""

    encoder: Network  # i -> o
    decoder: Network  # o -> i

    def encode(self, be: Backend, x: Any) -> Any:
        """``encode`` (``AutoEncoder.hs:42-48``)."""
        return self.encoder.run(be, x)

    def decode(self, be: Backend, z: Any) -> Any:
        """``decode`` (``AutoEncoder.hs:50-56``)."""
        return self.decoder.run(be, z)

    def encoder_net(self) -> Network:
        """``encoderNet = encoder >>> decoder`` (``AutoEncoder.hs:81-85``)."""
        return self.encoder.then(self.decoder)

    def encode_decode(self, be: Backend, x: Any) -> Any:
        """``encodeDecode`` (``AutoEncoder.hs:58-63``)."""
        return self.encoder_net().run(be, x)

    # -- joint training ---------------------------------------------------
    def _joint_graph(self, loss: TOp) -> TOp:
        """dup input >> (encode >> decode) on the copy >> swap >> loss: the
        single staged graph whose transpose yields both param-stack
        gradients (``encGrad``, ``AutoEncoder.hs:126-142``; also
        ``testEncoder``'s op, ``AutoEncoder.hs:65-79``)."""
        key = ("enc_joint", loss.struct_key(), self.decoder.op.struct_key())
        g = self.encoder.op._compiled.get(key)
        if g is not None:
            return g
        i_sh = self.encoder.in_shape
        psE = self.encoder.param_stack
        psD = self.decoder.param_stack
        net = First(self.encoder.op, rest=psD) >> self.decoder.op
        g = (
            First(P.duplicate(i_sh), rest=psE + psD)
            >> Second(net, front=[i_sh])
            >> P.swap(i_sh, i_sh)
            >> loss
        )
        self.encoder.op._compiled[key] = g
        return g

    def test_loss(self, loss: TOp, be: Backend, x: Any) -> float:
        """Reconstruction loss (``testEncoder``, ``AutoEncoder.hs:65-79``)."""
        fn = engine.compile_run(self._joint_graph(loss), be)
        return float(fn(x, *self.encoder.params, *self.decoder.params)[0])

    def grad(self, loss: TOp, be: Backend, x: Any
             ) -> Tuple[Tuple[Any, ...], Tuple[Any, ...]]:
        """(encoder grads, decoder grads) (``encGrad``)."""
        fn = engine.compile_grad(self._joint_graph(loss), be)
        grads = fn(x, *self.encoder.params, *self.decoder.params)
        ne = len(self.encoder.params)
        return tuple(grads[1: 1 + ne]), tuple(grads[1 + ne:])

    def _split(self, ps) -> "Encoder":
        ne = len(self.encoder.params)
        return Encoder(
            Network(self.encoder.op, ps[:ne], self.encoder.act_names),
            Network(self.decoder.op, ps[ne:], self.decoder.act_names),
        )

    def train(self, loss: TOp, rate: float, be: Backend, x: Any
              ) -> "Encoder":
        """Joint SGD step on both parameter stacks
        (``trainEncoder``, ``AutoEncoder.hs:87-110``)."""
        gE, gD = self.grad(loss, be, x)
        ps = self.encoder.params + self.decoder.params
        return self._split(tuple(p - rate * g
                                 for p, g in zip(ps, gE + gD)))

    def fit(self, loss: TOp, be: Backend, X, **fit_kwargs
            ) -> Tuple["Encoder", Any]:
        """Production-train the reconstruction objective: ``fit`` on the
        joint ``encoder >>> decoder`` network with targets = inputs (the
        loss graph of ``trainEncoder`` with fit's minibatches, optimizers,
        schedules, metrics and checkpoint/resume).  Returns
        ``(trained_encoder, FitResult)``; the FitResult's ``net`` is the
        joint network."""
        from .trainer import fit as _fit

        res = _fit(self.encoder_net(), loss, be, X, X, **fit_kwargs)
        return self._split(res.net.params), res
