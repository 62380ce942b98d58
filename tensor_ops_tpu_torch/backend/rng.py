"""RNG plumbing: explicit, reproducible random state.

The reference's ``genRand`` is a Tensor primitive parameterized by any
continuous distribution (``src/TensorOps/Types.hs:93-96``) and its apps
seed from the system RNG non-reproducibly (``app/Dots.hs:130``,
``app/MNIST.hs:250-251``).  The port threads explicit, seeded state, and
so keeps the determinism the JAX package adds: a NumPy ``Generator`` for
the oracle (``NumpyBackend``), as the JAX package does, so one seed draws
the same numbers in both packages; a ``torch.Generator`` on the device for
``TorchBackend``, whose numbers differ from the JAX package's threefry
draws for the same seed (parity tests build their inputs in numpy and hand
them to both packages)."""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..ops.shapes import as_shape
from .base import Backend, Distribution


class Rng:
    """Stateful convenience wrapper over the backend's seeded generator:
    ``np.random.default_rng(seed)`` for the NumPy oracle, a
    ``torch.Generator`` on the device otherwise."""

    def __init__(self, be: Backend, seed: int = 0):
        self.be = be
        if be.name == "numpy":
            self.generator = np.random.default_rng(seed)
        else:
            self.generator = torch.Generator(device=be.device)
            self.generator.manual_seed(int(seed))

    def draw(self, dist: Distribution, shape: Sequence[int]) -> Any:
        return self.be.gen_rand(dist, self.generator, as_shape(shape))

    def shuffle(self, n: int) -> np.ndarray:
        """A permutation of range(n) (epoch shuffling; the reference uses
        mwc ``uniformShuffle``, ``app/MNIST.hs:308``)."""
        if isinstance(self.generator, np.random.Generator):
            return self.generator.permutation(n)
        perm = torch.randperm(n, generator=self.generator,
                              device=self.generator.device)
        return perm.cpu().numpy()
