from .base import (Backend, CustomDistribution, Distribution, beta,
                   custom, exponential, gamma, normal, uniform)
from .torch_backend import TorchBackend
