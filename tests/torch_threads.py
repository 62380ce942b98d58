"""One torch intra-op thread for the port's CPU tests.

The port's pipelines and meshes run thousands of small eager operations a
step on CPU ranks.  Under ``pytest -n 6`` every worker's torch thread pool
(one thread a core, spinning between parallel regions) competes with the
other workers' pools and with the JAX package's 8 virtual CPU devices,
whose collectives rendezvous under XLA's 40 s termination timeout: with
one pool thread a step of those small operations takes a fraction of the
time, and leaves the cores to the other workers.  Each port test module
imports :func:`one_torch_thread`; it sets the thread count for the
module's tests and restores it after them.  A sum or a product takes the
same bits with one thread or several at these shapes, and no test compares
runs made under different thread counts."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
