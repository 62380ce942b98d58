"""The benchmark's tests: ``python -m pytest perfbench/tests`` from the
root of the repository.  The CPU tests run the harness's own path at small
sizes; the tests marked ``card`` need an NVIDIA card and skip without
one (run them on the card with ``python -m pytest perfbench/tests -m
card``)."""

import pytest

# the sizes of a CPU run: the data and traffic cut, every width kept
SMALL = {
    "mlp-fit": {"data": {"train_rows": 1000, "test_rows": 200}},
    "elman-fit": {"data": {"sequences": 64, "length": 16},
                  "traffic": {"batch_size": 8}},
    "mlp-fold": {"data": {"train_rows": 3000, "test_rows": 200},
                 "traffic": {"chunk": 100}},
}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.fixture(scope="session")
def spec():
    """The benchmark as committed."""
    from perfbench import bench

    return bench.Spec()


@pytest.fixture(scope="session")
def small():
    return SMALL
