"""``tensor_ops_tpu_torch.dryrun.entry`` against ``__graft_entry__.entry``
(the port of ``tests/test_graft_entry.py``): the batched forward of the
flagship MLP on 32 rows.  Tolerances: rows summing to 1 within 1e-5 (the
JAX test's), and 1e-5 against the JAX forward on the same parameters and
rows (f32 on both sides) and against the port's own forward in f64."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as G
from tensor_ops_tpu_torch.dryrun import entry
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def jax_entry():
    fn, args = G.entry()
    return [np.asarray(a) for a in args], np.asarray(jax.jit(fn)(*args))


def test_entry_runs_on_the_cpu_when_asked():
    fn, args = entry(device="cpu")
    assert all(a.device.type == "cpu" and a.dtype == torch.float32
               for a in args)
    out = fn(*args)
    assert tuple(out.shape) == (32, 10) and out.dtype == torch.float32
    np.testing.assert_allclose(out.sum(1).numpy(), 1.0, atol=1e-5)


def test_entry_matches_the_jax_entry_on_its_parameters(jax_entry):
    """The same 32 rows (``default_rng(0).uniform``), and the JAX package's
    parameters copied across: the two forwards agree within 1e-5."""
    jargs, jout = jax_entry
    fn, args = entry(device="cpu")
    np.testing.assert_array_equal(args[0].numpy(), jargs[0])
    assert [tuple(a.shape) for a in args] == [a.shape for a in jargs]
    out = fn(*(torch.tensor(a) for a in jargs))
    np.testing.assert_allclose(out.numpy(), jout, atol=1e-5, rtol=0)


def test_entry_forward_in_f64_and_on_one_draw_of_the_weights():
    """The forward takes the dtype it is given (the f64 run the card's
    output is held to), and the weights are drawn on the CPU, so every
    device's ``entry`` serves the same model."""
    fn, args = entry(device="cpu")
    out = fn(*args)
    out64 = fn(*(a.double() for a in args))
    assert out64.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), out64.numpy(), atol=1e-5, rtol=0)
    _, again = entry(device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(args, again))


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default places on it")
    with pytest.raises((AssertionError, RuntimeError)):
        entry()
