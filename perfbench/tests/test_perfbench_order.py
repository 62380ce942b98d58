"""The batch orders the references follow, worked out without the program
(``perfbench.shuffle``, each family's ``batch_rows``), against the
program's own streams: ``fit``'s native loader and ``fit_sequences``'
sequence stream, over several epochs."""

import numpy as np
import pytest

from perfbench.shuffle import MT19937_64


def test_the_engine_is_mt19937_64():
    g = MT19937_64(5489)
    for _ in range(9999):
        g()
    assert g() == 9981545732273789042  # the C++ standard's check value


@pytest.mark.parametrize("rows,batch,seed", [
    (60000, 100, 2**31 + 301), (1001, 64, 7), (37, 8, 2**40 + 3)])
def test_fit_order_is_the_native_loaders(spec, rows, batch, seed):
    from tensor_ops_tpu_torch.utils.native import NativeLoader

    X = np.zeros((rows, 1), np.float32)
    loader = NativeLoader(X, X, batch=batch, seed=seed, index_mode=True)
    assert loader.is_native
    fam = spec.family("feedforward")
    steps = 3 * fam.steps_per_epoch(rows, batch)
    want = fam.batch_rows(seed, rows, batch, steps)
    got = [loader.next_indices() for _ in range(steps)]
    loader.close()
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("rows,batch,seed", [
    (4096, 256, 2**31 + 301), (70, 8, 5)])
def test_fit_sequences_order_is_its_streams(spec, rows, batch, seed):
    from tensor_ops_tpu_torch.models import trainer

    fam = spec.family("recurrent")
    spe = fam.steps_per_epoch(rows, batch)
    XS = np.zeros((rows, 2, 1), np.float32)
    stream = trainer._SeqStream(XS, XS, batch, seed, 1, spe)
    want = fam.batch_rows(seed, rows, batch, 3 * spe)
    got = [stream.next_indices() for _ in range(1, 3 * spe)]
    assert all(np.array_equal(a, b) for a, b in zip(got, want[1:]))
