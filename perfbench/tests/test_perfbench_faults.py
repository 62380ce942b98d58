"""A run with the timed path broken underneath comes out not correct:
each cell's run on the CPU (the look for a card skipped), once for each
fault the cell can have, and a window fed the wrong batches.  The
exchange between cards is no fault of these one-card cells."""

import pytest

from perfbench import bench


def _unchanged_step(monkeypatch):
    """Every training step hands back the state it was given."""
    from tensor_ops_tpu_torch.models import trainer

    make, seq = trainer.make_opt_step, trainer._seq_train_step

    def step_keeping(build):
        def wrapped(*a, **k):
            step = build(*a, **k)

            def same(*args):
                out = step(*args)
                return (out[0],) + tuple(args[len(args) - len(out) + 1:])
            return same
        return wrapped

    monkeypatch.setattr(trainer, "make_opt_step", step_keeping(make))
    monkeypatch.setattr(trainer, "_seq_train_step", step_keeping(seq))


def _half_batch(monkeypatch):
    """Every training step sees the first half of its batch, the mean over
    that half."""
    from tensor_ops_tpu_torch.models import trainer

    make, seq = trainer.make_opt_step, trainer._seq_train_step

    def halving(build, n_scalars):
        def wrapped(*a, **k):
            step = build(*a, **k)

            def half(*args):
                xb, yb = args[n_scalars], args[n_scalars + 1]
                n = max(1, xb.shape[0] // 2)
                args = (args[:n_scalars] + (xb[:n], yb[:n])
                        + args[n_scalars + 2:])
                return step(*args)
            return half
        return wrapped

    monkeypatch.setattr(trainer, "make_opt_step", halving(make, 1))
    monkeypatch.setattr(trainer, "_seq_train_step", halving(seq, 2))


def _fold_unchanged(monkeypatch):
    from tensor_ops_tpu_torch.models import training

    monkeypatch.setattr(training, "train_fold", lambda net, *a, **k: net)


def _fold_half(monkeypatch):
    from tensor_ops_tpu_torch.models import training

    real = training.train_fold

    def half(net, loss, be, rate, X, Y):
        n = max(1, X.shape[0] // 2)
        return real(net, loss, be, rate, X[:n], Y[:n])

    monkeypatch.setattr(training, "train_fold", half)


def _one_batch_replayed(monkeypatch):
    """Every step of a window trains on the window's first batch: the
    loops' batch streams hand the chained window's table one batch of
    indices over and over."""
    import numpy as np

    from tensor_ops_tpu_torch.models import trainer
    from tensor_ops_tpu_torch.utils.native import NativeLoader

    for cls in (NativeLoader, trainer._SeqStream):
        real = cls.next_indices

        def first_again(self, real=real):
            idx = real(self)
            keep = getattr(self, "_pb_first", None)
            if keep is None or len(keep) != len(idx):
                self._pb_first = keep = np.array(idx)
            return keep.copy()

        monkeypatch.setattr(cls, "next_indices", first_again)


FAULTS = [
    ("mlp-fit", _unchanged_step), ("mlp-fit", _half_batch),
    ("mlp-fit", _one_batch_replayed),
    ("elman-fit", _unchanged_step), ("elman-fit", _half_batch),
    ("elman-fit", _one_batch_replayed),
    ("mlp-fold", _fold_unchanged), ("mlp-fold", _fold_half),
]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__.strip('_')}"
                              for w, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(spec, small, monkeypatch,
                                            workload, fault):
    fault(monkeypatch)
    r = bench.run_cell(spec, workload, 2**31 + 99, 1.0, False, "cpu",
                       sizes=small[workload])
    assert r["correct"] is False, r["checks"]
