"""On the card: the control, the reference computed in TF32 in the
program's place, fails each cell's comparison on three seeds at the cell's
own size; so does each training cell's fault of half the batch, planted in
the reference put in the program's place (``perfbench.calibrate`` prints
the same readings)."""

import pytest

from perfbench import bench
from perfbench.checks import held

SEEDS = [2**31 + 11, 2**31 + 12, 2**31 + 13]
CASES = [(w, kind) for w in ("mlp-fit", "elman-fit", "mlp-fold")
         for kind in ("tf32", "half_batch")]


@pytest.mark.card
@pytest.mark.parametrize("workload,kind", CASES)
def test_control_is_not_correct(card, spec, workload, kind):
    from perfbench.precision import full_float32

    full_float32()
    limits = spec.limits(workload)
    for seed in SEEDS:
        ctx = bench.Context(spec, workload, seed, 3.0, False, card)
        d = spec.driver(ctx.traffic["driver"]).Driver(ctx)
        numbers = d.control(kind)
        rows, ok = held(numbers, limits)
        assert not ok, (seed, rows)
