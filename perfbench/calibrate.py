"""The readings a cell's limits are set from, on the card, in one process.

    python3 -m perfbench.calibrate --workload <name> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--faults half_batch] [--seconds 3]

For each of ``--seeds``, the numbers a run compares, from the program at
the cell's own size (set-up's checked steps).  For each of
``--control-seeds``, the same numbers from the control (the reference in
TF32 in the program's place) and from each fault of ``--faults`` planted
in the reference put in the program's place (``half_batch``: each step on
the first half of its batch, the mean over that half; the fold: half of
the first chunk).  One JSON line each; nothing is timed, and no window
runs (``--seconds`` only sizes the window a set-up would plan).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import tempfile


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m perfbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    from perfbench import bench

    bench.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("perfbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    spec = bench.Spec()
    from perfbench.precision import full_float32

    full_float32()

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    for seed in ints(args.seeds):
        with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
            ctx = bench.Context(spec, args.workload, seed, args.seconds,
                                False, "cuda", tmp=tmp)
            d = spec.driver(ctx.traffic["driver"]).Driver(ctx)
            d.setup()
            d.release()
            gc.collect()
            torch.cuda.empty_cache()
            line = {"workload": args.workload, "side": "program",
                    "seed": seed, "numbers": d.check()}
            if hasattr(d, "program_readings"):
                # each step's loss and each leaf's norms, both sides
                line["program"] = vars(d.program_readings())
                line["reference"] = vars(d.reference_readings("f64"))
            print(json.dumps(line), flush=True)
    for seed in ints(args.control_seeds):
        for kind in ["tf32"] + [f for f in args.faults.split(",") if f]:
            ctx = bench.Context(spec, args.workload, seed, args.seconds,
                                False, "cuda")
            d = spec.driver(ctx.traffic["driver"]).Driver(ctx)
            print(json.dumps({"workload": args.workload, "side": kind,
                              "seed": seed, "numbers": d.control(kind)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
