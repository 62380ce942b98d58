"""Run one cell of the benchmark once.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``perfbench/``
and the program (``tensor_ops_tpu_torch``).  It needs as many NVIDIA
cards as the cell asks for and never falls back to the CPU.  The last
line of standard output is the result, one JSON object; the last lines
of standard error are the numbers compared, each beside its limit.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m perfbench.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from perfbench import bench

    try:
        spec = bench.Spec()
        cell = spec.workload(args.workload)
        bench.set_cache_dirs()
        import torch

        if not torch.cuda.is_available():
            raise bench.RunError("no CUDA device is visible: the benchmark "
                                 "runs on the card only")
        if torch.cuda.device_count() < cell["chips"]:
            raise bench.RunError(
                f"{args.workload} needs {cell['chips']} cards, "
                f"{torch.cuda.device_count()} are visible")
        try:
            import tensor_ops_tpu_torch  # noqa: F401
        except ImportError as e:
            raise bench.RunError(f"the program is not here: {e}")
        result = bench.run_cell(spec, args.workload, args.seed, args.seconds,
                                bool(args.trace), "cuda", T_START)
    except bench.RunError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return e.code
    bad = bench.forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}: the port must "
              f"not import JAX or the JAX package", file=sys.stderr)
        return 3
    for line in bench.check_lines(result):
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
