#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of `workloads` in
`BENCHMARK.json`. The run sets up, warms up the cell's sizes, sends the
seed's requests in a closed loop for `--seconds`, checks a sample of what
the program returned against the plain reference, and prints one JSON
line: `--trace 0` the cell's end-to-end metrics, `--trace 1` its
per-layer metrics from a profiled window. It exits with 2, printing no
result, where there is no CUDA card or fewer than the cell asks for.

`--rank` and `--port` are for the processes of ranks 1 .. n-1, which rank
0 starts itself; `--device cpu`, `--pool-bytes` and `--fault` are for the
tests, which drive a run on the CPU.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _path in (HERE, ROOT):
    if _path not in sys.path:
        sys.path.insert(0, _path)


def parse(argv):
    from pb import start

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    start.add_internal_args(p)
    return p.parse_args(argv)


def chips_missing(need: int) -> str:
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < need:
        return f"the cell needs {need} CUDA devices, {torch.cuda.device_count()} present"
    return ""


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    from pb import start

    cell = start.cell(args.workload, args.pool_bytes, args.extra_cells)
    pool = start.pool(cell, args.seed)
    if args.device == "cuda" and args.rank == 0:
        missing = chips_missing(cell.chips)
        if missing:
            pool[0].shutdown(cancel_futures=True)
            print(f"perfbench: {missing}", file=sys.stderr)
            return 2
    from pb import runner

    run = runner.Runner(cell, args, [os.path.abspath(__file__), *argv], T_START, pool)
    line = run.measure(args.seed, args.seconds, bool(args.trace))
    if not run.close():
        print("perfbench: a rank process failed", file=sys.stderr)
        return 1
    return 0 if line is None else runner.report(line)


if __name__ == "__main__":
    sys.exit(main())
