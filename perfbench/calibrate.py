#!/usr/bin/env python3
"""The readings a cell's limits are set from, in one process (one set-up):

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds <s>

For each of `--seeds` a window of the program over that seed's pool and
its check; for each of `--control-seeds` a window with the configuration's control in the
program's place (`control` in its file) and the same check. Prints each
run's compared numbers on standard error and, as the last line, one JSON
object: {"program": [...], "control": [...], "lower": {...}, "upper":
{...}}, the largest reading of each number over the program's runs and
the smallest over the control's. The benchmark's own runs never run the
control. Run it on the card; `--device cpu`, `--pool-bytes` and `--fault`
(a fault planted in the program, `pb/faults.py`) are for the tests and
for reading a fault's numbers.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
for _path in (HERE, os.path.dirname(HERE)):
    if _path not in sys.path:
        sys.path.insert(0, _path)


def parse(argv):
    from pb import start

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, required=True)
    start.add_internal_args(p)
    args = p.parse_args(argv)
    args.seed_list = [int(s) for s in args.seeds.split(",") if s]
    args.control_list = [int(s) for s in args.control_seeds.split(",") if s]
    args.seed = args.seed_list[0]
    return args


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    from pb import start

    cell = start.cell(args.workload, args.pool_bytes, args.extra_cells)
    pool = start.pool(cell, args.seed)
    from pb import corpus, imports, runner

    run = runner.Runner(cell, args, [os.path.abspath(__file__), *argv], T_START, pool)
    out = {"program": [], "control": []}
    pool_seed = args.seed
    for kind, seeds in (("program", args.seed_list), ("control", args.control_list)):
        for seed in seeds:
            if seed != pool_seed:
                run.session.pool = corpus.make_pool(len(run.session.pool), seed)
                pool_seed = seed
            line = run.measure(seed, args.seconds, False, control=kind == "control")
            if line is None:
                continue
            numbers = {k: c["value"] for k, c in line["checks"].items()}
            print(f"{kind} seed {seed}: {numbers} over {line['attempted']} requests",
                  file=sys.stderr, flush=True)
            out[kind].append({"seed": seed, "correct": line["correct"],
                              "attempted": line["attempted"], "checks": numbers,
                              "metrics": {k: v["value"] for k, v in line["metrics"].items()},
                              "device": line["device"]})
    if not run.close():
        print("calibrate: a rank process failed", file=sys.stderr)
        return 1
    if args.rank != 0:
        return 0
    if imports.forbidden_loaded():
        print(f"calibrate: forbidden modules loaded: {imports.forbidden_loaded()}",
              file=sys.stderr)
        return 3
    for kind, pick, key in (("program", max, "lower"), ("control", min, "upper")):
        runs = out[kind]
        out[key] = {k: pick(r["checks"][k] for r in runs) for k in runs[0]["checks"]} if runs else {}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
