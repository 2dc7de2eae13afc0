#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 ... --control-seeds 1 2 3 [--seconds 2]

For each of ``--seeds`` it runs the cell as a run does, with a short
window, and prints the compared numbers of the program (the lower
readings).  For each of ``--control-seeds`` it puts the plain reference,
computed one precision below the configuration's (bfloat16 for float32),
in the program's place and prints the same numbers (the upper readings).
All in one process, so that set-up is paid once per seed and not per
process.  The benchmark's own runs never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# The precision one step below each configuration's.
LOWER = {"float64": "float32", "float32": "bfloat16", "bfloat16": "float8_e4m3fn"}


def program_numbers(cell, config, seed, seconds, device="cuda", log=print):
    """The compared numbers of one short run of the program."""
    from benchmark import harness
    from benchmark.traffic.common import Context

    driver = harness.load_module("traffic", cell["driver"]).setup(
        Context(cell, config, seed, device, log))
    window = harness.run_window(driver.step, seconds)
    return driver.check(), len(window.times)


def control_numbers(cell, config, seed, device="cuda", log=print):
    """The compared numbers of the reference one precision below, in the
    program's place."""
    from benchmark import harness
    from benchmark.traffic.common import Context

    module = harness.load_module("traffic", cell["driver"])
    lower = LOWER[config["dtype"]]
    return module.control(Context(cell, config, seed, device, log), lower)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    from benchmark import harness

    cell, config = harness.load_cell(args.workload)
    log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
    log(f"card: {harness.power_limit()}")
    for seed in args.seeds:
        t0 = time.perf_counter()
        nums, calls = program_numbers(cell, config, seed, args.seconds, log=log)
        print(json.dumps({"side": "program", "seed": seed, "calls": calls,
                          "numbers": {n: v for n, v, _ in nums},
                          "seconds": time.perf_counter() - t0}), flush=True)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        nums = control_numbers(cell, config, seed, log=log)
        print(json.dumps({"side": "control", "seed": seed,
                          "numbers": {n: v for n, v, _ in nums},
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
