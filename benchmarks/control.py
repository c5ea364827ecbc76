"""Readings for the limits of `correct`: for each seed, the numbers that
the program's sampled requests give (the lower readings) and those that
the cell's control gives in the program's place (the upper readings), in
one process. The benchmark's own runs never run this.

    python3 benchmarks/control.py --workload <cell> --seeds 1 2 3 ... [--out FILE]

Each seed prints one JSON line {"seed", "program": {...}, "control": {...}}.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    harness.cache_dirs()
    cell = harness.load_cell(args.workload)
    harness.require_cuda(cell["chips"])
    driver = harness.load_driver(cell["traffic"]["driver"])
    lines = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        line = dict(seed=seed, **driver.readings(cell, seed, cell["config"]["control"]))
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(dict(line, workload=args.workload)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
