"""The benchmark's one command:

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for. It finds the cell in BENCHMARK.json, its configuration under
configs/, its traffic mix under traffic/ and the driver that the mix names
under drivers/, runs set-up and then the measured window, checks the
outputs against the reference, and prints one JSON line as the last line
of its standard output. With --trace 1 it reports the cell's per-layer
metrics (metrics/<name>.py) in place of its end-to-end ones.

Exit codes: 0 with a result; 2 without one, when the card or the cell is
missing; 3 without one, when a forbidden module (JAX, Flax, the JAX
package) was loaded; 1 on any other failure.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one process with one host thread: the program's host work is launches,
# and a pool of threads spinning beside them makes runs spread
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(cell: dict, out: dict, trace: bool, correct: bool) -> dict:
    """The result's keys from a driver's output."""
    device = harness.device_info(cell["chips"], out["memory_peak"])
    if trace:
        metrics = out["trace"]["metrics"]
        device.update(busy_s=out["trace"]["busy_s"], window_s=out["trace"]["window_s"])
    else:
        metrics = {}
        for m in cell["end_to_end"]:
            if m["name"] not in out["e2e"]:
                raise RuntimeError(f"the driver reported no {m['name']}")
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    res = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
           "metrics": metrics, "device": device}
    if trace:
        res["breakdown"] = out["trace"]["breakdown"]
    return res


def main(argv=None) -> int:
    args = parse(argv)
    harness.cache_dirs()
    try:
        cell = harness.load_cell(args.workload)
        harness.require_cuda(cell["chips"])
    except harness.Refused as e:
        harness.log(f"refused: {e}")
        return 2
    driver = harness.load_driver(cell["traffic"]["driver"])
    harness.log(f"set-up: start and imports {time.perf_counter() - T0:.2f} s")
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace), T0)
    limits = harness.limits(cell)
    for k, v in out["numbers"].items():
        if k not in limits:
            harness.log(f"reading {k}: {v!r} (not compared)")
    ok, checks = harness.judge(out["numbers"], limits)
    ok = ok and out["failed"] == 0 and out["attempted"] > 0
    return harness.emit(result_line(cell, out, bool(args.trace), ok), checks)


if __name__ == "__main__":
    sys.exit(main())
