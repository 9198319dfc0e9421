"""The readings that the limits of ``correct`` are set from, in one
process: the program's numbers on each ``--seeds`` seed (a run with a
short window), the control's (the reference in fp8 in the program's
place) on each ``--control`` seed, and each planted fault's on each
``--faults`` seed. Prints one JSON line a reading, with ``correct`` as a
run decides it (`harness.verdict` against the cell's limits); run from
the root of a checkout on the card:

    python3 bench/calibration/readings.py --workload <cell> --seeds 1,2 \\
        --control 1,2,3 --faults half_sequence:1,2,3 [--seconds 3]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT / "src")]


def _ints(text):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", action="append", default=[],
                    help="<fault>:<seed>,<seed>,... (a fault of calibration.faults.FAULTS)")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT),
                    help="where BENCHMARK.json is (default: this checkout)")
    args = ap.parse_args(argv)

    from benchkit import harness
    from benchkit.spec import Spec
    from calibration.faults import planted

    root = Path(args.root)
    spec = Spec(root)

    def emit(kind, seed, numbers, t0, extra=None):
        print(json.dumps({"kind": kind, "workload": args.workload, "seed": seed,
                          "numbers": dict(numbers), "s": time.perf_counter() - t0,
                          **(extra or {})}), flush=True)

    def program(kind, seed):
        t0 = time.perf_counter()
        out = harness.execute(args.workload, seed, args.seconds, False, root=root,
                              device=args.device)
        emit(kind, seed, [(n, v) for n, v, _ in out["checks"]], t0,
             {"metrics": out["line"]["metrics"], "correct": out["line"]["correct"]})
        harness.free_device()

    for seed in _ints(args.seeds):
        program("program", seed)
    for seed in _ints(args.control):
        t0 = time.perf_counter()
        ctx = harness.context(spec, args.workload, seed, args.device)
        numbers = harness.driver_of(ctx).control()
        checks = [(n, v, ctx.limits[n]) for n, v in numbers]
        emit("control", seed, numbers, t0, {"correct": harness.verdict(checks)})
        harness.free_device()
    for item in args.faults:
        fault, seeds = item.split(":")
        with planted(spec, fault):
            for seed in _ints(seeds):
                program(f"fault:{fault}", seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
