"""Run one cell of the benchmark once, on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's pieces are found by name
(`benchkit.spec`). Prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit, which also end standard error. Exits
non-zero, printing no result, where no card (or too few) is visible, or
where JAX or the JAX package was loaded."""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchkit.spec import Spec

    chips = Spec(ROOT).cell(args.workload).get("chips", 1)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: the cell needs {chips} card(s); {n} visible", file=sys.stderr)
        return 3
    import repro_torch  # noqa: F401  (fails here, printing nothing, without the program)

    from benchkit.harness import execute

    out = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  root=ROOT, device="cuda", t_process=T_PROCESS)
    if out["banned"]:
        print(f"bench: the run loaded {out['banned']} (JAX or the JAX package)",
              file=sys.stderr)
        return 4
    for note in out["notes"]:
        print(f"bench: {note}", file=sys.stderr)
    for name, value, limit in out["checks"]:
        verdict = "ok" if value <= limit else "FAILS"
        print(f"check {name} {value!r} limit {limit!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
