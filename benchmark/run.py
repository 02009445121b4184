"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout, on a machine that holds the cards the
cell asks for.  With ``--trace 0`` the result carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics read from a profiled
stretch of calls.  The last line of standard output is the result's JSON
object; the last lines of standard error are the numbers compared to
decide ``correct``, each beside its limit.  Without a card, without the
program in this checkout, or with a JAX module loaded once the window has
closed, it prints no result and exits non-zero.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        cell = harness.load_cell(args.workload)
        harness.set_cache_dirs()
        harness.import_program()
        device = harness.require_cards(cell.chips)
        ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), device=device,
                              t_start=T_START)
        result, _ = harness.run_cell(cell, ctx)
        banned = harness.banned_modules(sys.modules)
        if banned:
            raise harness.RunError("modules that no run may load are "
                                   f"loaded: {', '.join(banned)}")
    except harness.RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(f"correct = {str(result['correct']).lower()}", file=sys.stderr,
          flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
