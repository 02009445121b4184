"""The control of a cell's correctness check: the program with its own
lower-precision path switched on must come out not correct.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        [--calls 4] [--sound]

For each seed it runs the cell's driver at the cell's own size for a fixed
number of chained calls, with the program's truncated bootstrap key
(``bsk_drop_planes=1``: the lowest base-256 digit plane of every key word
dropped, 24 of its 32 bits kept, the path of the program's
``TFHE_BOOT_128_K4T``; its "auto" entry pins it to the "mxu" backend), and
prints one JSON line a seed with the numbers the check compares.  With
``--sound`` it runs the program as the configuration states instead, for
the lower readings.  Needs a card, as a benchmark run does.  The
benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402

TRUNCATED = {"bsk_drop_planes": 1}


def readings(cell: harness.Cell, seed: int, calls: int, device,
             sound: bool = False) -> dict:
    """The compared numbers of one control (or, with ``sound``, one sound)
    run of ``calls`` chained calls on ``device``."""
    ctx = harness.Context(cell=cell, seed=seed, seconds=0.0, trace=False,
                          device=device, t_start=time.perf_counter(),
                          params_override={} if sound else dict(TRUNCATED),
                          calls=calls)
    result, _ = harness.run_cell(cell, ctx)
    return {"seed": seed, "sound": sound, "correct": result["correct"],
            "checks": result["checks"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--calls", type=int, default=4)
    ap.add_argument("--sound", action="store_true")
    args = ap.parse_args(argv)
    try:
        cell = harness.load_cell(args.workload)
        harness.set_cache_dirs()
        harness.import_program()
        device = harness.require_cards(cell.chips)
    except harness.RunError as e:
        print(f"control: {e}", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, args.calls, device,
                                  args.sound)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
