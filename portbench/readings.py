"""The readings a cell's check limits are set from, on the card:

    python3 portbench/readings.py --workload <cell> --seeds 11,12,... \
        --seconds <s> [--out <file>]

For each seed, in one process: a short run of the cell (the program's own
numbers, the lower readings) and, on the same checked outputs, the control
in the program's place (the plain reference computed in float32 with TF32
matrix products, the precision below the configuration's float32 with TF32
off: the upper readings). Prints one JSON line a seed; ``--out`` also
writes them all to a file. The benchmark's own runs do not run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from portbench import env  # noqa: E402

env.setup()


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("readings: needs a CUDA card", file=sys.stderr)
        return 2
    spec = harness.cell_spec(args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = harness.run_cell(spec, seed, args.seconds, False, "cuda:0", t0,
                               control=True)
        row = {"workload": args.workload, "seed": seed,
               "program": {k: c["value"] for k, c in out["checks"].items()},
               "control": out.get("control_numbers"),
               "diagnostics": out.get("diagnostics"),
               "metrics": {k: m["value"] for k, m in out["metrics"].items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
