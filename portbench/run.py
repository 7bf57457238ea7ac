"""The benchmark of ``erl_gaussian_process_tpu_torch`` on one NVIDIA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` once, from the root of a checkout: set-up
(the kernel library, the cell's inputs, its model, the warm-up of its
shapes), the closed loop for ``--seconds``, with ``--trace 1`` a traced
slice after it, then the check against the plain reference. Standard
error ends with each number compared beside its limit; the last line of
standard output is the result as one JSON object.

Exits with 2, printing no result, without a CUDA card (or with fewer than
the cell asks for), and with 3 if JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from portbench import env  # noqa: E402

env.setup()


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    spec = harness.cell_spec(args.workload)
    chips = int(spec["cell"]["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                           "cuda:0", T0)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded {', '.join(found)}; the benchmark runs "
              "the PyTorch port alone", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        device["busy_s"] = out.get("busy_s", 0.0)
        device["window_s"] = out.get("window_s", 0.0)
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device, "power_limit": power_limit()}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    for w in out["warnings"]:
        print(json.dumps({"warning": w}), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
