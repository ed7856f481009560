"""Run one cell of the benchmark and print its result as the last line of standard output.

    python3 portbench/run.py --workload <config>.<traffic> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. ``--trace 0`` measures the cell's end-to-end
metrics; ``--trace 1`` reads its per-layer metrics from a profiled window
and a window of synchronised spans. Both check what the timed path
produced against the plain reference and print each compared number
beside its limit, on standard error and under ``checks`` in the result.
The run exits with 2, and prints no result, where the card or the cell's
number of cards is missing, and with 3 where a module of JAX or of the JAX
package was loaded.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

STARTED = harness.process_start()


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    cell = harness.find_cell(args.workload)
    imported = harness.time.time()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    res = harness.run_cell(cell, seed=args.seed, seconds=args.seconds, traced=bool(args.trace),
                           device=device, started=STARTED,
                           marks=(("imports", imported), ("CUDA check", harness.time.time())))
    bad = harness.loaded_forbidden()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    print(f"card: {_power_limit()}; peaks {harness.roofline.PEAK_FP32_FLOPS:.3g} flop/s "
          f"float32, {harness.roofline.PEAK_HBM_BYTES:.3g} B/s", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": cell.chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    if args.trace:
        device_info.update(busy_s=res["busy_s"], window_s=res["window_s"])
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": device_info}
    if args.trace:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
