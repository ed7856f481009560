"""A cell's end-to-end metrics over several batch sizes, in one process on the card.

    python3 portbench/sweep.py --workload <cell> --rows 16,32,64 --seed <n> --seconds <s> [--trace 1]

Each size runs the cell's set-up, its window and its check with the mix's
``rows`` replaced, and prints one JSON line: the metrics, the calls, the
peak memory and ``correct`` (with ``--trace 1`` the per-layer metrics and
the traced window's busy and total seconds instead). It measures how a
cell's numbers depend on the batch that its mix states; the benchmark's
runs never call it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rows", required=True, help="comma-separated")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for rows in (int(r) for r in args.rows.split(",")):
        cell = harness.find_cell(args.workload)
        cell.mix["rows"] = rows
        t = time.time()
        res = harness.run_cell(cell, seed=args.seed, seconds=args.seconds,
                               traced=bool(args.trace), device=device, started=t)
        line = {"workload": args.workload, "rows": rows, "correct": res["correct"],
                "calls": res["attempted"], "memory_peak_bytes": res["memory_peak_bytes"],
                "metrics": {k: v["value"] for k, v in res["metrics"].items()}}
        if args.trace:
            line.update(busy_s=res["busy_s"], window_s=res["window_s"])
        print(json.dumps(line), flush=True)
        del res
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
