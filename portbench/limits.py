"""Readings for the limits of ``correct``: the program, and its control, over many seeds.

    python3 portbench/limits.py --workload <cell> --mode program --seeds 1,2,3 --seconds 3
    python3 portbench/limits.py --workload <cell> --mode control --seeds 4,5,6 --seconds 1

Each seed runs the cell's set-up, a short window at the cell's own load and
its check, all in one process; one JSON line a seed gives the numbers
compared. ``--mode control`` puts the control in the program's place: the
configuration's ``lower_precision_forward`` where the port has such a path,
else the plain reference with every stage rounded to bfloat16 (the
precision below the float32 that the configurations state). ``--mode
bf16`` asks for the latter in every case. Lines also go to ``--out``.
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
from portbench.reference.common import bf16  # noqa: E402


def control_forward(cell: harness.Cell, mode: str):
    """The control that stands in the program's place, or None for the program itself."""
    if mode == "program":
        return None
    if mode == "control" and hasattr(cell.model, "lower_precision_forward"):
        return cell.model.lower_precision_forward(cell.cfg)

    def run(y, span):
        with span("reference_bf16"):
            return cell.reference.compute(y, cell.cfg, q=bf16)

    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=("program", "control", "bf16"), default="program")
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    cell = harness.find_cell(args.workload)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.time()
            res = harness.run_cell(cell, seed=seed, seconds=args.seconds, traced=False,
                                   device=device, started=t,
                                   forward=control_forward(cell, args.mode))
            line = json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                               "correct": res["correct"], "calls": res["attempted"],
                               "seconds": round(time.time() - t, 3),
                               "numbers": {k: v["value"] for k, v in res["checks"].items()}})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
