"""The staged-copy pipeline alone: the mel kernel's input copy with nothing around it.

Stages 4096 tiles of 144 rows of 512 float32 (288 KB each) from device
memory into shared memory through the ``stage_colsum`` kernel of
``ops/staged_probe.py`` and sums their columns; the output is the last
tile's sums. Tile ``i`` starts at row ``(i % WRAP) * 128`` of a buffer of
``(WRAP * 128 + 144) * 512`` floats: at the default WRAP of 128 that is
33.8 MB, inside an H100's 50 MB L2; at 1024 it is 268.7 MB, beyond it, so
the copy streams from device memory.

Usage: python -m librosa_tpu_torch.diagnostics.dma_pipeline_micro [WRAP] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, List, Optional

import torch

from .dma_bisect import (CALLS, HOP, N_TILES, ROWS, TT, WRAP, Case, Inputs, device_label,
                         dispatch_floor, measure)


def make_case(inputs: Inputs, *, n_tiles: int = N_TILES) -> Case:
    """The pipeline over ``inputs.rows``, wrapping at ``inputs.wrap`` tile starts."""
    kw = dict(rows_per_tile=ROWS, width=HOP, tt=TT, n_tiles=n_tiles, wrap=inputs.wrap)
    return Case(f"pipeline wrap {inputs.wrap}", "stage_colsum", inputs.rows, kw,
                out=inputs.out((1, HOP)))


def run(wrap: int = WRAP, *, device="cuda", n_tiles: int = N_TILES, seed: int = 0,
        calls: int = CALLS, inputs: Optional[Inputs] = None,
        out: Callable[[str], None] = print) -> dict:
    """Runs and times the pipeline on ``device``; returns its numbers."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the staged-copy pipeline runs on a card, and CUDA is not "
                           "available; pass --device cpu for the plain version")
    inputs = inputs or Inputs(device, wrap=wrap, seed=seed)
    out(f"device: {device_label(device)}")
    floor = dispatch_floor(device, calls=calls)
    out(f"dispatch floor: {floor[0]:.4f} ms/call (spread {floor[1]:.4f} ms)")
    return measure(make_case(inputs, n_tiles=n_tiles), floor, calls=calls, out=out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m librosa_tpu_torch.diagnostics.dma_pipeline_micro",
        description="The staged-copy pipeline alone.")
    ap.add_argument("wrap", nargs="?", type=int, default=WRAP,
                    help="distinct tile starts; the buffer is (WRAP*128+144) rows of 2 KB")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n-tiles", type=int, default=N_TILES)
    ap.add_argument("--calls", type=int, default=CALLS, help="calls in flight per timing")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run(args.wrap, device=args.device, n_tiles=args.n_tiles, seed=args.seed, calls=args.calls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
