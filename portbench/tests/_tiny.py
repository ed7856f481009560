"""Helpers of the tests: the benchmark's cells cut to a size the CPU runs in seconds."""

import time

import torch

from portbench import harness

CELLS = ("mel_mfcc.catalog", "onset_beat_pyin.catalog", "onset_beat_pyin.clips",
         "mel_mfcc.clips")
SEED = 2**31 + 12345


def tiny(workload: str, **kw) -> harness.Cell:
    """The cell with 2 rows of 3 s and at most 2 batches in its pool."""
    cell = harness.find_cell(workload, **kw)
    cell.mix.update(rows=2, samples=3 * 22050, pool=min(2, int(cell.mix["pool"])),
                    trace_seconds=0.2, span_seconds=0.2)
    return cell


def run(cell: harness.Cell, traced: bool = False, forward=None, seed: int = SEED) -> dict:
    return harness.run_cell(cell, seed=seed, seconds=0.2, traced=traced,
                            device=torch.device("cpu"), started=time.time(), forward=forward)
