"""``correct`` comes out false for the control and for each fault a cell can have, and true for
the program, with the rest of a run driven on the CPU at a small size."""

import numpy as np
import pytest
import torch

from portbench import harness, limits
from portbench.tests._tiny import CELLS, SEED, run, tiny


def _rows(value, rows: int):
    """``value``'s first rows repeated to ``rows`` rows."""
    if torch.is_tensor(value):
        return value.repeat((-(-rows // value.shape[0]),) + (1,) * (value.ndim - 1))[:rows]
    value = np.asarray(value)
    return np.concatenate([value] * -(-rows // value.shape[0]))[:rows]


def half_batch(fwd):
    """Half of the batch left out: its results stand in for the other half."""
    def run_half(y, span):
        out = fwd(y[: max(1, y.shape[0] // 2)], span)
        return {k: _rows(v, y.shape[0]) for k, v in out.items()}
    return run_half


def altered_answer(fwd):
    """One answer altered where it is produced: the first MFCC of the first frame, or the
    first track's tempo."""
    def run_altered(y, span):
        out = fwd(y, span)
        if "mfcc" in out:
            out["mfcc"] = out["mfcc"].clone()
            out["mfcc"][0, 0, 0] += 1.0
        else:
            out["tempo"] = np.array(out["tempo"], copy=True)
            out["tempo"].reshape(-1)[0] *= 2.0
        return out
    return run_altered


@pytest.mark.parametrize("workload", CELLS)
def test_the_program_is_correct(workload):
    assert run(tiny(workload))["correct"]


@pytest.mark.parametrize("mode", ["control", "bf16"])
@pytest.mark.parametrize("config", ["mel_mfcc", "onset_beat_pyin"])
def test_the_control_is_not_correct(config, mode):
    cell = tiny(f"{config}.catalog")
    res = run(cell, forward=limits.control_forward(cell, mode))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [half_batch, altered_answer])
@pytest.mark.parametrize("workload", CELLS)
def test_each_fault_is_not_correct(workload, fault):
    cell = tiny(workload)
    res = run(cell, forward=fault(cell.model.forward(cell.cfg)))
    assert not res["correct"], res["checks"]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_is_correct_on_the_card(card, workload):
    import time

    cell = harness.find_cell(workload)
    res = harness.run_cell(cell, seed=SEED, seconds=2.0, traced=False, device=card,
                           started=time.time())
    assert res["correct"], res["checks"]
