"""Kernel B's cluster route at other cluster sizes and lanes a column than the path's.

``ops/viterbi.py:forward`` always launches the cluster route with
``CLUSTER`` blocks a row and :meth:`RunTable.group` lanes a column. This
script measures the choices beside them on pYIN's transition table (65-800
Hz, 870 states, the path's): for each cluster size it prints
``cudaOccupancyMaxActiveClusters``, the exchange probe's time (the
distributed-shared-memory stores and one cluster barrier a frame) and the
forward pass's time at each lane count, and holds every variant's states
and logp against the plain version, bit for bit. Times are CUDA-event
timings, best of ``--groups`` groups of one call each. The log_prob is
seeded, log-uniform; the card's name and power limit head the output, and
the last line is a JSON object of the numbers.

Usage: python -m librosa_tpu_torch.diagnostics.viterbi_cluster [--rows 16] [--frames 8193]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import List, Optional

import torch

from ..core import pitch
from ..ops import viterbi

CLUSTERS = (8, 4)
GROUPS = (4, 8, 16)
PYIN_KEY = (22050.0, 65.0, 800.0, 512, 100, (2.0, 18.0), 0.1, 35.92, 0.01, 1e-4)


def _best_ms(fn, groups: int) -> float:
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(groups):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=16)
    ap.add_argument("--frames", type=int, default=8193)
    ap.add_argument("--groups", type=int, default=3, help="timings, the best kept")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("viterbi_cluster: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    device = torch.device("cuda")
    _, _, log_trans, log_p_init = pitch._pyin_tables(*PYIN_KEY)
    lt = torch.tensor(log_trans, dtype=torch.float32, device=device)
    lpi = torch.tensor(log_p_init, dtype=torch.float32, device=device)
    runs = viterbi.run_table(log_trans).on(device)
    R, T, S = args.rows, args.frames, lt.shape[0]
    g = torch.Generator(device=device).manual_seed(args.seed)
    lp = torch.log(torch.rand((R, T, S), generator=g, device=device))
    want_s, want_p = viterbi.viterbi_reference(lp, lt, lpi)
    ptrs = torch.empty(R * T * S + 8, dtype=torch.int16, device=device)
    states = torch.empty((R, T), dtype=torch.int32, device=device)
    logp = torch.empty(R, dtype=torch.float32, device=device)

    def launch(cluster: int, group: int) -> None:
        err = viterbi._cluster_forward(lp, lpi, runs, cluster, group, ptrs, states, logp)
        if err != 0:
            raise RuntimeError(f"cluster {cluster}, group {group}: CUDA error {err}")

    out = {"rows": R, "frames": T, "states": S, "path_cluster": viterbi.CLUSTER,
           "path_group": runs.group(viterbi.CLUSTER), "clusters": {}}
    for cluster in CLUSTERS:
        entry = {"max_active_clusters": viterbi.max_active_clusters(runs, cluster),
                 "exchange_probe_ms": viterbi.exchange_floor_ms(R, T, runs, cluster),
                 "rule_group": runs.group(cluster), "forward_ms_by_group": {}}
        for group in GROUPS:
            states.fill_(-1)
            launch(cluster, group)
            viterbi.backtrack(ptrs, states, S)
            if not (torch.equal(states, want_s) and torch.equal(logp, want_p)):
                raise AssertionError(f"cluster {cluster}, group {group}: differs from the plain "
                                     f"version")
            ms = _best_ms(lambda: launch(cluster, group), args.groups)
            entry["forward_ms_by_group"][group] = ms
            print(f"cluster {cluster}, {group} lanes a column: forward {ms:.4f} ms on "
                  f"({R}, {T}, {S}), bit-equal to the plain version")
        print(f"cluster {cluster}: cudaOccupancyMaxActiveClusters "
              f"{entry['max_active_clusters']}, exchange probe {entry['exchange_probe_ms']:.4f} "
              f"ms, the lane rule takes {entry['rule_group']}")
        out["clusters"][cluster] = entry
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
