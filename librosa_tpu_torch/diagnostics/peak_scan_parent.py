"""The ``peak_scan`` kernels beside an earlier build of ``csrc/peak_scan.cu``, on one card.

An earlier source with the C interface of the first design (one thread a
row: ``greedy_scan_launch(cand, out, rows, T, int wait, stream)`` and
``dp_scan_launch(cand, gain, values, taken, rows, T, wait, stream)``) is
built with ``nvcc`` beside the package's own kernels. Both run on the path's
inputs: the candidates and gains that ``onset_detect(sparse=False)`` hands
the kernels for the onset envelope of 16 seeded noise tracks of 2**22
samples (``chip_smoke.py``'s main buffer), and of a batch of 256 shifted
copies of it. At each wait the two are timed in turns (earlier, current,
current, earlier; CUDA events, best of 3 groups of 20 launches) and their
outputs must be equal. The card's name and power limit head the output; the
last line is a JSON object of the numbers.

Usage: python -m librosa_tpu_torch.diagnostics.peak_scan_parent --parent PATH [--waits 0 1 10 300]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

import torch

from .. import onset, set_device
from ..ops import _build, peaks

SR = 22050
TRACKS, SAMPLES = 16, 2**22
BATCH = 256


def _best_ms(fn, launches: int = 20, groups: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(groups):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / launches)
    return best


def _earlier_lib(source: Path) -> ctypes.CDLL:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"peak_scan_earlier-{digest}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(source)],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.greedy_scan_launch.argtypes = [p, p, i64, i64, i32, p]
    lib.dp_scan_launch.argtypes = [p, p, p, p, i64, i64, i64, p]
    lib.greedy_scan_launch.restype = lib.dp_scan_launch.restype = ctypes.c_int
    return lib


def _path_inputs(env: torch.Tensor):
    """The candidates and float32 gains that onset_detect's DP hands dp_scan for ``env``."""
    seen = []
    dp_scan = peaks.dp_scan
    peaks.dp_scan = lambda cand, gain, wait: seen.append((cand, gain)) or dp_scan(cand, gain, wait)
    try:
        onset.onset_detect(onset_envelope=env, sr=SR, sparse=False, method="dp_value", wait=10)
    finally:
        peaks.dp_scan = dp_scan
    return seen[0]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True, help="the earlier peak_scan.cu")
    ap.add_argument("--waits", type=int, nargs="+", default=[0, 1, 10, 300])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("peak_scan_parent: CUDA is not available", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    set_device(device)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    earlier = _earlier_lib(args.parent)
    gen = torch.Generator(device=device).manual_seed(0)
    y = 0.1 * torch.randn((TRACKS, SAMPLES), generator=gen, device=device, dtype=torch.float32)
    env = onset.onset_strength(y=y, sr=SR)
    del y
    batch = torch.cat([torch.roll(env, 97 * k, dims=-1) for k in range(BATCH // TRACKS)])
    result = {"device": torch.cuda.get_device_name(0), "shapes": {}}
    for e in (env, batch):
        cand, gain = _path_inputs(e)
        rows, T = cand.shape
        out = torch.empty_like(cand)
        values = torch.empty((rows, T + 1), dtype=torch.float32, device=device)
        stream = torch.cuda.current_stream().cuda_stream
        per_wait = {}
        for wait in args.waits:
            def old_greedy():
                peaks._checked(earlier.greedy_scan_launch(cand.data_ptr(), out.data_ptr(), rows, T,
                                                          wait, stream), "earlier greedy_scan")

            def old_dp():
                peaks._checked(earlier.dp_scan_launch(cand.data_ptr(), gain.data_ptr(),
                                                      values.data_ptr(), out.data_ptr(), rows, T,
                                                      wait, stream), "earlier dp_scan")

            old_greedy()
            if not torch.equal(out, peaks.greedy_scan(cand, wait)):
                raise AssertionError(f"greedy at wait {wait}: the two builds disagree")
            old_dp()
            if not torch.equal(out, peaks.dp_scan(cand, gain, wait)):
                raise AssertionError(f"dp at wait {wait}: the two builds disagree")
            row = {}
            for name, old, new in (("greedy", old_greedy, lambda: peaks.greedy_scan(cand, wait)),
                                   ("dp", old_dp, lambda: peaks.dp_scan(cand, gain, wait))):
                t = [_best_ms(old), _best_ms(new), _best_ms(new), _best_ms(old)]
                row[name] = {"earlier_ms": min(t[0], t[3]), "current_ms": min(t[1], t[2]),
                             "turns_ms": t}
            per_wait[str(wait)] = row
            print(f"{rows}x{T} wait {wait}: greedy earlier {row['greedy']['earlier_ms']:.4f} ms, "
                  f"current {row['greedy']['current_ms']:.4f}; dp earlier "
                  f"{row['dp']['earlier_ms']:.4f}, current {row['dp']['current_ms']:.4f} "
                  f"({peaks.dp_route(T, wait)} route)")
        result["shapes"][f"{rows}x{T}"] = per_wait
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
