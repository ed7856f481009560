"""Routes for ``segment.path_enhance``'s convolutions, timed on the card.

``path_enhance`` takes the maximum over seven filters (15x15 to 19x19 at
``n=15``) of ``R`` convolved with each. This script times ways of computing
the same maximum on a seeded ``(rows, frames, frames)`` matrix of the
affinity's sparsity (2 % of the entries in (0, 1]), each in exact float32
(no TF32):

- ``channels``: the filters zero-embedded in one frame as the output
  channels of a single ``conv2d``, then the maximum over channels (the
  package's route, ``segment._path_enhance_core``);
- ``per_filter``: one single-channel ``conv2d`` a filter over the same
  shared symmetric pad, and a running maximum;
- ``rfft2``: the padded matrix's ``rfft2`` once, then per filter a product
  with the filter's spectrum, ``irfft2`` and a crop;

the first two with ``torch.backends.cudnn.benchmark`` off and on. Each is
held against ``channels`` by SNR over the whole output. Times are CUDA
events, best of ``--groups`` calls; the card's name and power limit head
the output, and the last line is a JSON object of the numbers.

Usage: python -m librosa_tpu_torch.diagnostics.path_enhance_routes [--rows 2] [--frames 8193]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Callable, List, Optional

import numpy as np
import scipy.fft
import torch
import torch.nn.functional as F

from .. import segment
from .._device import exact_f32
from ..filters import diagonal_filter


def _best_ms(fn: Callable[[], torch.Tensor], groups: int) -> float:
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


def per_filter_route(R: torch.Tensor, kernels: list) -> torch.Tensor:
    h, w = R.shape[-2:]
    pads = segment._shared_pads(kernels)
    Rp, top, left = segment._shared_pad(R, pads), pads[0], pads[2]
    out = None
    with exact_f32():
        for k in kernels:
            kh, kw = k.shape
            r0, c0 = top - (kh - 1) // 2, left - (kw - 1) // 2
            conv = F.conv2d(Rp[..., r0:r0 + h + kh - 1, c0:c0 + w + kw - 1], k[None, None])
            out = conv if out is None else torch.maximum(out, conv, out=out)
    return out.reshape(R.shape).clamp_min(0)


def rfft2_route(R: torch.Tensor, kernels: list) -> torch.Tensor:
    h, w = R.shape[-2:]
    pads = segment._shared_pads(kernels)
    Rp = segment._shared_pad(R, pads)
    size = (scipy.fft.next_fast_len(Rp.shape[-2], real=True),
            scipy.fft.next_fast_len(Rp.shape[-1], real=True))
    spec = torch.fft.rfft2(Rp, s=size)
    out = None
    for k in segment._kernel_frame(kernels, pads)[:, 0]:
        # circular cross-correlation; no wrap reaches the first h x w outputs
        corr = torch.fft.irfft2(spec * torch.fft.rfft2(k, s=size).conj(), s=size)[..., :h, :w]
        out = corr if out is None else torch.maximum(out, corr)
    return out.reshape(R.shape).clamp_min(0)


def snr_db(got: torch.Tensor, want: torch.Tensor) -> float:
    err = (got.double() - want.double()).square().sum()
    return float(10 * torch.log10(want.double().square().sum() / err.clamp(min=1e-300)))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=2)
    ap.add_argument("--frames", type=int, default=8193)
    ap.add_argument("--n", type=int, default=15, help="path_enhance's filter length")
    ap.add_argument("--groups", type=int, default=3, help="timings, the best kept")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("path_enhance_routes: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    shape = (args.rows, args.frames, args.frames)
    R = torch.rand(shape, generator=g, device=dev)
    R = torch.where(torch.rand(shape, generator=g, device=dev) < 0.02, R, 0.0)
    ratios = np.logspace(-1.0, 1.0, 7, base=2)
    kernels = [torch.from_numpy(np.ascontiguousarray(
        diagonal_filter("hann", args.n, slope=r)[::-1, ::-1].astype(np.float32))).to(dev)
        for r in ratios]
    want = segment._path_enhance_core(R, kernels, clip=True)
    routes = {"channels": lambda: segment._path_enhance_core(R, kernels, clip=True),
              "per_filter": lambda: per_filter_route(R, kernels),
              "rfft2": lambda: rfft2_route(R, kernels)}
    results = {}
    prev = torch.backends.cudnn.benchmark
    try:
        for bench in (False, True):
            torch.backends.cudnn.benchmark = bench
            for name, fn in routes.items():
                if bench and name == "rfft2":
                    continue
                label = f"{name}{', cudnn.benchmark' if bench else ''}"
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                got = fn()
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - held
                ms = _best_ms(fn, args.groups)
                results[label] = {"ms": ms, "snr_db_vs_channels": snr_db(got, want),
                                  "peak_bytes": peak}
                print(f"{label}: {ms:.4f} ms, {results[label]['snr_db_vs_channels']:.1f} dB "
                      f"against channels, peak {peak} bytes above R ({smi})", flush=True)
                del got
    finally:
        torch.backends.cudnn.benchmark = prev
    print(json.dumps({"device": smi, "shape": list(shape), "n": args.n, "routes": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
