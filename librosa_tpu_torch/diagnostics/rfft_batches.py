"""Whether ``torch.fft.rfft`` gives a frame the same bits in a smaller batch of frames.

``parallel.stft_sharded`` promises the bits of :func:`stft`, whose frames
go through one ``rfft`` call. This script frames a seeded ``(16, 2**22)``
buffer as ``stft`` does (n_fft 2048, hop 512, hann, centred), transforms
all 131088 frames in one call, then the first ``b`` frames alone for each
batch size ``b`` below, and prints how many of them equal the full call's
bits; then the trailing frame alone, as a sharded STFT would transform it
without :func:`parallel.sharded._rfft_by_device`. The card's name and power
limit head the output; the last line is a JSON object of the counts.

Usage: python -m librosa_tpu_torch.diagnostics.rfft_batches [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

BATCHES = (1, 16, 1024, 1025, 2048, 3072, 4096, 16384, 131072)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    device = torch.device(parser.parse_args().device)
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())
    gen = torch.Generator(device=device).manual_seed(0)
    y = 0.1 * torch.randn((16, 1 << 22), generator=gen, device=device)
    window = torch.hann_window(2048, periodic=True, device=device)
    frames = (torch.nn.functional.pad(y, (1024, 1024)).unfold(-1, 2048, 512) * window)
    frames = frames.reshape(-1, 2048)
    full = torch.fft.rfft(frames, dim=-1)
    counts = {}
    for b in BATCHES:
        part = torch.fft.rfft(frames[:b], dim=-1)
        counts[b] = int((part == full[:b]).all(dim=-1).sum())
        print(f"batch {b}: {counts[b]} of {b} frames equal to the {frames.shape[0]}-frame call")
    last = frames.reshape(16, -1, 2048)[:, -1]
    tail_equal = int((torch.fft.rfft(last, dim=-1)
                      == full.reshape(16, -1, 1025)[:, -1]).all(dim=-1).sum())
    print(f"the trailing frame of each track alone (a batch of 16): {tail_equal} of 16 equal")
    print(json.dumps({"device": str(device), "frames": frames.shape[0], "equal": counts,
                      "trailing_alone_equal": tail_equal}))


if __name__ == "__main__":
    main()
