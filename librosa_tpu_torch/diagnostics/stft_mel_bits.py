"""Whether the ``stft_mel`` kernel gives the same bits as another tree's build of it.

A change to ``csrc/stft_mel.cu`` that must leave the default ('highest')
projection as it was is checked here on the card: the script runs the kernel
of this checkout and of ``OTHER`` (the root of another checkout, for example
the parent commit unpacked by ``git archive``) on the same seeded inputs,
each in its own process that builds its own kernel, and compares the
outputs bit for bit. The geometries: the main path's (16 tracks of 2**22
samples, n_fft 2048, hop 512, 128 mels) and three smaller ones (n_fft 512,
1024 with a hop that does not divide it, 4096), each at power 2 and 1. The
card's name and power limit head the output; the last line is a JSON object
of the equalities. It exits with 1 if any differs.

Usage: python -m librosa_tpu_torch.diagnostics.stft_mel_bits OTHER
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

GEOMETRIES = ((2048, 512, 128, (16, 1 << 22)), (512, 128, 64, (3, 40000)),
              (1024, 300, 36, (2, 50001)), (4096, 1024, 128, (4, 300000)))

# run from a checkout's root (which need not hold this module): that checkout's kernel on the
# seeded inputs, saved to argv[1]
_RUN = """
import sys
import numpy as np, torch
sys.path.insert(0, ".")
import librosa_tpu_torch as L
from librosa_tpu_torch.ops import fused_stft
L.set_device("cuda")
rng = np.random.RandomState(0)
out = {}
for n_fft, hop, n_mels, shape in %r:
    y = torch.from_numpy((rng.randn(*shape) * 0.1).astype(np.float32)).cuda()
    win = L.filters.get_window("hann", n_fft)
    basis = L.filters.mel(sr=22050, n_fft=n_fft, n_mels=n_mels)
    for power in (2.0, 1.0):
        out[f"n_fft {n_fft} power {power}"] = fused_stft.stft_mel_fused(
            y, win, basis, n_fft=n_fft, hop_length=hop, power=power).cpu().numpy()
np.savez(sys.argv[1], **out)
""" % (GEOMETRIES,)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", help="the root of the checkout to compare with")
    other = os.path.abspath(parser.parse_args().other)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        files = {}
        for label, root in (("this", here), ("other", other)):
            files[label] = os.path.join(tmp, f"{label}.npz")
            subprocess.run([sys.executable, "-c", _RUN, files[label]], cwd=root, check=True)
        a, b = np.load(files["this"]), np.load(files["other"])
        equal = {k: bool(np.array_equal(a[k], b[k], equal_nan=True)) for k in a.files}
    for k, v in equal.items():
        print(f"{k}: {'bit-equal' if v else 'DIFFERS'}")
    print(json.dumps({"bit_equal": equal}))
    sys.exit(0 if all(equal.values()) else 1)


if __name__ == "__main__":
    main()
