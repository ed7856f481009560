"""Plain float64 reference of the ``mel_mfcc`` configuration: mel spectrogram, dB, MFCC.

librosa's definitions at the configuration's settings: a centred,
zero-padded STFT with a periodic Hann window, the power spectrum projected
onto Slaney-normalised mel filters, ``power_to_db`` (reference 1,
``amin`` 1e-10, 80 dB below each track's peak) and the first ``n_mfcc``
rows of an orthonormal DCT-II.
"""

from __future__ import annotations

import torch

from portbench.reference.common import (F64, dct_ortho, exact, mel_spectrogram, power_to_db,
                                        rel_err, row_blocks)

#: Each number compared is ``||program - reference|| / ||reference||`` of one output over the
#: whole batch. The limits and the readings they come from are in PERF.md ("correct").
LIMITS = {"mel_err": 2e-5, "db_err": 1e-5, "mfcc_err": 1e-5}


def compute(y: torch.Tensor, cfg: dict, q=exact) -> dict:
    """``{'mel', 'db', 'mfcc'}`` of ``y`` ``(rows, n)`` (any float dtype, any device), on the
    host."""
    out = {"mel": [], "db": [], "mfcc": []}
    C = dct_ortho(cfg["n_mels"], y.device)[:cfg["n_mfcc"]]
    for rows in row_blocks(y.shape[0], y.shape[-1]):
        x = q(y[rows].to(F64))
        mel = mel_spectrogram(x, sr=cfg["sr"], n_fft=cfg["n_fft"], hop=cfg["hop_length"],
                              n_mels=cfg["n_mels"], q=q)
        db = power_to_db(mel, amin=cfg["amin"], top_db=cfg["top_db"], q=q)
        mfcc = q(torch.matmul(C, db))
        for key, value in (("mel", mel), ("db", db), ("mfcc", mfcc)):
            out[key].append(value.cpu())
    return {key: torch.cat(parts) for key, parts in out.items()}


def compare(got: dict, want: dict) -> dict:
    """The numbers compared, by name; ``got`` holds the program's outputs under the same keys."""
    return {f"{key}_err": rel_err(got[key], want[key]) for key in ("mel", "db", "mfcc")
            if key in got}
