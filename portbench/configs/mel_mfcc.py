"""The ``mel_mfcc`` forward: ``melspectrogram`` -> ``power_to_db`` -> ``mfcc``, as the port's
``entry.entry()`` runs it, each public call in a span of the benchmark's own."""

from __future__ import annotations

import numpy as np

from portbench import roofline
from portbench.reference.common import mel_basis

#: the outputs a request sends back to its client; the rest stay on the card
RESPONSE = ("mfcc",)


def forward(cfg: dict):
    """``forward(y, span)`` of float32 ``y`` ``(rows, n)`` on the card: ``{'mel', 'db',
    'mfcc'}``."""
    from librosa_tpu_torch import feature
    from librosa_tpu_torch.core.spectrum import power_to_db

    def run(y, span):
        with span("melspectrogram"):
            mel = feature.melspectrogram(y=y, sr=cfg["sr"], n_fft=cfg["n_fft"],
                                         hop_length=cfg["hop_length"], n_mels=cfg["n_mels"])
        with span("power_to_db"):
            db = power_to_db(mel, amin=cfg["amin"], top_db=cfg["top_db"])
        with span("mfcc"):
            mfcc = feature.mfcc(S=db, n_mfcc=cfg["n_mfcc"])
        return {"mel": mel, "db": db, "mfcc": mfcc}

    return run


def work(cfg: dict, rows: int, samples: int) -> dict:
    """Each hand kernel's work in one call, with the names its launches carry in a trace."""
    nnz = int(np.count_nonzero(mel_basis(cfg["sr"], cfg["n_fft"], cfg["n_mels"])))
    return {"stft_mel": dict(roofline.stft_work(rows, samples, n_fft=cfg["n_fft"],
                                                hop=cfg["hop_length"], n_out=cfg["n_mels"],
                                                basis_nnz=nnz),
                             kernels=("stft_mel_kernel",))}


def lower_precision_forward(cfg: dict):
    """The forward with the port's own lower-precision path switched on: the stft_mel kernel's
    projection at ``precision='default'`` (both operands rounded to bfloat16), the rest as in
    :func:`forward`. It is this configuration's control (``limits.py``)."""
    from librosa_tpu_torch import feature, filters
    from librosa_tpu_torch.core.spectrum import power_to_db
    from librosa_tpu_torch.ops.fused_stft import stft_mel_fused

    window = filters.get_window("hann", cfg["n_fft"], fftbins=True)
    basis = filters.mel(sr=cfg["sr"], n_fft=cfg["n_fft"], n_mels=cfg["n_mels"])

    def run(y, span):
        with span("melspectrogram"):
            mel = stft_mel_fused(y, window, basis, n_fft=cfg["n_fft"],
                                 hop_length=cfg["hop_length"], precision="default")
        with span("power_to_db"):
            db = power_to_db(mel, amin=cfg["amin"], top_db=cfg["top_db"])
        with span("mfcc"):
            mfcc = feature.mfcc(S=db, n_mfcc=cfg["n_mfcc"])
        return {"mel": mel, "db": db, "mfcc": mfcc}

    return run
