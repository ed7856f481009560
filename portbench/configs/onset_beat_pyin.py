"""The ``onset_beat_pyin`` forward: ``onset_strength`` -> ``tempo`` -> ``beat_track`` and
``pyin``, as the port's ``entry.onset_beat_pyin()`` runs them, each public call in a span of
the benchmark's own."""

from __future__ import annotations

import numpy as np

from portbench import roofline
from portbench.reference.common import mel_basis
from portbench.reference.onset_beat_pyin import pyin_tables

#: the outputs a request sends back to its client (tempo and beats are numpy already)
RESPONSE = ("tempo", "beats", "f0", "voiced_flag", "voiced_prob")


def forward(cfg: dict):
    """``forward(y, span)`` of float32 ``y`` ``(rows, n)`` on the card: the onset envelope,
    tempo, beat mask and pYIN's ``f0``, voicing flag and probability."""
    from librosa_tpu_torch import beat, feature, onset
    from librosa_tpu_torch.core.pitch import pyin

    sr, hop = cfg["sr"], cfg["hop_length"]

    def run(y, span):
        with span("onset_strength"):
            env = onset.onset_strength(y=y, sr=sr, hop_length=hop, aggregate=np.median)
        with span("tempo"):
            bpm = feature.tempo(onset_envelope=env, sr=sr, hop_length=hop)
        with span("beat_track"):
            _, beats = beat.beat_track(onset_envelope=env, sr=sr, hop_length=hop, bpm=bpm,
                                       sparse=False)
        with span("pyin"):
            f0, voiced_flag, voiced_prob = pyin(y, fmin=cfg["fmin"], fmax=cfg["fmax"], sr=sr,
                                                frame_length=cfg["frame_length"])
        return {"env": env, "tempo": bpm, "beats": beats, "f0": f0,
                "voiced_flag": voiced_flag, "voiced_prob": voiced_prob}

    return run


def work(cfg: dict, rows: int, samples: int) -> dict:
    """Each hand kernel's work in one call, with the names its launches carry in a trace."""
    nnz = int(np.count_nonzero(mel_basis(cfg["sr"], cfg["n_fft"], cfg["n_mels"])))
    finite = int(np.isfinite(pyin_tables(cfg)["log_trans"]).sum())
    frames = 1 + samples // cfg["hop_length"]
    return {"stft_mel": dict(roofline.stft_work(rows, samples, n_fft=cfg["n_fft"],
                                                hop=cfg["hop_length"], n_out=cfg["n_mels"],
                                                basis_nnz=nnz),
                             kernels=("stft_mel_kernel",)),
            "viterbi": dict(roofline.viterbi_work(rows, frames, cfg["n_states"], finite),
                            kernels=("viterbi_cluster_kernel", "viterbi_block_kernel",
                                     "viterbi_backtrack_kernel"))}
