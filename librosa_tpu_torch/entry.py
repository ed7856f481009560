"""Entry points: each main path as one forward function, with an example input."""

from __future__ import annotations

import numpy as np

from . import beat, effects, feature, onset
from .core.audio import resample
from .core.constantq import cqt
from .core.pitch import pyin
from .core.spectrum import _spectrogram, griffinlim, power_to_db

SR = 22050


def entry():
    """Return ``(forward, example_args)`` for y -> mel spectrogram -> dB -> MFCC.

    The same forward as the JAX package's entry: 4 s at 22050 Hz, n_fft
    2048, hop 512, 128 mels, 20 coefficients.
    """
    def forward(y):
        M = feature.melspectrogram(y=y, sr=SR, n_fft=2048, hop_length=512, n_mels=128)
        return feature.mfcc(S=power_to_db(M), n_mfcc=20)

    return forward, (np.zeros(SR * 4, dtype=np.float32),)


def feature_stack():
    """Return ``(forward, example_args)`` for the feature stack of a batch of tracks.

    ``forward(y)`` gives ``(mfcc, chroma, centroid, rolloff)`` of ``y``
    ``(..., n)``: 20 MFCCs over 128 mels, 12 chroma at A440, spectral
    centroid and 85 % roll-off, all at n_fft 2048 and hop 512. Each feature
    is computed from ``y`` on its own, as the four public functions do: on
    the card the stft_mel kernel runs four times (mel, chroma and twice the
    identity basis) and the db_scale kernel once.
    """
    kw = dict(sr=SR, n_fft=2048, hop_length=512)

    def forward(y):
        return (feature.mfcc(y=y, n_mfcc=20, n_mels=128, **kw),
                feature.chroma_stft(y=y, tuning=0.0, n_chroma=12, **kw),
                feature.spectral_centroid(y=y, **kw),
                feature.spectral_rolloff(y=y, **kw))

    return forward, (np.zeros((2, SR * 4), dtype=np.float32),)


def reconstruction(init="random"):
    """Return ``(forward, example_args)`` for resample -> |STFT| -> Griffin-Lim.

    ``forward(y)`` resamples ``y`` ``(..., n)`` from 22050 Hz to 16000 Hz
    (polyphase: up 320, down 441), takes the magnitude spectrogram at n_fft
    2048 and hop 512, and recovers a signal from the magnitudes alone with
    32 rounds of Griffin-Lim from seed 0. It returns ``(y16k, y_hat)``, both
    ``(..., ceil(n * 320 / 441))``. On the card the stft_mel kernel runs once
    (identity basis) and the ola_norm kernel 33 times. ``init=None`` starts
    from zero phase instead of random phases.
    """
    kw = dict(n_fft=2048, hop_length=512)

    def forward(y):
        y16k = resample(y, orig_sr=SR, target_sr=16000, res_type="polyphase")
        S, _ = _spectrogram(y=y16k, power=1, **kw)
        y_hat = griffinlim(S, n_iter=32, rng=0, init=init, length=y16k.shape[-1], **kw)
        return y16k, y_hat

    return forward, (np.zeros((2, SR * 4), dtype=np.float32),)


def cqt_hpss():
    """Return ``(forward, example_args)`` for the constant-Q transform and HPSS of a batch of tracks.

    ``forward(y)`` gives ``(C, y_harm, y_perc)`` of ``y`` ``(..., n)``: the
    constant-Q transform at 84 bins, 12 to the octave from C1, hop 512, with
    the octaves resampled by ``'polyphase'``, and the harmonic and percussive
    waveforms of :func:`effects.hpss` at its defaults (n_fft 2048, hop 512,
    median filters of 31, power 2, margin 1). On the card the median_filter
    kernel runs twice and the ola_norm kernel twice.
    """
    def forward(y):
        C = cqt(y, sr=SR, hop_length=512, n_bins=84, bins_per_octave=12, res_type="polyphase")
        y_harm, y_perc = effects.hpss(y)
        return C, y_harm, y_perc

    return forward, (np.zeros((2, SR * 4), dtype=np.float32),)


def onset_beat_pyin():
    """Return ``(forward, example_args)`` for onset strength, tempo, beats and pYIN of a batch of tracks.

    ``forward(y)`` gives ``(onset_envelope, tempo, beats, (f0, voiced_flag,
    voiced_prob))`` of ``y`` ``(..., n)``: the onset envelope (median over
    128 mels of the dB flux, n_fft 2048, hop 512, as ``beat.beat_track``
    computes it from ``y``), the tempo per track (numpy), the beat mask of
    ``beat.beat_track(..., sparse=False)`` (numpy) and ``pyin(y, fmin=65,
    fmax=800)``. On the card the stft_mel and db_scale kernels run once
    each, the beat DP kernel once and the Viterbi kernel once.
    """
    def forward(y):
        env = onset.onset_strength(y=y, sr=SR, hop_length=512, aggregate=np.median)
        tempo = feature.tempo(onset_envelope=env, sr=SR, hop_length=512)
        _, beats = beat.beat_track(onset_envelope=env, sr=SR, hop_length=512, bpm=tempo,
                                   sparse=False)
        return env, tempo, beats, pyin(y, fmin=65, fmax=800, sr=SR)

    return forward, (np.zeros((2, SR * 4), dtype=np.float32),)
