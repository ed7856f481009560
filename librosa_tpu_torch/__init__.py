"""librosa_tpu_torch: audio and music analysis on PyTorch and CUDA.

The PyTorch port of ``librosa_tpu``, with the same librosa-style namespace
(flat ``load``, ``stream``, ``to_mono``, ``get_duration``, ``stft``, ``istft``, ``griffinlim``, ``magphase``, ``power_to_db``,
``amplitude_to_db`` and their inverses, ``perceptual_weighting``, ``pcen``,
``reassigned_spectrogram``, ``iirt``, ``fmt``, ``resample``,
``piptrack``, ``pitch_tuning``, ``estimate_tuning``, ``yin``, ``pyin``,
``salience``, ``interp_harmonics``, ``f0_harmonics``, ``tone``, ``chirp``,
``clicks``, ``phase_vocoder``, the notation and svara names; ``onset``,
``beat``, ``sequence``, ``segment``, ``effects`` and ``decompose``; ``feature.melspectrogram``,
``feature.mfcc``, ``feature.chroma_stft``, ``feature.spectral_centroid``,
``feature.spectral_rolloff``, the other spectral descriptors, ``feature.tonnetz``,
``feature.rms``, the tempograms and ``feature.tempo``, ``feature.delta``,
``feature.stack_memory`` and the inversions in ``feature.inverse``; ``filters.mel``,
``filters.chroma``, ``filters.get_window``, ``filters.window_sumsquare``;
``util.normalize``, ``util.nnls`` and friends; ``util.profiling``; the
on-disk ``cache``; ``display``, loaded at its first use so that importing
the package does not import matplotlib; ``parallel``, the sharded chains
over a device mesh, also loaded at its first use)
and the same array layout: time on the last axis, bins on axis -2, any
leading dims.

Inputs that are not tensors go to the default device, ``cuda`` unless
:func:`set_device` chose another; tensors stay where they are. On the card
``|STFT|**power`` projected onto a basis (mel, chroma, or the identity for a
plain spectrogram) runs as one hand-written CUDA kernel
(``csrc/stft_mel.cu``), decibel scaling as another (``csrc/db_scale.cu``)
and the synthesis step of the inverse STFT as a third
(``csrc/ola_norm.cu``); the beat tracker's dynamic program over a batch of
envelopes (``csrc/beat_dp.cu``) and the Viterbi decoder behind ``pyin`` and
``sequence.viterbi`` (``csrc/viterbi.cu``) are two more. On the CPU each
function runs its plain PyTorch version.
"""

from __future__ import annotations

from ._cache import cache  # noqa: F401
from ._device import get_device, set_device  # noqa: F401
from .core.audio import *  # noqa: F401,F403
from .core.constantq import *  # noqa: F401,F403
from .core.convert import *  # noqa: F401,F403
from .core.harmonic import f0_harmonics, interp_harmonics, salience  # noqa: F401
from .core.intervals import *  # noqa: F401,F403
from .core.notation import *  # noqa: F401,F403
from .core.pitch import *  # noqa: F401,F403
from .core.spectrum import *  # noqa: F401,F403
from .core.spectrum_ext import fmt, iirt, reassigned_spectrogram  # noqa: F401
from .util.exceptions import LibrosaError, ParameterError  # noqa: F401
from .util.files import cite, ex, example  # noqa: F401
from .version import show_versions, version as __version__  # noqa: F401

from . import (beat, core, decompose, effects, feature, filters, io, onset, ops,  # noqa: F401
               segment, sequence, util)


_LAZY = ("display", "parallel")


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return importlib.import_module("." + name, __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
