"""librosa_tpu_torch: audio and music analysis on PyTorch and CUDA.

The PyTorch port of ``librosa_tpu``, with the same librosa-style namespace
(``feature.melspectrogram``, ``feature.mfcc``, ``filters.mel``,
``filters.get_window``, flat ``power_to_db``, ``util.*``) and the same array
layout: time on the last axis, bins on axis -2, any leading dims.

Inputs that are not tensors go to the default device, ``cuda`` unless
:func:`set_device` chose another; tensors stay where they are. On the card
the mel spectrogram runs as one hand-written CUDA kernel
(``csrc/stft_mel.cu``); on the CPU each function runs its plain PyTorch
version.
"""

from __future__ import annotations

from ._device import get_device, set_device  # noqa: F401
from .core.convert import *  # noqa: F401,F403
from .core.spectrum import *  # noqa: F401,F403
from .util.exceptions import LibrosaError, ParameterError  # noqa: F401
from .version import show_versions, version as __version__  # noqa: F401

from . import core, feature, filters, ops, util  # noqa: F401
