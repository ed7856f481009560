"""Type aliases of the public API, named as librosa names them.

Array arguments take numpy arrays and torch tensors alike (``_ArrayLike``);
window specifications also take a name, a ``(name, parameter)`` tuple, a
Kaiser beta, a callable or the window's samples.
"""

from __future__ import annotations

from typing import Any, Callable, Generator, Literal, Sequence, Union

import numpy as np
import torch

_ArrayLike = Union[np.ndarray, torch.Tensor]

# window specifications: name, (name, param), scalar beta, callable, or samples
_WindowSpec = Union[
    str,
    "tuple[Any, ...]",
    float,
    Callable[[int], np.ndarray],
    np.ndarray,
    torch.Tensor,
    Sequence[float],
]

_IterableLike = Union[list, tuple, Generator]
_SequenceLike = Union[Sequence, np.ndarray, torch.Tensor]

_BoolLike_co = Union[bool, np.bool_]
_IntLike_co = Union[bool, int, np.integer, np.bool_]
_FloatLike_co = Union[float, np.floating, np.integer, np.bool_]
_ComplexLike_co = Union[complex, np.number, np.bool_]
_ScalarLike_co = Union[complex, str, bytes, np.generic]

# the padding modes of numpy.pad
_ModeKind = Literal[
    "constant",
    "edge",
    "linear_ramp",
    "maximum",
    "mean",
    "median",
    "minimum",
    "reflect",
    "symmetric",
    "wrap",
    "empty",
]

# the padding modes that centring an STFT takes: each needs only the samples near an end
_STFTPad = Literal[
    "constant",
    "edge",
    "linear_ramp",
    "reflect",
    "symmetric",
    "empty",
]

_PadMode = Union[_ModeKind, Callable[..., Any]]
_PadModeSTFT = Union[_STFTPad, Callable[..., Any]]
