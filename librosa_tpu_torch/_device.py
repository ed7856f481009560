"""Where the port's public functions put the arrays they are given.

A torch tensor stays on its own device: that device is the caller's
choice. Anything else (numpy arrays, lists, scalars) goes to the package
default, which is ``cuda`` unless :func:`set_device` says otherwise. With
the default on ``cuda`` and no card present, conversion raises instead of
quietly computing on the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator

import numpy as np
import torch

__all__ = ["set_device", "get_device", "as_tensor", "device_table", "device_object", "exact_f32"]

_default = torch.device("cuda")


def set_device(device: Any) -> None:
    """Set the device that non-tensor inputs go to (``"cuda"``, ``"cpu"``, ...)."""
    global _default
    _default = torch.device(device)


def get_device() -> torch.device:
    """The device that non-tensor inputs go to."""
    return _default


def as_tensor(x: Any) -> torch.Tensor:
    """``x`` as a tensor: tensors keep their device, other input goes to the default."""
    if isinstance(x, torch.Tensor):
        return x
    device = _default
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "librosa_tpu_torch's default device is 'cuda' but CUDA is not "
            "available; call librosa_tpu_torch.set_device('cpu') to compute "
            "on the CPU, or pass a CPU tensor"
        )
    a = np.asarray(x)
    # torch may share the buffer: it warns on a read-only one and refuses negative strides
    if not a.flags.writeable or any(s < 0 for s in a.strides):
        a = a.copy()
    return torch.as_tensor(a, device=device)


_tables: dict = {}


def device_table(key: tuple, make: Callable[[], Any], device: torch.device,
                 dtype: torch.dtype) -> torch.Tensor:
    """One device copy per (``key``, device, dtype) of the host table ``make()``.

    Windows, filterbanks, DCT matrices and FFT twiddles are made on the host
    once per configuration; this keeps them resident on the card so a call
    uploads nothing. ``key`` must identify the table's configuration.
    """
    full = (key, str(device), dtype)
    table = _tables.get(full)
    if table is None:
        if len(_tables) >= 128:
            _tables.clear()
        # C order always: torch.tensor would keep the strides of a transposed array
        table = torch.tensor(np.ascontiguousarray(make()), dtype=dtype, device=device)
        _tables[full] = table
    return table


def device_object(key: tuple, make: Callable[[torch.device], Any], device: torch.device) -> Any:
    """One object per (``key``, device) that ``make(device)`` builds, kept beside
    :func:`device_table`'s tables: a table of several device arrays, such as a
    transition matrix's runs of finite entries."""
    full = (key, str(device), None)
    obj = _tables.get(full)
    if obj is None:
        if len(_tables) >= 128:
            _tables.clear()
        obj = make(device)
        _tables[full] = obj
    return obj


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """Run float32 matrix products in full float32 on the card (no TF32).

    Sets ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` to False for the block and restores
    them after it. The port's matrix products (basis projection, DCT) run
    inside it, because the goldens hold the mel spectrogram to 115 dB and
    TF32 keeps about three decimal digits.
    """
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
