"""Device meshes: named axes of mesh positions, each position a device of one process.

A position is where one shard of a sharded value lives. Positions may
repeat a device: ``[torch.device("cuda:0")] * 8`` lays an 8-way mesh on one
card, ``[torch.device("cpu")] * 8`` on the CPU. Across processes
(:func:`init_distributed`) each position also names the process that owns
it, and a process computes only the shards of its own positions.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import get_device
from ..util.exceptions import ParameterError

__all__ = ["Mesh", "make_mesh", "time_mesh", "pod_mesh", "init_distributed"]

# (process, device) of every position the processes offered at init_distributed, in rank order
_world: List[Tuple[int, torch.device]] = []


class Mesh:
    """Positions laid out in a grid of named axes.

    ``devices`` and ``processes`` are arrays of the mesh's shape: the device
    of each position and the rank of the process that owns it. ``shape``
    maps each axis name to its size, as ``jax.sharding.Mesh.shape`` does.
    ``rank`` is the calling process's rank (0 without torch.distributed).
    """

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], processes: np.ndarray,
                 rank: int = 0):
        if devices.shape != processes.shape or devices.ndim != len(axis_names):
            raise ParameterError(f"devices {devices.shape}, processes {processes.shape} and "
                                 f"axes {tuple(axis_names)} do not agree")
        if len(set(axis_names)) != len(axis_names):
            raise ParameterError(f"axis names must differ: {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.processes = processes
        self.rank = int(rank)

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        axes = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        kinds = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({axes}; devices {kinds}; processes {sorted({int(p) for p in self.processes.flat})})"


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _visible() -> List[Tuple[int, torch.device]]:
    """``(process, device)`` of every default position: every process's devices after
    :func:`init_distributed`, else every card for the ``cuda`` default, else one CPU."""
    if _world:
        return list(_world)
    return [(_rank(), d) for d in _local_devices()]


def _local_devices() -> List[torch.device]:
    if get_device().type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "librosa_tpu_torch's default device is 'cuda' but CUDA is not available; "
                "call librosa_tpu_torch.set_device('cpu') or pass devices=")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [get_device()]


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *, devices: Any = None,
              processes: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh of logical ``shape`` with one name per axis.

    ``devices`` (default: every visible position, :func:`init_distributed`'s
    across processes) are laid out in order; a device may repeat, so that
    one card or the CPU hosts several positions. ``processes`` gives the
    owning rank of each device (default: the owners that
    :func:`init_distributed` recorded, or the calling process).
    """
    if devices is None:
        owners, devices = (list(t) for t in zip(*_visible()))
        if processes is None:
            processes = owners
    devices = [torch.device(d) for d in devices]
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"Mesh of shape {tuple(shape)} needs {n} devices; "
                         f"only {len(devices)} available")
    if processes is None:
        processes = [_rank()] * len(devices)
    if len(processes) != len(devices):
        raise ParameterError(f"{len(processes)} processes for {len(devices)} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(tuple(shape)), axis_names,
                np.asarray(processes[:n], dtype=np.int64).reshape(tuple(shape)), _rank())


def time_mesh(n_devices: Optional[int] = None, *, devices: Any = None) -> Mesh:
    """1-D mesh named ``time``, the axis every ``*_sharded`` chain shards over.

    ``n_devices`` defaults to every position of ``devices`` (default: every
    visible one). Each position owns a contiguous span of the signal and
    exchanges halo samples with its neighbours.
    """
    if devices is None:
        owners, devices = (list(t) for t in zip(*_visible()))
    else:
        owners = None
    if n_devices is None:
        n_devices = len(devices)
    return make_mesh((n_devices,), ("time",), devices=devices, processes=owners)


def pod_mesh(*, time_axis: Optional[int] = None, track_axis: int = 1,
             devices: Any = None) -> Mesh:
    """2-D ``("track", "time")`` mesh over every visible position (or ``devices``).

    ``time_axis`` defaults to ``n // track_axis``. A chain that shards over
    ``time`` replicates over ``track`` (``shard_map``'s rule for an axis it
    does not name): the port computes one replica, the line of positions at
    ``track`` index 0.
    """
    owners = None
    if devices is None:
        owners, devices = (list(t) for t in zip(*_visible()))
    n = len(devices)
    if time_axis is None:
        if n % track_axis:
            raise ValueError(f"{n} devices not divisible by track_axis={track_axis}")
        time_axis = n // track_axis
    return make_mesh((track_axis, time_axis), ("track", "time"), devices=devices,
                     processes=owners)


def init_distributed(coordinator_address: Optional[str] = None, *,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     devices: Any = None, **kwargs: Any) -> None:
    """Join the processes of a mesh (``torch.distributed.init_process_group``).

    ``coordinator_address`` is ``host:port`` (taken as ``tcp://``), any
    ``init_method`` URL (``tcp://``, ``file://``), or None for ``env://``.
    ``devices`` are this process's positions (default: every card for the
    ``cuda`` default, else one CPU). Cards join by NCCL and CPUs by gloo;
    the two never stand in for each other, and NCCL missing raises. After
    the call :func:`make_mesh`'s default spans every process's positions,
    in rank order. ``kwargs`` go to ``init_process_group``.
    """
    import torch.distributed as dist

    devices = [torch.device(d) for d in (devices or _local_devices())]
    kinds = {d.type for d in devices}
    if kinds == {"cuda"}:
        backend = "nccl"
        if not dist.is_nccl_available():
            raise RuntimeError("a mesh of cards needs NCCL, which this torch lacks")
        torch.cuda.set_device(devices[0])
    elif kinds == {"cpu"}:
        backend = "gloo"
    else:
        raise ParameterError(f"a process's positions are all cards or all CPUs, not {kinds}")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = "tcp://" + coordinator_address
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if num_processes is None else num_processes,
                            rank=-1 if process_id is None else process_id, **kwargs)
    table: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(table, [str(d) for d in devices])
    _world[:] = [(rank, torch.device(d)) for rank, ds in enumerate(table) for d in ds]
