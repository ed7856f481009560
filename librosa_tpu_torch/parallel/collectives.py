"""Sharded values and the collectives between their shards.

A sharded value is the list of its local shards: one tensor per position of
a :class:`Line` that the calling process owns, each on its position's
device. A stage of a sharded chain is a comprehension over those lists; a
collective takes whole lists and returns lists. Within one process a
shard moves to another position by ``.to(device)``. On one device that
returns the same tensor, so a received shard may alias its neighbour's and
is never written in place. Between processes the collectives run over
``torch.distributed`` (:func:`~.mesh.init_distributed`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..util.exceptions import ParameterError
from .mesh import Mesh

__all__ = ["Line", "split", "join", "ppermute", "shift_right", "shift_left", "pmax", "psum",
           "all_gather", "axis_index"]

Shards = List[torch.Tensor]


class Line:
    """The positions a chain runs over, in order, and which of them this process owns.

    :meth:`of` takes one line of a mesh along an axis (the other axes at the
    indices ``at``, default 0: a chain replicates over the axes it does not
    name, and the port computes that one replica); :meth:`whole` takes every
    position. ``local`` lists the positions of the calling process and
    ``home`` is the device of its first one.
    """

    def __init__(self, devices: Sequence[torch.device], processes: Sequence[int], rank: int):
        self.devices = list(devices)
        self.processes = [int(p) for p in processes]
        self.rank = rank
        self.size = len(self.devices)
        self.local = [i for i, p in enumerate(self.processes) if p == rank]
        if not self.local:
            raise ParameterError(f"process {rank} owns no position of this line: the port "
                                 "computes one replica, the positions at index 0 of the "
                                 "axes a chain does not name")
        self.spans = len(set(self.processes)) > 1
        if self.spans:
            world = torch.distributed.get_world_size()
            if set(self.processes) != set(range(world)):
                raise ParameterError(f"a line across processes holds a position of each of "
                                     f"the {world}, not of {sorted(set(self.processes))}")
        self.home = self.devices[self.local[0]]

    @classmethod
    def of(cls, mesh: Mesh, axis_name: str, at: Optional[Dict[str, int]] = None) -> "Line":
        if axis_name not in mesh.axis_names:
            raise ParameterError(f"mesh axes {mesh.axis_names} have no {axis_name!r}")
        at = at or {}
        index = tuple(slice(None) if name == axis_name else int(at.get(name, 0))
                      for name in mesh.axis_names)
        return cls(mesh.devices[index], mesh.processes[index], mesh.rank)

    @classmethod
    def whole(cls, mesh: Mesh) -> "Line":
        return cls(list(mesh.devices.flat), list(mesh.processes.flat), mesh.rank)

    @property
    def local_devices(self) -> List[torch.device]:
        return [self.devices[i] for i in self.local]


def axis_index(line: Line) -> List[int]:
    """Each local shard's position along the line (``lax.axis_index``)."""
    return list(line.local)


def split(x: torch.Tensor, line: Line, *, dim: int = -1) -> Shards:
    """The local shards of ``x``: equal contiguous blocks along ``dim``, one per position."""
    n = x.shape[dim]
    if n % line.size:
        raise ParameterError(f"length {n} does not split into {line.size} equal shards")
    per = n // line.size
    return [x.narrow(dim, i * per, per).to(line.devices[i]) for i in line.local]


def _as_real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def _gather(values: Shards, line: Line) -> Shards:
    """Every position's value, in line order, on this process's home device.

    Across processes each rank sends its positions' values, stacked and
    padded to the most any rank owns, by one ``all_gather``; the values
    must then share a shape and dtype.
    """
    if not line.spans:
        return [v.to(line.home) for v in values]
    dist = torch.distributed
    counts = [line.processes.count(r) for r in range(dist.get_world_size())]
    mine = torch.stack([_as_real(v).contiguous() for v in values])
    if len(values) < max(counts):
        pad = mine.new_zeros((max(counts) - len(values), *mine.shape[1:]))
        mine = torch.cat([mine, pad])
    parts = [torch.empty_like(mine) for _ in counts]
    dist.all_gather(parts, mine)
    seen = [0] * len(counts)
    out = []
    for p in line.processes:
        v = parts[p][seen[p]]
        seen[p] += 1
        out.append(torch.view_as_complex(v) if values[0].is_complex() else v)
    return out


def join(values: Shards, line: Line, *, dim: int = -1) -> torch.Tensor:
    """The whole value: every position's shard concatenated along ``dim`` on the home device."""
    return torch.cat(_gather(values, line), dim=dim)


def all_gather(values: Shards, line: Line) -> Shards:
    """Every position's value stacked on a new leading axis, given to each local shard."""
    stacked = torch.stack(_gather(values, line))
    return [stacked.to(d) for d in line.local_devices]


def pmax(values: Shards, line: Line) -> Shards:
    """The elementwise maximum over every position's value, given to each local shard."""
    m = torch.stack([v.to(line.home) for v in values]).amax(dim=0)
    if line.spans:
        torch.distributed.all_reduce(m, op=torch.distributed.ReduceOp.MAX)
    return [m.to(d) for d in line.local_devices]


def psum(values: Shards, line: Line) -> Shards:
    """The sum over every position's value, given to each local shard; autograd flows back
    through it (across processes by ``torch.distributed.nn``'s ``all_reduce``)."""
    s = values[0].to(line.home)
    for v in values[1:]:
        s = s + v.to(line.home)
    if line.spans:
        from torch.distributed.nn.functional import all_reduce

        s = all_reduce(s)
    return [s.to(d) for d in line.local_devices]


def ppermute(values: Shards, line: Line, pairs: Sequence[Tuple[int, int]]) -> Shards:
    """Each ``(source, destination)`` pair sends the source's value to the destination.

    A local position that no pair names as destination receives zeros, as
    ``lax.ppermute`` gives. Within a process a value moves by ``.to``;
    between processes by one ``batch_isend_irecv``, the pairs in one order
    on every rank. Every value must share a shape and dtype.
    """
    where = {p: k for k, p in enumerate(line.local)}
    out: List[Optional[torch.Tensor]] = [None] * len(values)
    ops = []
    dist = torch.distributed
    for src, dst in sorted(pairs):
        if src in where and dst in where:
            out[where[dst]] = values[where[src]].to(line.devices[dst])
        elif src in where:
            ops.append(dist.P2POp(dist.isend, values[where[src]].contiguous(),
                                  line.processes[dst], tag=src * line.size + dst))
        elif dst in where:
            buf = torch.empty_like(values[where[dst]])
            out[where[dst]] = buf
            ops.append(dist.P2POp(dist.irecv, buf, line.processes[src],
                                  tag=src * line.size + dst))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [torch.zeros_like(v) if o is None else o for v, o in zip(values, out)]


def shift_right(values: Shards, line: Line) -> Shards:
    """Each position receives its left neighbour's value; position 0 receives zeros."""
    return ppermute(values, line, [(i, i + 1) for i in range(line.size - 1)])


def shift_left(values: Shards, line: Line) -> Shards:
    """Each position receives its right neighbour's value; the last receives zeros."""
    return ppermute(values, line, [(i + 1, i) for i in range(line.size - 1)])
