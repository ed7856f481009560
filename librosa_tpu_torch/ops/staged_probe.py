"""Staged-copy probes: the CUDA kernels of the copy diagnostics and their plain versions.

Two functions of a buffer of float32 rows, cut into tiles of
``rows_per_tile`` rows of ``width`` floats. Tile ``i`` of track ``k`` (with
``w = i % tiles_per_track``) starts at row
``k * track_rows + row_offset + (w % wrap) * tile_stride``; edge tiles (the
first of a track and those from ``e_start`` on, where ``n_edge > 0``) are
read from ``edges[k * n_edge + eslot]`` instead, with ``eslot`` 0 for the
first tile and ``w - (e_start - 1)`` for the others.

- :func:`colsum_probe`: the column sums of the **last** tile, as ``(1,
  width)``. The kernel sums every tile; the last one's sums are the output.
- :func:`rowprobe`: per tile, ``probe[t]`` is the sum of ``probe_width``
  floats starting ``probe_offset * width + t * probe_width`` floats into the
  tile, for ``t < tt``, plus the sum of ``tables`` and ``scratch`` (a
  count of ones). It is broadcast to ``n_out`` rows and written as
  ``out[:, i*tt:(i+1)*tt]`` (strided), or as ``out[i]`` when
  ``contiguous``.

On a CUDA tensor each launches its kernel from ``csrc/staged_probe.cu``
(built for ``sm_90a`` at first use by ``ops/_build.py``) or raises; on a CPU
tensor it runs its plain version, :func:`colsum_probe_reference` or
:func:`rowprobe_reference` (index gathers, then ``sum``).

Source note. ``stage_colsum`` replaces the TPU kernels of
``scripts/dma_bisect.py:make_m0`` and ``scripts/dma_pipeline_micro.py:run``;
``stage_rowprobe`` those of ``make_m_out``, ``make_m_edge``,
``make_m_kitchen`` and ``make_m_scale``. Bytes bound both on an H100: one
add per staged float. A tile's full span is staged (144 rows of 512 floats,
288 KB, at the default geometry), which is more than a block's 227 KB of
shared memory, so the kernels stage it in chunks of whole rows of at most
32 KB, each one TMA bulk copy into a ring of as many slots as half an SM's
shared memory holds (two blocks an SM). One producer warp keeps the ring
full, eight consumer warps reduce it, each block takes an equal range of
(tile, chunk) pairs, and a store warp writes the row probe's output from
shared memory with its own float4 stores while the staging goes on
(``csrc/staged_probe.cu``, ``csrc/staged_schedule.cuh``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..util.exceptions import ParameterError
from . import _build

__all__ = [
    "colsum_probe", "colsum_probe_reference", "rowprobe", "rowprobe_reference",
    "tile_starts", "chunk_rows_for", "launches",
]

#: Kernel launches so far, by kernel. :func:`colsum_probe` adds one to
#: ``"stage_colsum"`` and :func:`rowprobe` one to ``"stage_rowprobe"`` where
#: they launch the kernel and nowhere else; callers may reset them to 0.
launches: Dict[str, int] = {"stage_colsum": 0, "stage_rowprobe": 0}

CHUNK_BYTES = 32768  # one staged chunk; csrc/staged_probe.cu:kChunkBytes
_COLSUM_MAX_WIDTH = 1024


def chunk_rows_for(width: int, rows_per_tile: int, probe_width: Optional[int] = None) -> int:
    """Rows per staged chunk: as many as fit in 32 KB, whole probe runs each."""
    rows = min(rows_per_tile, CHUNK_BYTES // (4 * width))
    if probe_width is not None:
        while rows > 0 and (rows * width) % probe_width:
            rows -= 1
    if rows <= 0:
        raise ParameterError(f"no chunk of whole rows of width {width} fits in "
                             f"{CHUNK_BYTES} bytes with probe_width {probe_width}")
    return rows


def tile_starts(n_tiles: int, *, tiles_per_track: Optional[int] = None, track_rows: int = 0,
                row_offset: int = 0, tile_stride: int, wrap: Optional[int] = None,
                n_edge: int = 0, e_start: Optional[int] = None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(start_row, is_edge, edge_slot)`` of every tile, as numpy arrays."""
    tpt = n_tiles if tiles_per_track is None else tiles_per_track
    wrap = tpt if wrap is None else wrap
    tile = np.arange(n_tiles, dtype=np.int64)
    track, within = tile // tpt, tile % tpt
    start = track * track_rows + row_offset + (within % wrap) * tile_stride
    if n_edge > 0:
        is_edge = (within == 0) | (within >= e_start)
        eslot = track * n_edge + np.where(within == 0, 0, within - (e_start - 1))
    else:
        is_edge = np.zeros(n_tiles, dtype=bool)
        eslot = np.zeros(n_tiles, dtype=np.int64)
    return start, is_edge, eslot


def _geometry(rows: torch.Tensor, *, rows_per_tile, width, n_tiles, tiles_per_track,
              track_rows, row_offset, tile_stride, wrap, n_edge, e_start, edges):
    """Checks the tiling against ``rows`` (and ``edges``); returns the row count."""
    for name, v in (("rows_per_tile", rows_per_tile), ("width", width), ("n_tiles", n_tiles),
                    ("tile_stride", tile_stride)):
        if v <= 0:
            raise ParameterError(f"{name} must be positive, got {v}")
    if width % 4:
        raise ParameterError(f"width must be a multiple of 4 floats, got {width}")
    tpt = n_tiles if tiles_per_track is None else tiles_per_track
    if tpt <= 0 or n_tiles % tpt:
        raise ParameterError(f"n_tiles={n_tiles} is not a whole number of tracks of {tpt}")
    if wrap is not None and wrap <= 0:
        raise ParameterError(f"wrap must be positive, got {wrap}")
    if rows.dtype != torch.float32:
        raise ParameterError(f"rows must be float32, not {rows.dtype}")
    if not rows.is_contiguous():
        raise ParameterError("rows must be contiguous")
    if rows.numel() % width:
        raise ParameterError(f"rows has {rows.numel()} floats, not whole rows of {width}")
    n_rows = rows.numel() // width
    if n_edge > 0 and (e_start is None or not 1 <= e_start <= tpt):
        raise ParameterError(f"e_start must lie in 1 .. {tpt}, got {e_start}")
    start, is_edge, eslot = tile_starts(
        n_tiles, tiles_per_track=tpt, track_rows=track_rows, row_offset=row_offset,
        tile_stride=tile_stride, wrap=wrap, n_edge=n_edge, e_start=e_start)
    inner = start[~is_edge]
    if inner.size and (inner.min() < 0 or inner.max() + rows_per_tile > n_rows):
        raise ParameterError(
            f"tiles reach rows {int(inner.min())} .. {int(inner.max()) + rows_per_tile} "
            f"of a buffer of {n_rows} rows")
    if n_edge > 0:
        if int(np.max(eslot - (np.arange(n_tiles) // tpt) * n_edge)) >= n_edge:
            raise ParameterError(f"{tpt - e_start + 1} edge tiles per track need more "
                                 f"than n_edge={n_edge} slots")
        want = (n_tiles // tpt * n_edge, rows_per_tile, width)
        if edges is None or tuple(edges.shape) != want:
            raise ParameterError(f"edges must have shape {want}, got "
                                 f"{None if edges is None else tuple(edges.shape)}")
        if edges.dtype != torch.float32 or not edges.is_contiguous() \
                or edges.device != rows.device:
            raise ParameterError("edges must be contiguous float32 on the device of rows")
    return n_rows


def _output(out: Optional[torch.Tensor], shape: Tuple[int, ...], device) -> torch.Tensor:
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=device)
    if tuple(out.shape) != shape or out.dtype != torch.float32 or out.device != device \
            or not out.is_contiguous():
        raise ParameterError(f"out must be a contiguous float32 {shape} tensor on {device}")
    return out


def _aligned(*tensors: Optional[torch.Tensor]) -> None:
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ParameterError("the kernel's bulk copies need 16-byte aligned buffers")


def _launch_fn(symbol: str, arg_types: list):
    fn = getattr(_build.load("staged_probe"), symbol)
    if fn.argtypes is None:
        fn.argtypes = arg_types
        fn.restype = ctypes.c_int
    return fn


_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def colsum_probe(rows: torch.Tensor, *, rows_per_tile: int = 144, width: int = 512,
                 tt: int = 128, n_tiles: int = 4096, wrap: Optional[int] = 128,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Column sums of the last of ``n_tiles`` tiles, as ``(1, width)``.

    Tile ``i`` is ``rows_per_tile`` rows from row ``(i % wrap) * tt`` of
    ``rows`` viewed as ``(-1, width)``. On a CUDA tensor the kernel stages
    every tile and writes the last one's sums; on a CPU tensor this returns
    :func:`colsum_probe_reference`. ``out`` may be a preallocated ``(1,
    width)`` tensor.
    """
    if rows.device.type == "cpu":
        return colsum_probe_reference(rows, rows_per_tile=rows_per_tile, width=width, tt=tt,
                                      n_tiles=n_tiles, wrap=wrap)
    if rows.device.type != "cuda":
        raise ParameterError(f"colsum_probe runs on cuda or cpu, not {rows.device}")
    _geometry(rows, rows_per_tile=rows_per_tile, width=width, n_tiles=n_tiles,
              tiles_per_track=None, track_rows=0, row_offset=0, tile_stride=tt, wrap=wrap,
              n_edge=0, e_start=None, edges=None)
    if width > _COLSUM_MAX_WIDTH:
        raise ParameterError(f"stage_colsum takes width <= {_COLSUM_MAX_WIDTH}, got {width}")
    out = _output(out, (1, width), rows.device)
    _aligned(rows)
    fn = _launch_fn("stage_colsum_launch",
                    [_P, _P, _I64, _I64, _I64, _I32, _I32, _I32, _P])
    with torch.cuda.device(rows.device):
        err = fn(rows.data_ptr(), out.data_ptr(), n_tiles, tt,
                 n_tiles if wrap is None else wrap, width, rows_per_tile,
                 chunk_rows_for(width, rows_per_tile),
                 torch.cuda.current_stream(rows.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stage_colsum kernel launch failed with CUDA error {err}")
    launches["stage_colsum"] += 1
    return out


def colsum_probe_reference(rows: torch.Tensor, *, rows_per_tile: int = 144, width: int = 512,
                           tt: int = 128, n_tiles: int = 4096,
                           wrap: Optional[int] = 128) -> torch.Tensor:
    """The plain PyTorch version of :func:`colsum_probe`, on ``rows``' device.

    Gathers every tile's rows, sums each tile's columns and keeps the last.
    """
    n_rows = _geometry(rows, rows_per_tile=rows_per_tile, width=width, n_tiles=n_tiles,
                       tiles_per_track=None, track_rows=0, row_offset=0, tile_stride=tt,
                       wrap=wrap, n_edge=0, e_start=None, edges=None)
    start, _, _ = tile_starts(n_tiles, tile_stride=tt, wrap=wrap)
    idx = torch.from_numpy(start[:, None] + np.arange(rows_per_tile)).to(rows.device)
    sums = rows.reshape(n_rows, width)[idx].sum(dim=1)
    return sums[-1:]


def _rowprobe_checks(rows, edges, tables, *, rows_per_tile, width, tt, n_tiles,
                     tiles_per_track, track_rows, row_offset, tile_stride, wrap, n_edge,
                     e_start, probe_offset, probe_width, n_out, contiguous, out_cols, scratch):
    """Validates a row-probe call; returns ``(n_rows, out_shape, probe_width, out_cols)``."""
    n_rows = _geometry(rows, rows_per_tile=rows_per_tile, width=width, n_tiles=n_tiles,
                       tiles_per_track=tiles_per_track, track_rows=track_rows,
                       row_offset=row_offset, tile_stride=tile_stride, wrap=wrap,
                       n_edge=n_edge, e_start=e_start, edges=edges)
    pw = width if probe_width is None else probe_width
    if tt <= 0 or n_out <= 0 or pw <= 0 or probe_offset < 0 or scratch < 0:
        raise ParameterError("tt, n_out and probe_width must be positive, probe_offset "
                             "and scratch >= 0")
    if (probe_offset * width) % pw:
        raise ParameterError(f"probe_offset {probe_offset} rows is not a whole number of "
                             f"probe runs of {pw} floats")
    if probe_offset * width + tt * pw > rows_per_tile * width:
        raise ParameterError(f"the probe reads past the tile: offset {probe_offset} rows + "
                             f"{tt} runs of {pw} floats > {rows_per_tile} rows of {width}")
    if tables is not None and (tables.dtype != torch.float32 or tables.device != rows.device
                               or not tables.is_contiguous()):
        raise ParameterError("tables must be a contiguous float32 tensor on the device of rows")
    tpt = n_tiles if tiles_per_track is None else tiles_per_track
    n_tracks = n_tiles // tpt
    if contiguous:
        return n_rows, (n_tiles, n_out, tt), pw, tt
    cols = tpt * tt if out_cols is None else out_cols
    if not 0 < cols <= tpt * tt:
        raise ParameterError(f"out_cols must lie in 1 .. {tpt * tt}, got {cols}")
    shape = (n_out, cols) if n_tracks == 1 else (n_tracks, n_out, cols)
    return n_rows, shape, pw, cols


def rowprobe(rows: torch.Tensor, *, rows_per_tile: int = 144, width: int = 512, tt: int = 128,
             n_tiles: int = 4096, wrap: Optional[int] = 128, tile_stride: Optional[int] = None,
             tiles_per_track: Optional[int] = None, track_rows: int = 0, row_offset: int = 0,
             n_out: int = 128, contiguous: bool = False, out_cols: Optional[int] = None,
             group: int = 1, edges: Optional[torch.Tensor] = None, n_edge: int = 0,
             e_start: Optional[int] = None, probe_offset: int = 0,
             probe_width: Optional[int] = None, tables: Optional[torch.Tensor] = None,
             scratch: int = 0, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-tile row probes, broadcast to ``n_out`` rows (see the module docstring).

    ``tile_stride`` defaults to ``tt`` rows and ``probe_width`` to ``width``;
    ``probe_offset`` is in rows. ``wrap=None`` means no wrap. The output is
    ``(n_out, out_cols)`` for one track, ``(n_tracks, n_out, out_cols)`` for
    more, ``out_cols`` defaulting to ``tiles_per_track * tt`` (a smaller
    value drops the columns past it), or ``(n_tiles, n_out, tt)`` when
    ``contiguous``. ``edges`` is ``(n_tracks * n_edge, rows_per_tile,
    width)``; ``tables`` any float32 tensor whose sum is added; ``scratch``
    a count of ones whose sum is added. ``group`` is how many consecutive
    tiles of a track the kernel gathers before it writes them, so that each
    strided output row is written as one run of up to ``group * tt``
    contiguous floats; it does not change the result.
    On a CUDA tensor this launches the kernel or raises; on a CPU tensor
    it returns :func:`rowprobe_reference`. ``out`` may be a preallocated
    output of the right shape.
    """
    stride = tt if tile_stride is None else tile_stride
    kw = dict(rows_per_tile=rows_per_tile, width=width, tt=tt, n_tiles=n_tiles, wrap=wrap,
              tile_stride=stride, tiles_per_track=tiles_per_track, track_rows=track_rows,
              row_offset=row_offset, n_out=n_out, contiguous=contiguous, out_cols=out_cols,
              edges=edges, n_edge=n_edge, e_start=e_start, probe_offset=probe_offset,
              probe_width=probe_width, tables=tables, scratch=scratch)
    if rows.device.type == "cpu":
        return rowprobe_reference(rows, **kw)
    if rows.device.type != "cuda":
        raise ParameterError(f"rowprobe runs on cuda or cpu, not {rows.device}")
    if group <= 0:
        raise ParameterError(f"group must be positive, got {group}")
    _, shape, pw, cols = _rowprobe_checks(
        rows, edges, tables, rows_per_tile=rows_per_tile, width=width, tt=tt, n_tiles=n_tiles,
        tiles_per_track=tiles_per_track, track_rows=track_rows, row_offset=row_offset,
        tile_stride=stride, wrap=wrap, n_edge=n_edge, e_start=e_start,
        probe_offset=probe_offset, probe_width=probe_width, n_out=n_out,
        contiguous=contiguous, out_cols=out_cols, scratch=scratch)
    out = _output(out, shape, rows.device)
    _aligned(rows, edges)
    tpt = n_tiles if tiles_per_track is None else tiles_per_track
    fn = _launch_fn("stage_rowprobe_launch",
                    [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I32, _I64, _I32,
                     _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I64, _I64, _I32, _P])
    with torch.cuda.device(rows.device):
        err = fn(rows.data_ptr(), 0 if edges is None else edges.data_ptr(),
                 0 if tables is None else tables.data_ptr(), out.data_ptr(),
                 n_tiles, tpt, track_rows, row_offset, stride, tpt if wrap is None else wrap,
                 n_edge, 0 if e_start is None else e_start, width, rows_per_tile,
                 chunk_rows_for(width, rows_per_tile, pw), group, probe_offset * width, pw, tt,
                 n_out, int(contiguous), cols, 0 if tables is None else tables.numel(),
                 scratch, torch.cuda.current_stream(rows.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stage_rowprobe kernel launch failed with CUDA error {err}")
    launches["stage_rowprobe"] += 1
    return out


def rowprobe_reference(rows: torch.Tensor, *, rows_per_tile: int = 144, width: int = 512,
                       tt: int = 128, n_tiles: int = 4096, wrap: Optional[int] = 128,
                       tile_stride: Optional[int] = None,
                       tiles_per_track: Optional[int] = None, track_rows: int = 0,
                       row_offset: int = 0, n_out: int = 128, contiguous: bool = False,
                       out_cols: Optional[int] = None, edges: Optional[torch.Tensor] = None,
                       n_edge: int = 0, e_start: Optional[int] = None, probe_offset: int = 0,
                       probe_width: Optional[int] = None, tables: Optional[torch.Tensor] = None,
                       scratch: int = 0) -> torch.Tensor:
    """The plain PyTorch version of :func:`rowprobe`, on ``rows``' device.

    Gathers the probed floats of every tile (from ``rows`` or ``edges``),
    sums each run of ``probe_width``, adds the table and scratch sums and
    broadcasts to the output layout.
    """
    stride = tt if tile_stride is None else tile_stride
    n_rows, shape, pw, cols = _rowprobe_checks(
        rows, edges, tables, rows_per_tile=rows_per_tile, width=width, tt=tt, n_tiles=n_tiles,
        tiles_per_track=tiles_per_track, track_rows=track_rows, row_offset=row_offset,
        tile_stride=stride, wrap=wrap, n_edge=n_edge, e_start=e_start,
        probe_offset=probe_offset, probe_width=probe_width, n_out=n_out,
        contiguous=contiguous, out_cols=out_cols, scratch=scratch)
    device = rows.device
    start, is_edge, eslot = tile_starts(
        n_tiles, tiles_per_track=tiles_per_track, track_rows=track_rows, row_offset=row_offset,
        tile_stride=stride, wrap=wrap, n_edge=n_edge, e_start=e_start)
    # the whole rows that hold a tile's probed floats, gathered per tile
    n_prow = -(-(tt * pw) // width)
    prow = probe_offset + np.arange(n_prow)

    def runs(src2d: torch.Tensor, first_rows: np.ndarray) -> torch.Tensor:
        idx = torch.from_numpy(first_rows[:, None] + prow).to(device)
        probed = src2d[idx].reshape(len(first_rows), n_prow * width)[:, :tt * pw]
        return probed.reshape(len(first_rows), tt, pw).sum(dim=-1)

    probe = runs(rows.reshape(n_rows, width), np.where(is_edge, 0, start))
    if is_edge.any():
        probe[torch.from_numpy(is_edge).to(device)] = runs(
            edges.reshape(-1, width), eslot[is_edge] * rows_per_tile)
    if tables is not None:
        probe = probe + tables.sum()
    if scratch:
        probe = probe + torch.ones(scratch, dtype=torch.float32, device=device).sum()
    if contiguous:
        return probe[:, None, :].expand(shape).contiguous()
    tpt = n_tiles if tiles_per_track is None else tiles_per_track
    by_track = probe.reshape(n_tiles // tpt, 1, tpt * tt)[..., :cols]
    return by_track.expand(n_tiles // tpt, n_out, cols).reshape(shape).contiguous()
