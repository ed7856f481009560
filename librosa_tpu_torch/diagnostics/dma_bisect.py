"""Staged-copy bisect: the mel kernel's input copy, grown one structure at a time.

Every variant stages tiles of ``ROWS x HOP`` float32 rows (288 KB each) from
device memory into shared memory and reduces them, through the kernels of
``ops/staged_probe.py``:

  m0           column sums; the output is the last tile's (1, 512) sums
  m_out        a row probe per tile, written as a (128, 128) slab at
               columns i*128 of a (128, n_tiles*128) output: 128 runs of
               512 B per tile
  m_outg4/g8   the same, 4 / 8 consecutive tiles gathered before they are
               written, so that the kernel writes runs of 2 KB / 4 KB
  m_outc       the (n_tiles, 128, 128) layout: one contiguous 64 KB slab
  m_edge       m_out with the first and last tile read from an edge buffer
  m_kitchen    m_edge, plus the probe read 6 rows into the tile, a term
               summed from six table operands (184,864 floats of ones), and
               the sum of a row of 128 ones in shared memory; its ablations
               drop one structure each (notab, nox, nooff, nostart) and
               g1024 runs 1024 tiles
  scale_*      the row probe over a 256 MB input, 1023 tiles, no wrap:
               pre2d and flat512 read (131072, 512) rows, flat128 reads
               (524288, 128) rows, 576 to a tile

Tile ``i`` starts at row ``(i % wrap) * 128``. At the default wrap of 128
the variants re-read a 33.8 MB buffer, which fits in an H100's 50 MB L2, so
they measure L2 to shared memory; the scale variants, and
``dma_pipeline_micro`` at a larger WRAP, stream from device memory.
``scale_flat512`` and ``scale_pre2d`` take the same path: a PyTorch
``.view`` of a flat buffer as 512-wide rows moves no data (the name is kept
so that results line up with the TPU-era bisect). ``m_kitchen_nostart``
gives the same tile starts as ``m_kitchen``: with one track, the
track/within arithmetic it drops is the identity.

Each variant prints its time per tile, raw and less the measured dispatch
floor ("at floor" where the difference is under twice the floor's spread),
the effective staging rate and the working set. Times are CUDA-event
timings of ``--calls`` calls in flight, best of 3 groups; outputs are
preallocated once and reused. With ``--device cpu`` the plain versions run
and the times are host-clock times of the CPU, not of a card.

Usage: python -m librosa_tpu_torch.diagnostics.dma_bisect [variants] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import staged_probe

ROWS, HOP = 144, 512        # the mel kernel's per-tile copy: 144 rows of 512 floats
N_TILES = 4096
WRAP = 128
TT = 128
N_OUT = 128
SCALE_ROWS, SCALE_TILES = 131072, 1023   # 256 MB of 512-wide rows
#: the six table operands of the mel kernel at n_fft 2048: window (16, 128),
#: cs2 (18, 16), ctw and stw (9, 128), c1s1 (128, 256), basis (9, 128, 128)
KITCHEN_TABLE_FLOATS = 16 * 128 + 18 * 16 + 2 * 9 * 128 + 128 * 256 + 9 * 128 * 128
KITCHEN_OFFSET = 6          # rows into the tile where the kitchen's probe starts
KITCHEN_SCRATCH = 128       # ones in the scratch row
L2_BYTES = 50 * 10**6       # H100 L2
HBM_BYTES_S = 3.35e12       # H100 SXM datasheet
F32_ADD_S = 33.5e12         # H100 SXM: float32 adds outside the tensor cores (the
                            # datasheet's 67 TFLOP/s counts a fused multiply-add as two)
CALLS = 24

VARIANTS: Dict[str, dict] = {
    "m0": {"colsum": True},
    "m_out": {},
    "m_outg4": {"group": 4},
    "m_outg8": {"group": 8},
    "m_outc": {"contiguous": True},
    "m_edge": {"edge": True},
    "m_kitchen": {"kitchen": {}},
    "m_kitchen_notab": {"kitchen": {"tables": False}},
    "m_kitchen_nox": {"kitchen": {"xstack_scratch": False}},
    "m_kitchen_nooff": {"kitchen": {"offset_probe": False}},
    "m_kitchen_nostart": {"kitchen": {"real_start": False}},
    "m_kitchen_g1024": {"kitchen": {"grid": 1024}},
}
SCALE_MODES = ("pre2d", "flat512", "flat128")
ALL_NAMES = tuple(VARIANTS) + tuple(f"scale_{m}" for m in SCALE_MODES)


class Inputs:
    """The buffers the variants read, made once on ``device`` from ``seed``.

    ``rows`` is ``(wrap * TT + ROWS) * HOP`` normal floats and the scale
    variants' input ``SCALE_ROWS * HOP`` more, made on first use (or the
    given tensors); the edge buffer is zeros and the tables are ones.
    Outputs are preallocated per size and reused, so timed calls allocate
    nothing.
    """

    def __init__(self, device, *, wrap: int = WRAP, seed: int = 0,
                 rows: Optional[torch.Tensor] = None, scale_rows: Optional[torch.Tensor] = None):
        self.device = torch.device(device)
        self.wrap = wrap
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        if rows is None:
            rows = torch.randn((wrap * TT + ROWS) * HOP, generator=self._gen,
                               device=self.device)
        self.rows = rows
        self.edges = torch.zeros((2, ROWS, HOP), device=self.device)
        self.tables = torch.ones(KITCHEN_TABLE_FLOATS, device=self.device)
        self._scale = scale_rows
        self._outs: Dict[int, torch.Tensor] = {}

    def scale_rows(self) -> torch.Tensor:
        if self._scale is None:
            self._scale = torch.randn(SCALE_ROWS * HOP, generator=self._gen, device=self.device)
        return self._scale

    def out(self, shape: Tuple[int, ...]) -> torch.Tensor:
        n = int(np.prod(shape))
        if n not in self._outs:
            self._outs[n] = torch.empty(n, device=self.device)
        return self._outs[n].view(shape)


@dataclass
class Case:
    """One variant: its kernel, input and keyword arguments."""

    name: str
    kernel: str                      # "stage_colsum" or "stage_rowprobe"
    rows: torch.Tensor
    kwargs: dict
    group: int = 1
    out: Optional[torch.Tensor] = field(default=None, repr=False)

    @property
    def n_tiles(self) -> int:
        return self.kwargs["n_tiles"]

    def run(self) -> torch.Tensor:
        """The wrapper: the kernel on a CUDA tensor, the plain version on a CPU one."""
        if self.kernel == "stage_colsum":
            return staged_probe.colsum_probe(self.rows, out=self.out, **self.kwargs)
        return staged_probe.rowprobe(self.rows, group=self.group, out=self.out, **self.kwargs)

    def plain(self, absolute: bool = False) -> torch.Tensor:
        """The plain version; with ``absolute``, of ``|rows|`` (and ``|edges|``, ``|tables|``)."""
        rows, kw = self.rows, dict(self.kwargs)
        if absolute:
            rows = rows.abs()
            kw.update({k: kw[k].abs() for k in ("edges", "tables") if kw.get(k) is not None})
        if self.kernel == "stage_colsum":
            return staged_probe.colsum_probe_reference(rows, **kw)
        return staged_probe.rowprobe_reference(rows, **kw)

    def _geometry(self) -> Tuple[int, int, int, int, int]:
        kw = self.kwargs
        stride = kw.get("tile_stride") or kw["tt"]
        wrap = kw.get("wrap") or self.n_tiles
        pw = kw.get("probe_width") or kw["width"]
        return kw["rows_per_tile"], kw["width"], stride, wrap, pw

    def library(self) -> Optional[Callable[[], torch.Tensor]]:
        """One ``torch.sum`` over an ``as_strided`` view of every tile's span.

        It reads the bytes the kernel stages (stride 0 across wraps) and
        writes the sums of every row run, a yardstick of speed that the port
        never calls. None where the tiles are not one strided view (edge
        tiles are read from ``rows`` here, not from the edge buffer).
        """
        R, width, stride, wrap, pw = self._geometry()
        if self.n_tiles % wrap or self.kwargs.get("row_offset") \
                or self.kwargs.get("tiles_per_track") not in (None, self.n_tiles):
            return None
        if self.kernel == "stage_colsum":
            size, strides, dim = (self.n_tiles // wrap, wrap, R, width), (0, stride * width,
                                                                          width, 1), 2
        else:
            size, strides, dim = (self.n_tiles // wrap, wrap, R * width // pw, pw), (
                0, stride * width, pw, 1), 3
        rows = self.rows
        return lambda: rows.as_strided(size, strides).sum(dim=dim)

    @property
    def staged_bytes(self) -> int:
        """Bytes staged into shared memory per call: every tile's full span."""
        R, width, *_ = self._geometry()
        return 4 * self.n_tiles * R * width

    @property
    def read_bytes(self) -> int:
        """Unique bytes the call reads: the rows its tiles span, edge slots and tables."""
        kw = self.kwargs
        R, width, stride, wrap, _ = self._geometry()
        start, is_edge, eslot = staged_probe.tile_starts(
            self.n_tiles, tiles_per_track=kw.get("tiles_per_track"),
            track_rows=kw.get("track_rows", 0), row_offset=kw.get("row_offset", 0),
            tile_stride=stride, wrap=kw.get("wrap"), n_edge=kw.get("n_edge", 0),
            e_start=kw.get("e_start"))
        starts = np.unique(start[~is_edge])
        rows = int(np.minimum(np.diff(starts), R).sum()) + R if starts.size else 0
        total = rows + R * len(np.unique(eslot[is_edge]))
        tables = kw.get("tables")
        return 4 * total * width + (0 if tables is None else 4 * tables.numel())

    @property
    def written_bytes(self) -> int:
        return 4 * self.out.numel()

    @property
    def l2_resident(self) -> bool:
        return self.read_bytes < L2_BYTES

    @property
    def bound_terms(self) -> Dict[str, float]:
        """The least times, in ms, of the call's bytes and of its operations.

        Bytes: each unique input byte read once and each output byte written
        once, over the HBM rate, whether or not the reads would hit the L2.
        Operations: one float32 add per staged float, over the card's rate
        of float32 adds.
        """
        return {"bytes": 1e3 * (self.read_bytes + self.written_bytes) / HBM_BYTES_S,
                "operations": 1e3 * (self.staged_bytes // 4) / F32_ADD_S}

    @property
    def bound_by(self) -> str:
        """Which of :attr:`bound_terms` is the larger: ``"bytes"`` or ``"operations"``."""
        terms = self.bound_terms
        return max(terms, key=terms.get)

    @property
    def bound_ms(self) -> float:
        """The least time the card could take for the call: the larger of :attr:`bound_terms`."""
        return max(self.bound_terms.values())


def make_case(name: str, inputs: Inputs, *, n_tiles: int = N_TILES) -> Case:
    """The variant ``name`` (a key of VARIANTS or ``scale_<mode>``) over ``inputs``."""
    if name.startswith("scale_"):
        mode = name[len("scale_"):]
        if mode not in SCALE_MODES:
            raise ValueError(f"unknown scale mode {mode!r}; choose from {SCALE_MODES}")
        kw = dict(n_tiles=SCALE_TILES, wrap=None, tt=TT, n_out=N_OUT)
        if mode == "flat128":  # 4 rows of 128 per row of 512
            kw.update(rows_per_tile=4 * ROWS, width=128, tile_stride=4 * TT, probe_width=HOP)
        else:
            kw.update(rows_per_tile=ROWS, width=HOP)
        return Case(name, "stage_rowprobe", inputs.scale_rows(), kw,
                    out=inputs.out((N_OUT, SCALE_TILES * TT)))
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}; choose from {ALL_NAMES}")
    spec = VARIANTS[name]
    kw = dict(rows_per_tile=ROWS, width=HOP, tt=TT, n_tiles=n_tiles, wrap=inputs.wrap)
    if spec.get("colsum"):
        return Case(name, "stage_colsum", inputs.rows, kw, out=inputs.out((1, HOP)))
    kw["n_out"] = N_OUT
    if "kitchen" in spec:
        k = {"tables": True, "xstack_scratch": True, "offset_probe": True, "real_start": True,
             "grid": n_tiles} | spec["kitchen"]
        grid = k["grid"]
        kw.update(n_tiles=grid, edges=inputs.edges, n_edge=2, e_start=grid - 1,
                  probe_offset=KITCHEN_OFFSET if k["offset_probe"] else 0,
                  tables=inputs.tables if k["tables"] else None,
                  scratch=KITCHEN_SCRATCH if k["xstack_scratch"] else 0,
                  tiles_per_track=grid if k["real_start"] else None)
    elif spec.get("edge"):
        kw.update(edges=inputs.edges, n_edge=2, e_start=n_tiles - 1)
    n = kw["n_tiles"]
    if spec.get("contiguous"):
        kw["contiguous"] = True
        shape = (n, N_OUT, TT)
    else:
        shape = (N_OUT, n * TT)
    return Case(name, "stage_rowprobe", inputs.rows, kw, group=spec.get("group", 1),
                out=inputs.out(shape))


def k1_staging_case(y: torch.Tensor, *, n_fft: int = 2048, hop: int = 512,
                    frames_per_tile: int = 8, n_out: int = 128) -> Case:
    """The row probe at the mel kernel's own tile geometry, over a batch ``y``.

    ``y`` is ``(n_tracks, n)`` float32 with ``n`` a multiple of ``hop``,
    viewed as rows of ``hop`` samples. A tile is ``frames_per_tile`` centred
    frames: it stages the ``(frames_per_tile - 1) * hop + n_fft`` samples
    they span (11 rows at n_fft 2048, hop 512, 8 frames), tiles start
    ``frames_per_tile`` rows apart, ``n_fft // 2`` samples before the
    frames' hops. Tiles that reach into the centre padding (the first of a
    track and the last ones) read a zero edge buffer. The probe is one row
    sum per frame, written where the mel kernel writes frame ``t`` of
    ``(n_tracks, n_out, n_frames)``: runs of ``frames_per_tile`` floats.
    """
    n_tracks, n = y.shape
    if n % hop or n_fft % hop:
        raise ValueError(f"n={n} and n_fft={n_fft} must be multiples of hop={hop}")
    track_rows, n_frames = n // hop, 1 + n // hop
    rows_per_tile = frames_per_tile - 1 + n_fft // hop
    row_offset = -(n_fft // 2) // hop
    tiles = -(-n_frames // frames_per_tile)
    # the first tile whose span passes the end of the track
    e_start = (track_rows - rows_per_tile - row_offset) // frames_per_tile + 1
    n_edge = tiles - e_start + 1
    kw = dict(rows_per_tile=rows_per_tile, width=hop, tt=frames_per_tile,
              n_tiles=n_tracks * tiles, tiles_per_track=tiles, track_rows=track_rows,
              row_offset=row_offset, wrap=None, n_out=n_out, out_cols=n_frames,
              edges=torch.zeros((n_tracks * n_edge, rows_per_tile, hop), device=y.device),
              n_edge=n_edge, e_start=e_start)
    out = torch.empty((n_tracks, n_out, n_frames), device=y.device)
    return Case("k1_geometry", "stage_rowprobe", y.reshape(-1), kw, out=out)


def unaligned_case(inputs: Inputs, *, n_tracks: int = 3, tiles_per_track: int = 100,
                   n_out: int = 5) -> Case:
    """A strided row probe whose output rows are not 16-byte aligned, over ``inputs.rows``.

    ``out_cols = 30 * tiles_per_track - 7`` (not a multiple of 4) clips each
    track's last tile; a tile is 40 rows (three chunks of 16, 16 and 8 rows),
    its 30 probe runs start 3 rows in, and two tiles of a track are gathered
    per store (``group=2``). The kernel writes these rows by thread stores.
    """
    tt, rows_per_tile = 30, 40
    track_rows = tiles_per_track * rows_per_tile
    kw = dict(rows_per_tile=rows_per_tile, width=HOP, tt=tt, n_tiles=n_tracks * tiles_per_track,
              tiles_per_track=tiles_per_track, track_rows=track_rows, tile_stride=rows_per_tile,
              wrap=None, n_out=n_out, out_cols=tt * tiles_per_track - 7, probe_offset=3)
    out = inputs.out((n_tracks, n_out, tt * tiles_per_track - 7))
    return Case("unaligned_strided", "stage_rowprobe", inputs.rows, kw, group=2, out=out)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_calls(fn: Callable[[], object], device, *, calls: int = CALLS,
               groups: int = 3) -> Tuple[float, float]:
    """``(best, spread)`` in ms per call over ``groups`` runs of ``calls`` calls in flight.

    CUDA events on a card; the host clock on the CPU.
    """
    device = torch.device(device)
    fn()
    _sync(device)
    per_call = []
    for _ in range(groups):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            per_call.append(start.elapsed_time(end) / calls)
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            per_call.append(1e3 * (time.perf_counter() - t0) / calls)
    return min(per_call), max(per_call) - min(per_call)


def dispatch_floor(device, *, calls: int = CALLS) -> Tuple[float, float]:
    """``(best, spread)`` ms per call of a trivial op, timed as the variants are."""
    x = torch.zeros((8, 128), device=device)
    return time_calls(lambda: x.add_(1.0), device, calls=calls)


def device_label(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return f"{torch.cuda.get_device_name(device)} (CUDA events)"
    return "cpu (host clock; plain versions, not a device time)"


def measure(case: Case, floor: Tuple[float, float], *, calls: int = CALLS,
            out: Callable[[str], None] = print) -> dict:
    """Times ``case.run`` and prints its line; returns the numbers as a dict."""
    best, spread = time_calls(case.run, case.rows.device, calls=calls)
    net = best - floor[0]
    at_floor = net < 2 * floor[1] or net <= 0
    raw_us = 1e3 * best / case.n_tiles
    net_us = None if at_floor else 1e3 * net / case.n_tiles
    rate = None if at_floor else case.staged_bytes / (net * 1e-3) / 1e9
    head = "at floor" if at_floor else f"{net_us:8.3f} us/tile ({rate:7.1f} GB/s effective)"
    ws = case.read_bytes
    out(f"{case.name:18s}: {head}; raw {raw_us:8.3f} us/tile, {best:.4f} ms/call; "
        f"staged {case.staged_bytes / 1e6:.1f} MB, working set {ws / 1e6:.1f} MB"
        f"{', L2-resident' if case.l2_resident else ''}")
    return dict(name=case.name, kernel=case.kernel, ms=best, spread_ms=spread,
                us_per_tile_raw=raw_us, us_per_tile=net_us, at_floor=at_floor,
                gb_s=rate, n_tiles=case.n_tiles, staged_bytes=case.staged_bytes,
                read_bytes=ws, written_bytes=case.written_bytes,
                l2_resident=case.l2_resident, bound_ms=case.bound_ms, bound_by=case.bound_by)


def run(names: List[str], *, device="cuda", n_tiles: int = N_TILES, wrap: int = WRAP,
        seed: int = 0, calls: int = CALLS, inputs: Optional[Inputs] = None,
        out: Callable[[str], None] = print) -> List[dict]:
    """Runs and times the named variants on ``device``; returns one dict per variant."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the staged-copy diagnostics run on a card, and CUDA is not "
                           "available; pass --device cpu for the plain versions")
    inputs = inputs or Inputs(device, wrap=wrap, seed=seed)
    out(f"device: {device_label(device)}")
    floor = dispatch_floor(device, calls=calls)
    out(f"dispatch floor: {floor[0]:.4f} ms/call (spread {floor[1]:.4f} ms over 3 groups "
        f"of {calls})")
    return [measure(make_case(name, inputs, n_tiles=n_tiles), floor, calls=calls, out=out)
            for name in names]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m librosa_tpu_torch.diagnostics.dma_bisect",
        description="Staged-copy bisect of the mel kernel's input copy.")
    ap.add_argument("variants", nargs="*", metavar="variant",
                    help=f"any of {', '.join(ALL_NAMES)} (default: the non-scale variants)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n-tiles", type=int, default=N_TILES)
    ap.add_argument("--wrap", type=int, default=WRAP)
    ap.add_argument("--calls", type=int, default=CALLS, help="calls in flight per timing")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    bad = [v for v in args.variants if v not in ALL_NAMES]
    if bad:
        ap.error(f"unknown variants {bad}; choose from {', '.join(ALL_NAMES)}")
    run(args.variants or list(VARIANTS), device=args.device, n_tiles=args.n_tiles,
        wrap=args.wrap, seed=args.seed, calls=args.calls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
