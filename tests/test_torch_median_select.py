"""The median kernel's own selection code, compiled for the CPU and held to the plain version.

``librosa_tpu_torch/csrc/median_select.cuh`` is the code each thread of
``csrc/median_filter.cu`` runs: order keys, mirrored indices and the grouped
selection (a sorted core shared by adjacent outputs, then halving merges).
Here ``g++`` builds it into a small library whose harness stages each row as
the kernel stages a tile (keys of the mirrored indices) and runs it in the
kernel's runs of 32 outputs. Its output must equal
``ops/median.py:median_filter_reference`` bit for bit (NaN where that has
NaN) for every size 2-64, at axis lengths around the window, the group and
the run, and at the lengths of ``|STFT|``'s two axes on the main path.

The file skips only where ``g++`` is absent.
"""

import ctypes
import importlib.util
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from librosa_tpu_torch.ops import _build, median

HARNESS = r"""
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#define __host__
#define __device__
#define __forceinline__ inline
static inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
static inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
static inline float __fadd_rn(float a, float b) { return a + b; }

#include "median_select.cuh"

static constexpr int kRun = 32;  // outputs per thread, as in median_filter.cu

// the sliding median of `size` along each of `rows` contiguous rows of n floats
extern "C" int median_rows(const float* x, float* out, long long rows, long long n, int size) {
    if (size < 2 || size > median::kMaxSize) return 1;
    const int half = size / 2;
    std::vector<uint32_t> keys(n + size + kRun + median::kMaxSize);
    for (long long r = 0; r < rows; ++r) {
        bool nan = false;
        for (long long j = 0; j < n + size - 1; ++j) {
            keys[j] = median::to_key(x[r * n + median::mirror(j - half, n)]);
            nan |= keys[j] == median::kNaN;
        }
        median::with_width(size, [&](auto w) {
            for (long long r0 = 0; r0 < n; r0 += kRun)
                median::median_run<decltype(w)::value>(
                    keys.data() + r0, size, static_cast<int>(std::min<long long>(kRun, n - r0)),
                    out + r * n + r0, (size & 1) && nan);
        });
    }
    return 0;
}

extern "C" int group_size_of(int size) { return median::group_size(median::window_width(size)); }
"""

RUN = 32
ROOT = Path(__file__).resolve().parents[1]


# A model of the header's network structure in Python, for counting its operations;
# test_group_sizes_divide_the_run holds group_size against the compiled header.
def window_width(size: int) -> int:
    """The kernel's completed window for ``size``: ``size`` rounded up to a multiple of 4."""
    return 4 if size <= 4 else (size + 3) & ~3


def group_size(size: int) -> int:
    """Outputs that share one sorted core in the kernel (``median_select.cuh:group_size``)."""
    w = window_width(size)
    return 1 if w <= 4 else 4 if w <= 12 else 8 if w <= 28 else 16 if w <= 60 else 32


def _batcher(n: int):
    """Batcher's odd-even merge sort of ``n`` (a power of two) keys as (i, j) exchanges."""
    def merge(lo, hi, r):
        step = 2 * r
        if step < hi - lo:
            yield from merge(lo, hi, step)
            yield from merge(lo + r, hi, step)
            yield from ((i, i + r) for i in range(lo + r, hi - r, step))
        else:
            yield lo, lo + r

    def sort(lo, hi):
        if hi - lo >= 1:
            mid = lo + (hi - lo) // 2
            yield from sort(lo, mid)
            yield from sort(mid + 1, hi)
            yield from merge(lo, hi, 1)

    return list(sort(0, n - 1))


def selection_ops(size: int) -> float:
    """Minimum and maximum operations per output of the kernel's grouped selection for ``size``.

    The networks of ``csrc/median_select.cuh`` (the core's sort, the halving
    merges) built symbolically, with the constant pads folded (a minimum
    with the key above all keys is the other key) and what no median reads
    dropped, as a compiler does. Loads, key conversions and the run's
    bookkeeping are not counted.
    """
    high = "high"
    nodes = []  # (a, b) of each minimum or maximum

    def op(a, b, is_min):
        if a == high or b == high:
            return (b if a == high else a) if is_min else high
        nodes.append((a, b))
        return len(nodes) - 1

    def var():
        nodes.append(None)
        return len(nodes) - 1

    def sort(keys, n):
        r = keys + [high] * (n - len(keys))
        for i, j in _batcher(n):
            r[i], r[j] = op(r[i], r[j], True), op(r[i], r[j], False)
        return r

    def merge_band(band, add):
        g = len(band)
        r = list(band) + list(add) + [high] * (g - len(add))
        # the odd-even merge of two sorted halves: what Batcher's sort of 2g adds to two of g
        for i, j in _batcher(2 * g)[2 * len(_batcher(g)):]:
            r[i], r[j] = op(r[i], r[j], True), op(r[i], r[j], False)
        return r[g // 2:g]

    w, k = window_width(size), group_size(size)
    c = w - k + 1
    p = 1
    while p < c:
        p *= 2
    core = sort([var() for _ in range(c)], p)
    medians = []

    def descend(band):
        if len(band) == 1:
            medians.append(band[0])
            return
        h = len(band) // 2
        for _ in range(2):
            descend(merge_band(band, sort([var() for _ in range(h)], h)))

    descend(core[w // 2 - k + 1:w // 2 + 1])
    live, stack = set(), [m for m in medians if m != high]
    while stack:
        n = stack.pop()
        if n in live or nodes[n] is None:
            continue
        live.add(n)
        stack.extend(x for x in nodes[n] if x != high)
    return len(live) / k


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    tmp = tmp_path_factory.mktemp("median_select")
    src = tmp / "harness.cpp"
    src.write_text(HARNESS)
    so = tmp / "libmedian_select.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    f"-I{_build.CSRC}", "-o", str(so), str(src)], check=True,
                   capture_output=True, text=True)
    handle = ctypes.CDLL(str(so))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    handle.median_rows.argtypes = [p, p, i64, i64, i32]
    handle.median_rows.restype = i32
    handle.group_size_of.argtypes = [i32]
    handle.group_size_of.restype = i32
    return handle


def _hard(rows, n, seed):
    """Noise with ties, a NaN run longer than half of any window, +-inf, +-0."""
    x = np.random.RandomState(seed).randn(rows, n).astype(np.float32)
    flat = x.reshape(-1)
    flat[::7] = np.round(flat[::7])
    flat[::11] = 0.5
    picks = np.random.RandomState(seed + 1).randint(0, flat.size, size=(6, max(1, flat.size // 50)))
    flat[picks[0]] = np.inf
    flat[picks[1]] = -np.inf
    flat[picks[2]] = -0.0
    flat[picks[3]] = 0.0
    flat[picks[4]] = np.nan
    if rows > 1:
        x[1, n // 3:n // 3 + 40] = np.nan  # longer than half of every window
    return x


def _run(lib, x, size):
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.full_like(x, 123.0)
    assert lib.median_rows(x.ctypes.data, out.ctypes.data, x.shape[0], x.shape[1], size) == 0
    return out


def _equal(got, want):
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    return (np.array_equal(nan_g, nan_w)
            and np.array_equal(np.where(nan_g, 0, got).view(np.int32),
                               np.where(nan_w, 0, want).view(np.int32)))


def _lengths(size, k):
    return sorted({n for n in (1, 2, size - 1, size, size + 1, k, k - 1, k + 1, RUN - 1, RUN,
                               RUN + 1, 2 * RUN + 3, 200) if n >= 1})


@pytest.mark.parametrize("size", range(2, 65))
def test_selection_equals_the_plain_version(lib, size):
    k = lib.group_size_of(size)
    for n in _lengths(size, k):
        x = _hard(3, n, seed=size * 1000 + n)
        want = median.median_filter_reference(torch.from_numpy(x), size=size, axis=-1).numpy()
        got = _run(lib, x, size)
        assert _equal(got, want), (size, n, np.argwhere(got.view(np.int32) != want.view(np.int32))[:5])


@pytest.mark.parametrize("size", [2, 3, 4, 5, 8, 9, 16, 17, 31, 32, 33, 48, 63, 64])
@pytest.mark.parametrize("n", [1025, 8193])
def test_selection_at_the_main_path_lengths(lib, size, n):
    rows = 2 if n == 1025 else 1
    x = _hard(rows, n, seed=size + n)
    want = median.median_filter_reference(torch.from_numpy(x), size=size, axis=-1).numpy()
    assert _equal(_run(lib, x, size), want)


def test_selection_on_magnitudes_with_long_ties(lib):
    # |STFT|-like values: nonnegative, long runs of exact zeros and repeats
    x = np.abs(np.random.RandomState(5).randn(4, 300)).astype(np.float32)
    x[0, 50:150] = 0.0
    x[1, :] = 1.0
    x[2, ::2] = 2.0
    x[3, 100:103] = np.nan
    for size in (31, 32, 6, 64):
        want = median.median_filter_reference(torch.from_numpy(x), size=size, axis=-1).numpy()
        assert _equal(_run(lib, x, size), want), size


def test_group_sizes_divide_the_run(lib):
    for size in range(2, 65):
        k = lib.group_size_of(size)
        assert k == group_size(size)
        assert k in (1, 4, 8, 16, 32) and RUN % k == 0 and k <= size


def test_smoke_script_group_table_matches_the_header(lib):
    # chip_smoke.py picks its axis lengths around the group from a table of its own
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.MEDIAN_GROUP == {s: lib.group_size_of(s) for s in smoke.MEDIAN_GROUP}


@pytest.mark.parametrize("size", range(2, 65, 3))
def test_selection_halves_the_operations_per_output(size):
    # the earlier design: one delete-and-insert pass (compare, select, minimum, maximum) over a
    # sorted window of the power of two >= size + size % 2 keys per output, and the `size`
    # insertions (minimum, maximum) that start each run of 32 outputs
    width = 4
    while width < size + size % 2:
        width *= 2
    earlier = 4 * width + 2 * width * size / RUN
    assert selection_ops(size) <= earlier / 2
