"""Kernel A's step schedule on the CPU: which frames a step takes, and that the result is exact.

``csrc/beat_dp.cu`` scores, in one step from frame ``i``, the frames
``i .. i + k - 1`` that do not depend on each other: frame ``i + m`` joins
while none of its candidates ``d`` (``round(fpb / 2) <= d <= 2 fpb``,
``d <= min(1024, i + m)``) is ``m`` or less, up to 16 frames
(``csrc/beat_steps.cuh``). Here

- ``ops/beat_dp.py:step_schedule`` is checked on fpb 1, 2, 3, 43 +- 5, per
  frame fpb swinging 2-60, and 700: every step is a run of frames that do
  not depend on each other, and no step could take one frame more;
- ``csrc/beat_steps.cuh`` is compiled with ``g++`` and its schedule (the
  kernel's window arithmetic, flags and step length) equals
  ``step_schedule``;
- a stepwise emulation of the kernel in torch (a test helper: nothing on the
  path calls it), which scores each step's frames at once from the frames
  before the step alone (the later ones are NaN), is held bit for bit
  against ``ops/beat_dp.py:beat_dp_reference``, and against the JAX
  package's ``_beat_dp_scan`` as ``tests/test_torch_beat.py`` holds the
  plain version (backlinks equal, cumulative scores to 1e-6 and 1e-4 for
  the ulps between the two packages' logs).

The compiled cases skip only where ``g++`` is absent.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from librosa_tpu import beat as jax_beat

from librosa_tpu_torch.ops import _build, beat_dp

CUM_RTOL = 1e-6  # tests/test_torch_beat.py's tolerance for the JAX scan's cumulative score
# jnp.log and torch.log differ by one float32 ulp (4.8e-7) at 16 of the 1024 log d; the
# penalty 100 (log d - log fpb)^2 turns that into up to 3.6e-5 at fpb 700, and a chain of
# beats adds it up: 1300 frames hold at most two such hops
CUM_ATOL = 1e-4

HARNESS = r"""
#include <cmath>

#define __host__
#define __device__
#define __forceinline__ inline
static inline float __fmul_rn(float a, float b) { return a * b; }

#include "beat_steps.cuh"

// The kernel's schedule of one row: per step the flags of the next kStepFrames frames
// (from window() and independent()), then step_length. fpb is (T,) or one value.
extern "C" int schedule(const float* fpb, int per_frame, int T, int* steps) {
    int n = 0;
    for (int i = 0; i < T;) {
        unsigned flags = 0;
        for (int m = 0; m < beat_steps::kStepFrames; ++m) {
            const int j = i + m;
            const bool ok = j < T &&
                beat_steps::independent(beat_steps::window(fpb[per_frame ? j : 0], j), m);
            flags |= (ok ? 1u : 0u) << m;
        }
        const int k = beat_steps::step_length(flags);
        steps[n++] = k;
        i += k;
    }
    return n;
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    tmp = tmp_path_factory.mktemp("beat_steps")
    src = tmp / "harness.cpp"
    src.write_text(HARNESS)
    so = tmp / "libbeat_steps.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{_build.CSRC}", "-o",
                    str(so), str(src)], check=True, capture_output=True, text=True)
    handle = ctypes.CDLL(str(so))
    handle.schedule.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    handle.schedule.restype = ctypes.c_int
    return handle


T_ROW = 3000


def _fpb(kind: str) -> np.ndarray:
    """One row's frames per beat: ``(1,)`` for a fixed tempo, ``(T_ROW,)`` per frame."""
    rng = np.random.RandomState(7)
    fixed = {"fpb_1": 1.0, "fpb_2": 2.0, "fpb_3": 3.0, "fpb_43": 43.0 + rng.randint(-5, 6),
             "fpb_700": 700.0}
    if kind in fixed:
        return np.array([fixed[kind]], dtype=np.float32)
    if kind == "swinging_2_60":
        return rng.randint(2, 61, size=T_ROW).astype(np.float32)
    return (43 + rng.randint(-5, 6, size=T_ROW)).astype(np.float32)  # "per_frame_43"


KINDS = ["fpb_1", "fpb_2", "fpb_3", "fpb_43", "per_frame_43", "swinging_2_60", "fpb_700"]


def _candidates(fpb: np.ndarray, T: int):
    """``(lo, hi)`` of every frame, in float32 as the kernel; ``lo > hi`` where none."""
    f = np.broadcast_to(fpb, (T,)).astype(np.float32)
    j = np.arange(T)
    lo = np.maximum(np.rint(f * np.float32(0.5)), 1).astype(np.int64)
    hi = np.minimum(np.floor(np.float32(2.0) * f), np.minimum(j, 1024)).astype(np.int64)
    return lo, hi


@pytest.mark.parametrize("kind", KINDS)
def test_steps_take_frames_that_do_not_depend_on_each_other(kind):
    fpb = _fpb(kind)
    steps = beat_dp.step_schedule(fpb, T_ROW)
    assert steps.sum() == T_ROW and steps.min() >= 1 and steps.max() <= beat_dp.STEP_FRAMES
    lo, hi = _candidates(fpb, T_ROW)
    start = 0
    for k in steps:
        for m in range(k):  # no candidate of frame start + m lies inside the step
            j = start + m
            assert lo[j] > hi[j] or j - lo[j] < start
        nxt = start + k  # and the step could not take its next frame too
        if nxt < T_ROW and k < beat_dp.STEP_FRAMES:
            assert lo[nxt] <= hi[nxt] and nxt - lo[nxt] >= start
        start = nxt


@pytest.mark.parametrize("kind,frames", [("fpb_1", 1), ("fpb_2", 1), ("fpb_3", 2),
                                         ("fpb_700", 16)])
def test_fixed_tempo_steps(kind, frames):
    # lo = max(round(fpb / 2), 1) frames a step: fpb 1 and 2 give 1, fpb 3 gives round(1.5) =
    # 2 (half to even), fpb 700 the cap; the first steps and the last may differ
    steps = beat_dp.step_schedule(_fpb(kind), T_ROW)
    assert np.all(steps[1:-1] == frames), np.unique(steps[1:-1])


def test_config5_tempi_take_9_to_16_frames_a_step():
    # 78-144 BPM at 43.07 frames a second: fpb 17.9-33.1 (rounded), lo 9-17
    for bpm in (78.0, 100.0, 144.0):
        fpb = np.array([np.round(22050 / 512 * 60.0 / bpm)], dtype=np.float32)
        steps = beat_dp.step_schedule(fpb, 8193)
        lo = max(int(np.rint(fpb[0] / 2)), 1)
        assert np.all(steps[1:-1] == min(lo, beat_dp.STEP_FRAMES))
        assert len(steps) <= 911


@pytest.mark.parametrize("kind", KINDS)
def test_compiled_schedule_equals_step_schedule(lib, kind):
    fpb = np.ascontiguousarray(_fpb(kind))
    out = np.zeros(T_ROW, dtype=np.int32)
    n = lib.schedule(fpb.ctypes.data, int(fpb.shape[0] == T_ROW), T_ROW, out.ctypes.data)
    np.testing.assert_array_equal(out[:n], beat_dp.step_schedule(fpb, T_ROW))


def test_schedule_with_nan_fpb_takes_full_steps(lib):
    fpb = np.full(40, np.nan, dtype=np.float32)  # no candidate anywhere
    assert beat_dp.step_schedule(fpb, 40).tolist() == [16, 16, 8]
    out = np.zeros(40, dtype=np.int32)
    n = lib.schedule(fpb.ctypes.data, 1, 40, out.ctypes.data)
    assert out[:n].tolist() == [16, 16, 8]


def stepwise_dp(localscore: torch.Tensor, frames_per_beat: torch.Tensor,
                tightness: float):
    """The kernel's schedule in torch: each step's frames scored at once from earlier frames.

    Frames at or after a step's start are NaN while the step is scored, so a
    frame that read one would give NaN and differ. The arithmetic is the
    plain version's (the same torch ops on the same floats).
    """
    R, T = localscore.shape
    log_d, log_fpb, thresh = beat_dp._tables(localscore, frames_per_beat)
    d = torch.arange(1, beat_dp.MAX_WINDOW + 1, dtype=localscore.dtype)
    fpb = frames_per_beat.expand(R, T)
    lf = log_fpb.expand(R, T)
    backlink = torch.empty((R, T), dtype=torch.int32)
    cumscore = torch.full((R, T), float("nan"), dtype=localscore.dtype)
    for r in range(R):
        gate = int(np.argmax(~(localscore[r] < thresh[r]).numpy())) \
            if bool((~(localscore[r] < thresh[r])).any()) else T
        i = 0
        for k in beat_dp.step_schedule(frames_per_beat[r].numpy(), T):
            j = torch.arange(i, i + k)
            done = cumscore[r, :i]  # only frames before the step
            src = j[:, None] - d.long()[None, :]  # frame j - d for every candidate d
            prev = torch.where(src >= 0, torch.cat([done, torch.full((T,), float("nan"))])[
                src.clamp(min=0)], float("-inf"))
            valid = ((d >= torch.round(fpb[r, j] * 0.5)[:, None])
                     & (d <= (2.0 * fpb[r, j])[:, None]) & (d <= j[:, None]))
            diff = log_d - lf[r, j][:, None]
            scores = torch.where(valid, prev - tightness * (diff * diff),
                                 torch.tensor(float("-inf")))
            best, kk = scores.max(dim=-1)  # the smallest d on ties
            has = torch.isfinite(best)
            si = localscore[r, j]
            cumscore[r, j] = torch.where(has, si + best, si)
            backlink[r, j] = torch.where(has & (j >= gate), j - 1 - kk, -1).int()
            i += k
    return backlink, cumscore


@pytest.mark.parametrize("kind", KINDS)
def test_stepwise_emulation_is_the_plain_version_bit_for_bit(kind):
    rng = np.random.RandomState(11)
    R, T = 3, 1300
    ls = rng.randn(R, T).astype(np.float32)
    ls[1] = -np.abs(ls[1])  # all negative: no frame reaches the gate
    ls[2, :40] = -5.0  # the gate opens late
    if kind.startswith("per_frame") or kind.startswith("swinging"):
        fpb = np.stack([_fpb(kind)[:T] for _ in range(R)])
    else:
        fpb = np.repeat(_fpb(kind)[None, :], R, axis=0)
    ls_t, fpb_t = torch.from_numpy(ls), torch.from_numpy(np.ascontiguousarray(fpb))
    got_b, got_c = stepwise_dp(ls_t, fpb_t, 100.0)
    want_b, want_c = beat_dp.beat_dp_reference(ls_t, fpb_t, 100.0)
    assert torch.equal(got_b, want_b)
    assert torch.equal(got_c, want_c)
    tv = fpb.shape[1] == T
    bl_j, cs_j = jax.vmap(lambda a, b: jax_beat._beat_dp_scan(a, b, 100.0, tv=tv))(
        jnp.asarray(ls), jnp.asarray(fpb))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(bl_j))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(cs_j), rtol=CUM_RTOL, atol=CUM_ATOL)
