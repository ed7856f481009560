"""The port's wait-spaced peak selection (``ops/peaks.py``) against the JAX package's scans.

``greedy_mask``, ``dp_values`` and ``dp_mask`` get the same float32
envelopes, made from a seed with numpy, as ``librosa_tpu.ops.peaks``; on CPU
tensors the port runs the plain loops that the ``peak_scan`` kernels equal
bit for bit on the card (``chip_smoke.py`` phase 4p). The masks must be
equal, not close. Numpy emulations of ``csrc/peak_scan.cu``'s staging, walk
and ring, operation for operation, are held against the plain loops, and a
spy shows that on a CUDA tensor the DP's walk goes to the greedy kernel.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from librosa_tpu.ops import peaks as jax_peaks
from librosa_tpu.util import peak_pick as jax_peak_pick

import librosa_tpu_torch as L
from librosa_tpu_torch.ops import peaks

ROWS, T = 3, 500
WINDOWS = [
    dict(pre_max=1, post_max=1, pre_avg=1, post_avg=1),
    dict(pre_max=3, post_max=1, pre_avg=10, post_avg=11),
    dict(pre_max=7, post_max=5, pre_avg=2, post_avg=30),
]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


def _envelopes(seed: int, rows: int = ROWS, length: int = T) -> np.ndarray:
    rng = np.random.RandomState(seed)
    x = rng.rand(rows, length) ** 3          # sparse, peaky rows as an onset envelope
    x[:, ::37] += 0.5 * rng.rand(rows, len(range(0, length, 37)))
    return x.astype(np.float32)


@pytest.mark.parametrize("win", range(len(WINDOWS)))
@pytest.mark.parametrize("wait,delta", [(0, 0.0), (4, 0.02), (30, 0.1), (T + 5, 0.05)])
def test_greedy_and_dp_match_jax(win, wait, delta):
    x = _envelopes(17 * win + wait)
    kw = dict(WINDOWS[win], delta=delta, wait=wait)
    before = peaks.launches
    got = peaks.greedy_mask(torch.from_numpy(x), **kw)
    assert got.dtype == torch.bool and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_peaks.greedy_mask(x, **kw)))
    for count in (True, False):
        taken = peaks.dp_values(torch.from_numpy(x), count=count, **kw)
        want = np.asarray(jax_peaks.dp_values(x, count=count, **kw))
        np.testing.assert_array_equal(taken.numpy(), want)
        np.testing.assert_array_equal(peaks.dp_mask(taken, wait), jax_peaks.dp_mask(want, wait))
    assert peaks.launches == before  # CPU tensors run the plain loops


def test_leading_dims_fold_into_rows():
    x = _envelopes(5, rows=6).reshape(2, 3, T)
    kw = dict(WINDOWS[1], delta=0.05, wait=6)
    got = peaks.greedy_mask(torch.from_numpy(x), **kw)
    assert tuple(got.shape) == (2, 3, T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_peaks.greedy_mask(x, **kw)))
    taken = peaks.dp_values(torch.from_numpy(x), count=False, **kw)
    np.testing.assert_array_equal(peaks.dp_mask(taken, 6),
                                  jax_peaks.dp_mask(jax_peaks.dp_values(x, count=False, **kw), 6))


@pytest.mark.parametrize("method", ["greedy", "dp_count", "dp_value"])
def test_peak_pick_batch_matches_jax(method):
    x = _envelopes(23, rows=4, length=700)
    kw = dict(pre_max=3, post_max=1, pre_avg=10, post_avg=11, delta=0.07, wait=3)
    got = L.util.peak_pick(x, sparse=False, method=method, **kw)
    want = jax_peak_pick(x, sparse=False, method=method, **kw)
    assert isinstance(got, np.ndarray) and got.dtype == bool
    np.testing.assert_array_equal(got, want)
    # the axis moves the frames last and back, as in the JAX package
    np.testing.assert_array_equal(L.util.peak_pick(x.T, sparse=False, method=method, axis=0,
                                                   **kw), want.T)


def test_dp_value_ties_keep_the_later_peak_as_jax():
    # two candidates closer than wait with equal heights, and a pair summing to a single peak:
    # the DP takes a frame only when strictly better, so of equal sums the later set stays
    x = np.zeros((2, 60), np.float32)
    x[0, [10, 12]] = 0.5
    x[1, [20, 40]] = 0.25
    x[1, 30] = 0.5
    kw = dict(pre_max=1, post_max=1, pre_avg=1, post_avg=1, delta=0.0)
    for wait in (3, 12):
        taken = peaks.dp_values(torch.from_numpy(x), count=False, wait=wait, **kw)
        want = np.asarray(jax_peaks.dp_values(x, count=False, wait=wait, **kw))
        np.testing.assert_array_equal(taken.numpy(), want)
        got = peaks.dp_mask(taken, wait)
        np.testing.assert_array_equal(got, jax_peaks.dp_mask(want, wait))
    assert np.flatnonzero(peaks.dp_mask(peaks.dp_values(torch.from_numpy(x), count=False,
                                                        wait=3, **kw), 3)[0]).tolist() == [12]


def test_plain_loops_are_the_wrappers_on_the_cpu():
    x = torch.from_numpy(_envelopes(3))
    kw = dict(WINDOWS[1], delta=0.05)
    cand = peaks.candidate_mask(x, **kw)
    assert torch.equal(peaks.greedy_scan(cand, 5), torch.from_numpy(
        peaks.greedy_select(cand.numpy(), 5)))
    taken = peaks.dp_scan(cand, x, 5)
    np.testing.assert_array_equal(taken.numpy(), peaks.dp_flags(cand.numpy(), x.numpy(), 5))
    np.testing.assert_array_equal(peaks.dp_mask(taken, 5),
                                  peaks.dp_select(cand.numpy(), x.numpy(), 5))


def test_batched_peak_pick_tries_the_card_by_default(monkeypatch):
    """Without set_device('cpu') a batch of numpy envelopes goes to cuda and fails here; one
    envelope stays on the host's float64 loops, as in the JAX package."""
    from librosa_tpu_torch.ops import _build

    assert _build.SOURCES["peak_scan"] == "peak_scan.cu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    L.set_device("cuda")
    kw = dict(pre_max=3, post_max=1, pre_avg=10, post_avg=11, delta=0.07, wait=3)
    x = _envelopes(29)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        L.util.peak_pick(x, sparse=False, **kw)
    np.testing.assert_array_equal(L.util.peak_pick(x[0], **kw), jax_peak_pick(x[0], **kw))


# --- the kernels' index arithmetic (csrc/peak_scan.cu), emulated on the host -----------------

M32 = 0xFFFFFFFF


def test_kernel_geometry_matches_the_source():
    src = (Path(peaks.__file__).parent.parent / "csrc" / "peak_scan.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kGreedyChunk"]) == peaks.GREEDY_CHUNK
    assert int(consts["kDpChunk"]) == peaks.DP_CHUNK
    assert int(consts["kDpGroup"]) == peaks.DP_GROUP
    assert int(consts["kRingMax"]) == peaks.RING_MAX
    assert int(consts["kNearWait"]) == peaks.NEAR_WAIT
    assert 32 * int(consts["kProbeWords"]) == peaks.WALK_PROBE_FRAMES
    assert peaks.DP_CHUNK % 32 == 0 and 32 % peaks.DP_GROUP == 0


def _ballot_words(flags: np.ndarray) -> list:
    """Each 32 frames of ``flags`` as one word, bit b of word w for frame 32 w + b, as
    ``__ballot_sync`` over a warp's 32 lanes gives it (frames past the end read 0)."""
    nw = (len(flags) + 31) // 32
    lanes = np.zeros(nw * 32, dtype=np.uint64)
    lanes[:len(flags)] = flags
    return [int(w) for w in (lanes.reshape(nw, 32) << np.arange(32, dtype=np.uint64)).sum(1)]


def _nonzero_bytes(x: int) -> int:
    """``nonzero_bytes`` of the kernel: bit i set where byte i of the 32-bit ``x`` is not 0."""
    top = ((((x & 0x7F7F7F7F) + 0x7F7F7F7F) & M32) | x) & 0x80808080
    return ((top * 0x00204081) & M32) >> 28


def _staged_words(memory: np.ndarray, start: int, length: int) -> list:
    """``stage_words`` of the kernel on the row ``memory[start:start + length]``: aligned
    16-byte blocks folded into 16 bits, a word from three lanes' bits shifted by the row's
    offset ``start % 16``; blocks past the row are not read."""
    off, aligned = start % 16, start - start % 16
    end = off + length
    nw = (length + 31) // 32

    def block_bits(at):
        if at >= end:
            return 0
        q = memory[aligned + at:aligned + at + 16].view("<u4")
        bits = 0
        for i, x in enumerate(q):
            bits |= _nonzero_bytes(int(x)) << (4 * i)
        lo, hi = min(max(off - at, 0), 16), min(end - at, 16)
        return bits & ((1 << hi) - 1) & ~((1 << lo) - 1)

    words = [0] * nw
    for g in range(-(-nw // 16)):
        mine = [block_bits(512 * g + 16 * lane) for lane in range(32)]
        tail = block_bits(512 * g + 512)
        for lane in range(16):
            up = tail if lane == 15 else mine[2 * lane + 2]
            span = up << 32 | mine[2 * lane + 1] << 16 | mine[2 * lane]
            if 16 * g + lane < nw:
                words[16 * g + lane] = (span >> off) & M32
    return words


def test_nonzero_bytes_folds_each_byte():
    rng = np.random.RandomState(11)
    for _ in range(2000):
        b = rng.randint(0, 256, 4)
        b[rng.rand(4) < 0.5] = 0
        x = int(b[0]) | int(b[1]) << 8 | int(b[2]) << 16 | int(b[3]) << 24
        assert _nonzero_bytes(x) == sum(1 << i for i in range(4) if b[i])
    for v in range(256):
        assert _nonzero_bytes(v << 16) == (4 if v else 0)


@pytest.mark.parametrize("off", range(16))
def test_staged_words_at_every_offset(off):
    rng = np.random.RandomState(off)
    for length in (1, 15, 16, 17, 31, 32, 33, 496, 497, 512, 513, 2048):
        memory = rng.randint(0, 3, 2 * 2048 + 64).astype(np.uint8)   # flags, and bytes around
        start = 32 + off
        row = memory[start:start + length] != 0
        assert _staged_words(memory, start, length) == _ballot_words(row)


def _walk_words(cand, taken, nw, length, rel, wait, steps):
    """``walk_words`` of the kernel, operation for operation: 32-bit words, the 64-bit product
    of a take and ``span``, the frame index ``r`` held to the kernel's 32-bit int."""
    if rel >= length:
        return rel
    jump = min(wait + 1, length + 32)
    span = (1 << min(jump, 32)) - 1
    w = rel >> 5
    word = cand[w] & (M32 << (rel & 31)) & M32
    if wait < peaks.NEAR_WAIT:                               # every word, blocks carried
        while True:
            ahead = cand[w + 1] if w + 1 < len(cand) else 0   # cand[nw]: read, never used
            acc = blocked = 0
            steps[0] += 1
            while word:                                      # two takes a turn
                a = word & ((0 - word) & M32)
                ta = a * span                                # 64-bit
                word &= ~ta & M32
                b = word & ((0 - word) & M32)
                tb = b * span
                word &= ~tb & M32
                acc |= a | b
                blocked = ((tb if b else ta) >> 32) & M32
                steps[0] += 1 + (b != 0)
            taken[w] = acc
            w += 1
            if w >= nw:
                return length + bin(blocked).count("1")
            word = ahead & ~blocked & M32
    after = length
    while True:                                              # one take a word, then a jump
        steps[0] += 1
        if word:
            last = (w << 5) + (word & -word).bit_length() - 1  # __ffs(word) - 1
            taken[w] = word & ((0 - word) & M32)
            steps[0] += 1
            after = max(length, last + wait + 1)             # 64-bit
            r = last + jump
            assert r < 2**31
            w = r >> 5
            if w >= nw:
                return after
            word = cand[w] & (M32 << (r & 31)) & M32
        else:
            w += 1
            if w >= nw:
                return after
            word = cand[w]


def _unpack(words, length):
    bits = np.array(words, dtype=np.uint64)[:, None] >> np.arange(32, dtype=np.uint64)
    return (bits & 1).astype(bool).reshape(-1)[:length]


def emulate_greedy(cand: np.ndarray, wait: int, chunk: int = peaks.GREEDY_CHUNK):
    """``greedy_walk_kernel``: each row in stages of ``chunk`` frames, ballot words, the walk."""
    rows, T = cand.shape
    out = np.zeros(cand.shape, dtype=bool)
    steps = [0]
    for r in range(rows):
        rel = 0
        for base in range(0, T, chunk):
            length = min(chunk, T - base)
            words = _ballot_words(cand[r, base:base + length])
            taken = [0] * len(words)
            rel = _walk_words(words, taken, len(words), length, rel, wait, steps) - length
            out[r, base:base + length] = _unpack(taken, length)
    return out, steps[0]


def emulate_dp(cand: np.ndarray, gain: np.ndarray, wait: int, chunk: int = peaks.DP_CHUNK,
               ring: int = None):
    """``dp_ring_kernel``: each row in stages of ``chunk`` frames from the top, groups of
    ``DP_GROUP`` frames, the values in registers (waits 0-6) or in a ring of ``ring`` floats at
    slot ``n & (ring - 1)``; every ring read checks that its slot still holds the frame it
    wants."""
    T = cand.shape[1]
    R = peaks.ring_size(T, wait) if ring is None else ring
    out = np.zeros(cand.shape, dtype=bool)
    with np.errstate(invalid="ignore"):                      # +inf + -inf: NaN, as on the card
        for r in range(cand.shape[0]):
            out[r] = _emulate_dp_row(cand[r], gain[r], wait, chunk, R)
    return out


def _emulate_dp_row(cand, gain, wait, chunk, R):
    T, G = len(cand), peaks.DP_GROUP
    W = min(wait, G - 1)
    in_ring, in_ahead = wait >= G - 1, wait >= 2 * G - 1
    no_cand = np.float32(-np.inf)
    out = np.zeros(T, dtype=bool)
    slots, owner = np.zeros(R, np.float32), np.full(R, -1, np.int64)
    nxt = np.float32(0)
    v = [np.float32(0)] * (2 * G)

    def load_reaches(g):                                     # frames g + k + wait + 1
        live = max(min(T - (g + wait + 1), G), 0)
        slot0 = (g + wait + 1) & M32
        reach = [np.float32(0)] * G
        for k in range(live):
            s = (slot0 + k) & (R - 1)
            assert owner[s] == g + k + wait + 1, "the ring lost a value"
            reach[k] = slots[s]
        return reach

    for base in range(-(-T // chunk) * chunk - chunk, -1, -chunk):
        length = min(chunk, T - base)
        cw = _ballot_words(cand[base:base + length])
        # stage_gains: the candidacy folded in, -inf where a frame (or padding) is none
        gm = np.full(-(-length // G) * G, no_cand, np.float32)
        gm[:length] = np.where(cand[base:base + length], gain[base:base + length], no_cand)
        tw = [0] * len(cw)
        acc = 0
        top = (length - 1) // G * G
        ahead = load_reaches(base + top) if in_ahead else None
        for n0 in range(top, -1, -G):
            g0 = base + n0
            if in_ahead:                                     # read a group ahead, from wait 15
                reach = ahead
                if n0 > 0:
                    ahead = load_reaches(g0 - G)
            bits = 0
            if (cw[n0 >> 5] >> (n0 & 31)) & 0xFF == 0:
                v[:G] = [nxt] * G
            else:
                if in_ring and not in_ahead:
                    reach = load_reaches(g0)
                for k in range(G - 1, -1, -1):
                    rk = reach[k] if in_ring else v[k + W + 1]
                    cv = np.float32(rk + gm[n0 + k])
                    bits |= int(cv > nxt) << k
                    nxt = np.fmax(nxt, cv)
                    v[k] = nxt
            if in_ring:
                s = g0 & (R - 1)
                assert s % G == 0 and s + G <= R
                slots[s:s + G] = v[:G]
                owner[s:s + G] = np.arange(g0, g0 + G)
            else:
                v[G:] = v[:G]
            acc |= bits << (n0 & 31)
            if n0 & 31 == 0:
                tw[n0 >> 5] = acc
                acc = 0
        out[base:base + length] = _unpack(tw, length)
    return out


def _flag_cases(T: int, seed: int):
    rng = np.random.RandomState(seed)
    gain = (np.floor(rng.rand(2, T) * 4) / 4).astype(np.float32)    # ties by design
    return [("none", np.zeros((2, T), bool), gain), ("all", np.ones((2, T), bool), gain),
            ("random", rng.rand(2, T) < 0.35, gain)]


# R - 2, R - 1 at R = 16 and 64; 31 and 32 on both sides of NEAR_WAIT
EDGE_WAITS = [0, 1, 6, 7, 14, 15, 31, 32, 33, 62, 63]


@pytest.mark.parametrize("T", [1, 31, 32, 33, 300, 8193])
def test_kernel_emulation_equals_the_plain_loops(T):
    waits = EDGE_WAITS + [T + 3, 2**31 - 1]
    if T == 8193:
        waits = [0, 1, 6, 7, 15, 31, 32, 63, T + 3, 2**31 - 1]
    for label, cand, gain in _flag_cases(T, T):
        for wait in waits:
            got, _ = emulate_greedy(cand, wait)
            np.testing.assert_array_equal(got, peaks.greedy_select(cand, wait),
                                          err_msg=f"greedy {label} wait {wait}")
            np.testing.assert_array_equal(emulate_dp(cand, gain, wait),
                                          peaks.dp_flags(cand, gain, wait),
                                          err_msg=f"dp {label} wait {wait}")


@pytest.mark.parametrize("chunk", [32, 64, 96])
def test_kernel_emulation_across_stages(chunk):
    """Stages smaller than the kernel's, so that walks and DP chains cross many of them."""
    for label, cand, gain in _flag_cases(301, chunk):
        for wait in (0, 1, 5, 7, 30, 31, 32, 70, 2**31 - 1):
            got, _ = emulate_greedy(cand, wait, chunk=chunk)
            np.testing.assert_array_equal(got, peaks.greedy_select(cand, wait))
            np.testing.assert_array_equal(emulate_dp(cand, gain, wait, chunk=chunk),
                                          peaks.dp_flags(cand, gain, wait))


def test_dp_emulation_on_special_gains():
    rng = np.random.RandomState(7)
    special = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, -1.5, 2.0, 0.25, 1e30, -1e30],
                       np.float32)
    for T, wait in ((9, 0), (64, 1), (130, 3), (130, 7), (300, 20)):
        cand = rng.rand(2, T) < 0.5
        gain = rng.choice(special, size=(2, T))
        with np.errstate(invalid="ignore"):
            want = peaks.dp_flags(cand, gain, wait)
        np.testing.assert_array_equal(emulate_dp(cand, gain, wait), want)


def test_an_undersized_ring_loses_values():
    """The emulation's ring check has teeth: half the ring the wrapper chooses fails."""
    cand = np.ones((1, 200), bool)
    gain = np.ones((1, 200), np.float32)
    for wait in (14, 30):
        assert emulate_dp(cand, gain, wait).any()
        with pytest.raises(AssertionError, match="lost a value"):
            emulate_dp(cand, gain, wait, ring=peaks.ring_size(200, wait) // 2)


def test_walk_steps_are_words_plus_takes():
    cand = np.zeros((1, 8193), bool)
    cand[0, ::50] = True
    takes = int(peaks.greedy_select(cand, 10).sum())
    got, steps = emulate_greedy(cand, 10)
    assert takes == 164 and got.sum() == takes
    assert steps <= 257 + takes


def test_ring_size_and_route():
    G = peaks.DP_GROUP
    assert [peaks.ring_size(100, w) for w in (0, 6, 7, 14, 15, 30, 31)] == [G, G, 16, 16, 32, 32,
                                                                            64]
    assert peaks.ring_size(10, 9) == G and peaks.ring_size(10, 2**31 - 1) == G  # no reach
    assert peaks.ring_size(10, 8) == 16
    big = 10**6
    assert peaks.dp_route(big, peaks.RING_MAX - 2) == "ring"
    assert peaks.dp_route(big, peaks.RING_MAX - 1) == "scratch"
    assert peaks.dp_route(peaks.RING_MAX, 2**31 - 1) == "ring"
    assert peaks.dp_route(peaks.RING_MAX + 1, peaks.RING_MAX - 1) == "scratch"


# --- the DP's walk is the greedy selection of its flags --------------------------------------

@settings(max_examples=60, deadline=None)
@given(rows=st.integers(1, 3), T=st.integers(1, 200), wait=st.integers(0, 260),
       density=st.sampled_from([0.0, 0.1, 0.5, 1.0]), seed=st.integers(0, 2**31 - 1))
def test_dp_walk_is_the_greedy_selection(rows, T, wait, density, seed):
    taken = np.random.RandomState(seed).rand(rows, T) < density
    want = jax_peaks.dp_mask(taken, wait)
    np.testing.assert_array_equal(peaks.dp_mask(taken, wait), want)
    np.testing.assert_array_equal(peaks.greedy_select(taken, wait), want)


class _CardTensor(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to follow the card's route of ``ops.peaks``."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("method", ["dp_count", "dp_value"])
def test_peak_pick_walks_the_dp_flags_with_the_greedy_kernel_on_the_card(monkeypatch, method):
    """On a CUDA tensor the DP route of ``peak_pick`` hands the taken flags, still on the card,
    to ``greedy_scan`` and never enters ``dp_mask``'s host loop."""
    x = _envelopes(31, rows=3, length=400)
    kw = dict(pre_max=3, post_max=1, pre_avg=10, post_avg=11, delta=0.07, wait=4)
    flags, calls = [], []
    dp_values = peaks.dp_values

    def on_card(*args, **kwargs):
        flags.append(dp_values(*args, **kwargs))
        return flags[-1].as_subclass(_CardTensor)

    def greedy_scan(cand, wait):
        calls.append((cand, wait))
        return torch.from_numpy(peaks.greedy_select(cand.as_subclass(torch.Tensor).numpy(), wait))

    def host_loop(*args):
        raise AssertionError("dp_mask walked on the host")

    monkeypatch.setattr(peaks, "dp_values", on_card)
    monkeypatch.setattr(peaks, "greedy_scan", greedy_scan)
    monkeypatch.setattr(peaks, "_walk_host", host_loop)
    got = L.util.peak_pick(x, sparse=False, method=method, **kw)
    assert len(calls) == 1 and calls[0][1] == 4
    cand = calls[0][0]
    assert cand.device.type == "cuda" and cand.dtype == torch.bool and tuple(cand.shape) == x.shape
    assert torch.equal(cand.as_subclass(torch.Tensor), flags[0])
    np.testing.assert_array_equal(got, jax_peak_pick(x, sparse=False, method=method, **kw))
