#!/usr/bin/env python3
"""Drive librosa_tpu_torch's main path on one CUDA card and check it.

Run from the root of a checkout with ``python3 chip_smoke.py`` on a machine
with one NVIDIA H100, ``nvcc`` and a CUDA build of PyTorch. It

1. builds every CUDA kernel of the port from ``librosa_tpu_torch/csrc``;
2. holds each kernel against its plain PyTorch version on the card (every
   n_fft the mel kernel takes, ragged tiles, empty and two-column basis
   rows, a silent second per frame, a quiet track per track), and the mel
   kernel against a float64 numpy reference;
3. drives the main path, y -> melspectrogram -> power_to_db -> mfcc,
   through the public functions on 16 tracks of 2**22 samples (the same
   64 M samples as bench.py's steady-state buffer) and checks that the
   kernel carried it and that the output is right;
4. times the kernel, its plain version, a torch.stft + matmul yardstick,
   the end-to-end path and its dB and MFCC steps, with the roofline bound;
4a. holds the dB kernel (``csrc/db_scale.cu``) against its plain version,
   bit for bit, on NaN-filled memory at the main shape and at ragged ones
   (16 channels and one, channels of a few MB and one beyond L2, the
   16-byte and the scalar path, ``top_db=None``), checks that the peak is
   exactly 0 dB with ``ref=max``, and times it beside the plain version and
   the bound;
4b. drives the feature stack (``entry.feature_stack()``: mfcc, chroma_stft,
   spectral_centroid, spectral_rolloff, each from ``y``) on the same
   buffer, checks that it launched the mel kernel four times and the dB
   kernel once and that each output agrees with float64 numpy, and times
   it end to end, the mel kernel with the chroma and the identity basis,
   and the centroid and roll-off tails alone;
4c. holds the synthesis kernel (``csrc/ola_norm.cu``: window, overlap-add,
   trim and normalise behind ``istft``) against its plain version and
   against float64 on NaN-filled memory (n_fft 512 to 2048; hops that
   divide n_fft, do not, and equal it; centred or not; ``length`` shorter
   and longer than the frames; a short window; one and several tracks) and
   checks that a second run gives the same bits;
4d. drives ``entry.reconstruction()`` (resample 22050 -> 16000 Hz, |STFT|,
   32 rounds of Griffin-Lim) on the same buffer, checks that it launched the
   mel kernel once and the synthesis kernel 33 times, holds the mel kernel
   at this path's shape (rows off a 16-byte boundary, a ragged last frame
   tile) against its plain version and float64, ``resample`` against float64 ``scipy.signal.resample_poly``, ``istft(stft(y))`` against
   ``y``, four zero-phase rounds against a float64 numpy loop, the spectral
   convergence and the seed's determinism, and times the path end to end
   and part by part, with its peak memory;
4e. holds ``estimate_tuning`` against a float64 numpy version on detuned
   tones, ``piptrack`` with ``ref=np.mean``, ``np.sum`` and ``torch.mean``
   on the card against the CPU run (``np.median`` raises there), drives
   ``chroma_stft`` with the default (estimated) tuning on the main buffer
   against float64, and times both;
4f. holds the sliding-median kernel (``csrc/median_filter.cu``, behind HPSS)
   against its plain version, bit for bit with NaN where the plain version
   has NaN, on NaN-filled memory: every window width it instantiates (2 to
   64), both axes, contiguous and time-major layouts, axes shorter than half
   the window, axis lengths around the kernel's group of outputs and its run,
   1025 and 8193, infinities, zeros of both signs, leading dims that must be
   copied;
4g. drives config 4 (``entry.cqt_hpss()``: ``cqt`` at 84 bins, 12 to the
   octave, and ``effects.hpss``) on the same buffer, checks that it launched
   the median kernel twice and the synthesis kernel twice, holds ``cqt`` on
   track 0 against the port's own float64 CPU run and ``effects.hpss`` on two
   tracks against float64 numpy and scipy, prints the octave plan, holds the
   median kernel at the path's full width (both axes of ``|STFT|`` in
   ``stft``'s layout) against its plain version track by track and times it
   beside the plain version, ``torch.median`` and the bound, times the path
   and its parts with its peak memory, and holds the mel kernel with the
   pseudo-CQT basis (``pseudo_cqt``, ``hybrid_cqt``) against its plain
   version;
4h. drives config 1 from audio files: writes 16 files of 2**22 output
   samples from a seeded PCM16 source (8 mono WAV and 4 mono FLAC at 22050
   Hz, 4 stereo WAV at 44100 Hz), checks that the port's decoder (built with
   g++ from ``csrc/audioio.cpp``) read them, ``load``s each with its defaults
   (the 44.1 kHz files mixed to mono and resampled 2:1 on the card), checks
   the native-rate tracks bit-equal to their PCM and the resampled ones
   against float64 ``scipy.signal.resample_poly``, runs ``entry()``'s
   forward on the stacked batch (bit-equal to the same samples put on the
   card directly), streams a FLAC and a WAV file in blocks of 256 frames
   with a mel spectrogram per block against the whole file's, and times
   decoding, ``load`` and its stages, the forward, the path end to end and
   the stream;
4i. config 5: holds the batched beat DP kernel (``csrc/beat_dp.cu``, steps of
   frames that do not depend on each other) against its plain version, bit
   for bit on NaN-filled memory (ragged T from 1 to 8193, T shorter than a
   step, tempo per row and per frame, fpb 1-3 and fpb per frame swinging
   2-60, a window past 1024 frames, an all negative row; 1 and 16 rows), and
   the Viterbi kernels (``csrc/viterbi.cu``) likewise on both routes of the
   forward pass and through ``viterbi_decode`` (2 to 1027 states, both sides
   of the route threshold, 1 to 8193 frames, 1 to 17 rows, pYIN's pruned
   transitions with and without two all -inf columns, log_prob -inf over a
   column's runs, a dense 870-state matrix, a third of the transitions -inf,
   exact ties), and the trough priors kernel (``csrc/trough_priors.cu``) against its
   plain loop, bit for bit in float32 and float64 (pYIN's own CMND and troughs at (16, 314, 8193)
   and (32, 314, 1292), random ones from numpy, frames with no trough, one, every other lag
   or every lag a trough, values at the float thresholds, T = 1, P = 2047, a strided view),
   once per ``pyin`` call, timed beside the loop and its bound by bytes; times the forward
   pass by route at S = 2, 5, 64, 128, 256 and 870; drives ``entry.onset_beat_pyin()``
   (onset strength, tempo, beats, pYIN at 65-800 Hz) on 16 seeded tracks of a melody over
   clicks of 2**22 samples,
   checks its launches (stft_mel, db_scale, beat_dp, viterbi and trough_priors once each)
   and holds tracks 0 and 1 against the port's float64 CPU run; runs
   bench.py's 1-D shapes (``beat_track`` of 30 s through the host DP,
   ``pyin`` of 5 s) against float64 too; holds both kernels at the path's
   shapes against their plain versions and times the path, its parts, both
   kernels (B's forward at cluster 8 and 4 and its backtrack apart), their
   plain versions, bounds and probes (A's step chain, B's cluster exchange,
   ``cudaOccupancyMaxActiveClusters``), beside the earlier designs' times,
   with the peak memory;
4j. alignment and structure on bench.py's 5 s chirp tiled to the main
   shape (each track from its own point of the sweep, over a seeded noise
   floor): ``feature.mfcc`` and ``chroma_stft`` of the 16 tracks (the mel
   kernel, held against its plain version there), then on one or two
   tracks of 8193 frames ``segment.recurrence_matrix`` (connectivity,
   sparse affinity), ``recurrence_to_lag``, ``cross_similarity``,
   ``decompose.nn_filter`` on chroma, ``sequence.dtw`` between two tracks'
   chroma (8193 x 8193 cells) and ``sequence.rqa`` on a cosine affinity of
   the first 2048 frames (the RQA DP is host numpy, as in the JAX package:
   the cut). Each neighbour search is held against float64 (the same
   candidates but for near-ties, which are named), the graphs against the
   rule applied to those candidates, the affinity, ``nn_filter`` and ``D``
   against float64 at stated floors, the lag exactly, the RQA corner bit
   for bit against a scalar float64 loop; device parts timed by CUDA
   events, the host DPs by the host clock, with the peak memory;
4k. the effects on the main buffer: ``time_stretch`` at 1.25 and 0.8,
   ``pitch_shift`` by 3 semitones (``res_type='fft'``), ``remix`` with and
   without zero crossings, ``trim`` and ``split`` on a copy with silence,
   ``preemphasis`` and ``deemphasis``; each against float64 numpy and scipy
   on track 0 (remix, trim and split exactly), ``time_stretch`` at 0.8 and
   ``pitch_shift`` by 2 semitones on a copy of track 0 with 11025 samples of
   exact silence against float64 (the silent bins' phases stay 0, and the
   count of -0.0 real parts cuFFT gives them is printed), the synthesis kernel at the
   slow stretch's shape bit for bit and the dB kernel at trim's against
   their plain versions; times and peak memory;
4l. features and inversion on the main buffer: ``spectral_bandwidth``,
   ``spectral_contrast``, ``spectral_flatness`` and ``poly_features`` from
   ``y`` (the mel kernel with the identity basis, four launches), ``tonnetz``
   from ``chroma_stft``, ``delta`` (orders 1 and 2), ``stack_memory`` and
   ``mfcc_to_mel`` on its MFCCs; on the chirp batch's mel spectrogram
   ``mel_to_stft`` (NNLS, 300 FISTA rounds over all 131088 frames) and
   ``mel_to_audio`` (32 Griffin-Lim rounds, the synthesis kernel 33 times).
   Track 0 against float64 numpy and scipy; the NNLS on track 0's first
   128 frames against a float64 FISTA from the same start, by its fit and
   objective; Griffin-Lim by its convergence to the NNLS magnitude; times
   and peak memory;
4m. ``pcen`` of the main buffer's power spectrogram (whole, max-filtered,
   streamed in two halves through ``zi``/``zf``), ``reassigned_spectrogram``
   of the chirp batch, ``iirt`` (``res_type='polyphase'``, 85 bands) of all
   16 tracks and ``fmt`` of each track's first 2**18 samples; track 0
   against float64 (scipy's ``lfilter``, three float64 STFTs, ``sosfiltfilt``
   of the port's resampled track per band, ``interp1d`` and ``rfft``);
   times and peak memory;
4n. the rest of ``segment`` and the infrastructure: the chirp batch's
   ``mfcc``, then ``recurrence_matrix(mode='affinity')`` of tracks 0 and 1
   stacked dense into ``(2, 8193, 8193)`` float32 on the card,
   ``path_enhance(R, 15)`` (against float64 ``scipy.ndimage.convolve`` on a
   1024 x 1024 crop of track 0, and the full run's interior of that crop),
   ``timelag_filter`` with scipy's median filter on that crop (host; equal
   to the median of the lag matrix sheared here), the
   two-stage FFTs (``ops.ctfft``) of 5 s of the main buffer against float64
   and beside ``torch.fft``, ``resample(res_type='fft')`` under the
   ``'matmul'`` backend against ``'auto'`` and float64; ``calibrate``'s
   ceilings beside the datasheet's, ``dispatch_profile`` of configs 1 and 5
   with the profiler's count of the mel and dB kernels held equal to the
   wrappers' counters and the device's busy share, and ``roofline`` of
   ``path_enhance``; times, path_enhance's peak memory and the bound of its
   dense work;
4o. the sharded layer (``librosa_tpu_torch.parallel``) on an 8-position time
   mesh laid on the one card and on ``time_mesh()`` (one position): every
   sharded chain (stft constant and reflect, melspectrogram, mfcc,
   onset_strength, tempo, pcen, cqt at config 4's call, chroma_cqt, hpss,
   pyin, beat_track) on the main buffer or config 5's signal against the
   unsharded port (the STFTs bit for bit, the rest at
   ``tests/test_parallel.py``'s tolerances), each chain's kernel launches
   against the design (the mel kernel once a position and once for the
   trailing frame, the median kernel twice a position, the trough priors
   kernel once a position and once for the one-frame tail, the dB, beat DP
   and Viterbi kernels once), the sharded envelope against float64; times by
   CUDA events and peak memory at 8 and 1 positions beside the unsharded
   call, ``scaling_report`` over 1-8 positions of the card (the cost of
   sharding on one card, not scaling), ``dispatch_profile`` of two chains,
   and ``entry.dryrun_multichip(8)`` against float64 autograd;
4p. the precision dials and the selection scans: the mel kernel on the main
   buffer at ``precision`` 'default', 'high', 'highest' and ('highest',
   'highest', 'default'), each against its plain version, against the plain
   projection at that setting of the kernel's own power spectrum, and
   against float64, 'highest' bit-equal to a call with no precision; the
   'matmul' route's power spectrum of the main frames at the three settings
   against float64 and against the rounded operands through exact float32
   products, with the ``torch.backends`` flags unchanged; ``onset_detect``
   (``sparse=False``) on the main buffer's onset envelope for 'greedy',
   'dp_count' and 'dp_value' at wait 0, 10 and 300, the ``peak_scan``
   kernels (``csrc/peak_scan.cu``) bit for bit against their plain loops on
   every launch of that path (greedy 9, of them 6 walks over the DP's flags;
   dp 6) and on ragged small cases (T 1-2**21, waits at the ring's ends and
   past its largest, the scratch route); times of every setting and scan
   beside the plain versions and the bounds, the scans at waits 0, 1, 10 and
   300 on the envelope and on a batch of 256 shifted copies, beside the
   DP's scratch route (a thread a row) on the same inputs, the walk, countdown and DP chain probes and
   an empty launch; ``onset_detect`` end to end on both;
5. holds the staged-copy kernels (``csrc/staged_probe.cu``) against their
   plain versions in every variant of the diagnostics, at their default
   geometry, with the pipeline at WRAP 128 and 1024, and a strided row
   probe whose output rows are not 16-byte aligned (the thread stores);
6. drives the diagnostics through their entry points
   (``librosa_tpu_torch.diagnostics``), checks that they launched both
   kernels, and times each variant's kernel, plain version and
   ``torch.sum`` yardstick beside its bound and the earlier design's time;
7. times the row probe at the mel kernel's own tile geometry on the
   main-path buffer, beside the mel kernel's time, and prints every
   kernel as one ``{"kernels": [...]}`` JSON line;
8. prints ``{"ok": true, "device": {...}}`` as its last line.

Any failed check raises, so the exit code is not 0 and no result line is
printed. Without CUDA, or without the package beside it, it fails too.
It imports torch, numpy, scipy and the port, nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SR = 22050
MAIN = dict(n_fft=2048, hop_length=512, n_mels=128)
MAIN_SHAPE = (16, 1 << 22)
MIN_SNR_DB = 115.0        # goldens' melspectrogram tolerance (power 2 and others)
MIN_SNR_POWER1_DB = 110.0  # |.| (power 1): sqrt near zero bins loses ~5 dB
MIN_MFCC_SNR_DB = 105.0   # goldens' mfcc tolerance
MIN_CHROMA_SNR_DB = 115.0  # the chroma projection is the mel kernel with another basis
MIN_CENTROID_SNR_DB = 100.0  # a ratio of two sums over |.| (power 1) spectra
MIN_ROLLOFF_EQUAL = 0.999  # share of frames on the float64 bin; the rest one bin off
DB_ATOL = 1e-4            # dB: kernel and plain take the same float32 steps
RECON = dict(n_fft=2048, hop_length=512)
RECON_SR = 16000
MIN_OLA_PLAIN_SNR_DB = 130.0   # the same float32 products and sums (in practice bit-equal)
MIN_OLA_F64_SNR_DB = 115.0     # the goldens' istft floor
MIN_RESAMPLE_SNR_DB = 100.0    # one float32 matrix product over 28 taps a phase
MIN_ROUNDTRIP_SNR_DB = 115.0   # the goldens' istft(stft(y)) floor
MIN_GL_SNR_DB = 80.0           # four rounds feed their float32 rounding back through the FFTs
MAX_CONVERGENCE_32 = 0.15      # || |stft(y_hat)| - S || / || S || after 32 rounds, on noise
                               # (0.109940 on the H100; 0.260743 after 4 rounds)
TUNING_RESOLUTION = 0.01       # the histogram's cell: the port and float64 may differ by one
MIN_CQT_SNR_DB = 100.0         # cqt on the card against the port's float64 CPU run
MIN_HPSS_SNR_DB = 85.0         # the hpss_configs golden's floor: float32 and float64 may
                               # order tied medians differently

# H100 SXM datasheet (dense): HBM bytes/s and float32 CUDA-core FLOP/s
H100_HBM_BYTES_S = 3.35e12
H100_F32_FLOP_S = 67e12

DIAG_FAR_WRAP = 1024     # the pipeline over 268.7 MB, beyond the 50 MB L2
# the staged-copy kernels' first design (three slots, a block-wide barrier a chunk, whole
# tiles a block, thread stores), ms: PERF.md section 6, NVIDIA H100 80GB HBM3, 700 W
DIAG_FIRST_MS = {"m0": 0.2143, "m_out": 0.3842, "m_outg4": 0.3851, "m_outg8": 0.3823,
                 "m_outc": 0.3556, "m_edge": 0.3844, "m_kitchen": 0.4167,
                 "m_kitchen_notab": 0.3890, "m_kitchen_nox": 0.4162, "m_kitchen_nooff": 0.4091,
                 "m_kitchen_nostart": 0.4112, "m_kitchen_g1024": 0.1315, "scale_pre2d": 0.1434,
                 "scale_flat512": 0.1425, "scale_flat128": 0.1411, "pipeline wrap 128": 0.2118,
                 "pipeline wrap 1024": 0.3752}
DIAG_RTOL = 1e-5         # sums of the same floats in two orders ...
DIAG_ATOL_REL = 1e-5     # ... differ by a few ulps of the sum of their magnitudes


def snr_db(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.sum((got - want) ** 2)
    return float(10 * np.log10(np.sum(want**2) / max(err, 1e-300)))


def stft64(y, window, *, n_fft, hop, center=True, pad_mode="constant"):
    """STFT in float64 numpy, as complex (1 + n_fft // 2, T)."""
    y = np.asarray(y, dtype=np.float64)
    if center:
        y = np.pad(y, n_fft // 2, mode=pad_mode)
    frames = np.lib.stride_tricks.sliding_window_view(y, n_fft)[::hop]
    return np.fft.rfft(frames * np.asarray(window, np.float64), axis=-1).T


def spec64(y, window, **kw):
    """|STFT| in float64 numpy, as (1 + n_fft // 2, T)."""
    return np.abs(stft64(y, window, **kw))


def mel64(y, window, basis, *, n_fft, hop, power=2.0, center=True, pad_mode="constant"):
    """|STFT|**power @ basis.T in float64 numpy, as (n_out, T)."""
    spec = spec64(y, window, n_fft=n_fft, hop=hop, center=center, pad_mode=pad_mode)
    return np.asarray(basis, np.float64) @ spec**power


def mfcc64(mel, n_mfcc=20):
    """power_to_db (ref 1, amin 1e-10, top_db 80) then orthonormal DCT-II, float64."""
    import scipy.fft

    db = 10 * np.log10(np.maximum(1e-10, mel))
    db = np.maximum(db, db.max() - 80.0)
    return scipy.fft.dct(db, type=2, norm="ortho", axis=-2)[:n_mfcc]


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, launches: int, groups: int = 3) -> float:
    """Best of ``groups`` CUDA-event timings of ``launches`` calls in flight."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / launches)
    return best


def kernel_cases(L, rng, tile_frames):
    """(label, y, window, basis, kwargs, min_snr): the CPU tests' cases and more.

    ``tile_frames(n_fft, hop)`` is the kernel's frames per block.
    """
    def mel(n_fft, n_mels=64):
        return L.filters.mel(sr=SR, n_fft=n_fft, n_mels=n_mels)

    dense12 = {n: rng.rand(12, n // 2 + 1).astype(np.float32) for n in (512, 256)}
    cases = []
    for n_fft, hop in ((512, 128), (256, 128)):
        win = L.filters.get_window("hann", n_fft)
        for length in (40000, 2 * 128 * 128, 400):
            for center in (True, False):
                for pad_mode in ("constant", "reflect"):
                    if not center and (pad_mode == "reflect" or length < n_fft):
                        continue
                    y = (rng.randn(length) * 0.1).astype(np.float32)
                    cases.append((f"n_fft={n_fft} hop={hop} len={length} center={center} "
                                  f"{pad_mode}", y, win, mel(n_fft),
                                  dict(n_fft=n_fft, hop_length=hop, center=center,
                                       pad_mode=pad_mode), MIN_SNR_DB))
        y3 = (rng.randn(3, 129 * 128 + 57) * 0.1).astype(np.float32)
        for power, floor in ((1.0, MIN_SNR_POWER1_DB), (2.0, MIN_SNR_DB), (1.5, MIN_SNR_DB)):
            cases.append((f"n_fft={n_fft} 3 tracks power={power}", y3, win, mel(n_fft),
                          dict(n_fft=n_fft, hop_length=hop, power=power), floor))
        y = (rng.randn(2, 20000) * 0.1).astype(np.float32)
        cases.append((f"n_fft={n_fft} dense 12-row basis", y, win, dense12[n_fft],
                      dict(n_fft=n_fft, hop_length=hop), MIN_SNR_DB))
        cases.append((f"n_fft={n_fft} identity basis", y, win,
                      np.eye(n_fft // 2 + 1, dtype=np.float32),
                      dict(n_fft=n_fft, hop_length=hop), MIN_SNR_DB))
    for n_fft, hop, n_mels, length in ((2048, 512, 128, 4 * SR), (4096, 1024, 128, 4 * SR),
                                       (2048, 500, 128, 3 * SR), (8192, 2048, 128, 3 * SR),
                                       (64, 16, 16, 5000)):
        y = (rng.randn(2, length) * 0.1).astype(np.float32)
        cases.append((f"n_fft={n_fft} hop={hop} {n_mels} mels", y,
                      L.filters.get_window("hann", n_fft), mel(n_fft, n_mels),
                      dict(n_fft=n_fft, hop_length=hop), MIN_SNR_DB))
    # every n_fft the kernel takes: a quarter hop, no overlap, and a hop of one sample
    for log2_n in range(6, 14):
        n_fft = 1 << log2_n
        win, basis = L.filters.get_window("hann", n_fft), mel(n_fft, 16 if n_fft < 256 else 64)
        for hop, length in ((n_fft // 4, 40 * n_fft + 77), (n_fft, 40 * n_fft + 77),
                            (1, n_fft + 301)):
            y = (rng.randn(2, length) * 0.1).astype(np.float32)
            cases.append((f"n_fft={n_fft} hop={hop} len={length}", y, win, basis,
                          dict(n_fft=n_fft, hop_length=hop), MIN_SNR_DB))
    # frame counts one beside a multiple of the tile, and basis rows the band walk could miss
    n_fft, hop = MAIN["n_fft"], MAIN["hop_length"]
    win, tile = L.filters.get_window("hann", n_fft), tile_frames(n_fft, hop)
    for n_frames in (5 * tile + 1, 5 * tile - 1):
        y = (rng.randn(2, (n_frames - 1) * hop) * 0.1).astype(np.float32)
        cases.append((f"n_fft={n_fft} hop={hop} {n_frames} frames (tile {tile})", y, win,
                      mel(n_fft, 128), dict(n_fft=n_fft, hop_length=hop), MIN_SNR_DB))
    y = (rng.randn(2, 3 * SR) * 0.1).astype(np.float32)
    holes = mel(n_fft, 128).copy()
    holes[[0, 63, 127]] = 0.0
    cases.append((f"n_fft={n_fft} basis with all-zero rows", y, win, holes,
                  dict(n_fft=n_fft, hop_length=hop), MIN_SNR_DB))
    ends = np.zeros((6, n_fft // 2 + 1), np.float32)
    ends[:, 0], ends[:, -1] = 1.0, 2.0
    cases.append((f"n_fft={n_fft} basis rows of first and last column only", y, win, ends,
                  dict(n_fft=n_fft, hop_length=hop), MIN_SNR_DB))
    return cases


def poison(torch, shape, device) -> None:
    """Fill a buffer of ``shape`` with NaN and free it.

    The wrapper's ``torch.empty`` of the same size then most likely gets
    this memory, so an element the kernel's schedule skips shows as NaN
    instead of passing on a stale right value.
    """
    torch.full(shape, float("nan"), dtype=torch.float32, device=device)


def checked_kernel(torch, fused_stft, yd, win, basis, **kw):
    """The kernel's output on poisoned memory; raises if any element is not finite."""
    n_out = basis.shape[0]
    _, n_frames = fused_stft.frame_geometry(
        yd.shape[-1], n_fft=kw["n_fft"], hop_length=kw["hop_length"],
        center=kw.get("center", True))
    poison(torch, (*yd.shape[:-1], n_out, n_frames), yd.device)
    got = fused_stft.stft_mel_fused(yd, win, basis, **kw)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"the stft_mel kernel left {int((~torch.isfinite(got)).sum())} "
                             f"of {got.numel()} values unwritten or not finite")
    return got


def per_frame_and_track_checks(torch, L, fused_stft, rng, device) -> None:
    """A silent second inside noise, frame by frame; a quiet track beside a loud one."""
    n_fft, hop = MAIN["n_fft"], MAIN["hop_length"]
    win = L.filters.get_window("hann", n_fft)
    basis = L.filters.mel(sr=SR, n_fft=n_fft, n_mels=MAIN["n_mels"])
    kw = dict(n_fft=n_fft, hop_length=hop)

    y = (rng.randn(2, 4 * SR) * 0.1).astype(np.float32)
    lo, hi = SR + 100, 2 * SR + 100   # not on a tile's edge
    y[1, lo:hi] = 0.0
    got = checked_kernel(torch, fused_stft, torch.from_numpy(y).to(device), win, basis, **kw)
    starts = np.arange(got.shape[-1]) * hop - n_fft // 2
    silent = (starts >= lo) & (starts + n_fft <= hi)
    loud = (starts + n_fft <= lo) | (starts >= hi)
    frames = got[1].cpu().numpy()
    worst = float(np.abs(frames[:, silent]).max())
    level = float(frames[:, loud].mean())
    print(f"silent second inside noise at 0.1: {int(silent.sum())} silent frames, largest value "
          f"{worst:.3e} against the loud frames' mean {level:.3e}")
    if not worst <= 1e-12 * level:
        raise AssertionError(f"silent frames reach {worst:.3e}, above 1e-12 of {level:.3e}")
    want = fused_stft.stft_mel_reference(torch.from_numpy(y).to(device), win, basis, **kw)
    s = snr_db(frames[:, loud], want[1].cpu().numpy()[:, loud])
    print(f"the same track's loud frames, kernel vs plain: {s:.1f} dB")
    if not s >= MIN_SNR_DB:
        raise AssertionError(f"loud frames beside silence: {s:.1f} dB < {MIN_SNR_DB}")

    y = rng.randn(2, 4 * SR).astype(np.float32)
    y[0] *= 1e-4
    yd = torch.from_numpy(y).to(device)
    got = checked_kernel(torch, fused_stft, yd, win, basis, **kw).cpu().numpy()
    want = mel64(y[0], win, basis, n_fft=n_fft, hop=hop), mel64(y[1], win, basis, n_fft=n_fft,
                                                                hop=hop)
    for track, scale in ((0, 1e-4), (1, 1.0)):
        s = snr_db(got[track], want[track])
        print(f"track of noise at {scale:g} beside one at {1e-4 / scale:g}, kernel vs float64: "
              f"{s:.1f} dB")
        if not s >= MIN_SNR_DB:
            raise AssertionError(f"track at {scale:g}: {s:.1f} dB < {MIN_SNR_DB}")


def check_case(torch, case) -> float:
    """Kernel against plain on the card; raises on a miss. Returns max |err|.

    Variants share their output buffers, so the buffer is filled with NaN
    first: an element the kernel leaves unwritten cannot pass with an
    earlier variant's value.
    """
    case.out.fill_(float("nan"))
    got = case.run()
    want = case.plain()
    tol = DIAG_ATOL_REL * case.plain(absolute=True) + DIAG_RTOL * want.abs()
    torch.cuda.synchronize()
    err = (got - want).abs()
    bad = int((~(err <= tol)).sum())  # NaN counts as outside
    max_err = float(err.max())
    print(f"staged kernel vs plain  {case.name}: max |err| {max_err:.3e}, "
          f"{bad} of {got.numel()} outside rtol {DIAG_RTOL} + atol {DIAG_ATOL_REL} x sum|x|")
    if bad or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"staged kernel vs plain {case.name}: {bad} values outside "
                             f"the tolerance, max |err| {max_err:.3e}")
    return max_err


def staged_diagnostics(torch, device, y, k1_ms: float) -> list:
    """Phases 5-7: the staged-copy kernels checked, driven and timed; their JSON entries."""
    from librosa_tpu_torch.diagnostics import dma_bisect, dma_pipeline_micro
    from librosa_tpu_torch.ops import fused_stft, staged_probe

    near = dma_bisect.Inputs(device, wrap=dma_bisect.WRAP, seed=0)
    far = dma_bisect.Inputs(device, wrap=DIAG_FAR_WRAP, seed=1)
    cases = [dma_bisect.make_case(name, near) for name in dma_bisect.ALL_NAMES]
    cases += [dma_pipeline_micro.make_case(near), dma_pipeline_micro.make_case(far)]
    unaligned = dma_bisect.unaligned_case(near)

    # 5. every variant's kernel against its plain version on the same input
    before = dict(staged_probe.launches)
    errs = {case.name: check_case(torch, case) for case in [*cases, unaligned]}
    for kernel, n in staged_probe.launches.items():
        if n <= before[kernel]:
            raise AssertionError(f"the checks did not launch {kernel}")

    # 6. the diagnostics path through its entry points, counted on its own
    for kernel in staged_probe.launches:
        staged_probe.launches[kernel] = 0
    records = dma_bisect.run(list(dma_bisect.ALL_NAMES), device=device, inputs=near)
    records.append(dma_pipeline_micro.run(dma_bisect.WRAP, device=device, inputs=near))
    records.append(dma_pipeline_micro.run(DIAG_FAR_WRAP, device=device, inputs=far))
    torch.cuda.synchronize()
    path_launches = dict(staged_probe.launches)
    print(f"diagnostics path launches: {path_launches}")
    for kernel, n in path_launches.items():
        if n < 1:
            raise AssertionError(f"the diagnostics path did not launch {kernel}")

    timed = {}
    for case, rec in zip(cases, records):
        if case.name != rec["name"]:
            raise AssertionError(f"timed {rec['name']!r} in place of {case.name!r}")
        plain_ms = time_ms(torch, case.plain, 5)
        library = case.library()
        library_ms = time_ms(torch, library, 5) if library is not None else None
        timed[case.name] = dict(rec, plain_ms=plain_ms, library_ms=library_ms)
        print(f"staged {case.name}: kernel {rec['ms']:.4f} ms (first design "
              f"{DIAG_FIRST_MS[case.name]:.4f}), "
              f"{rec['us_per_tile_raw']:.4f} us/tile raw over {case.n_tiles} tiles, "
              f"staged {case.staged_bytes} B, unique read {case.read_bytes} B, written "
              f"{case.written_bytes} B, working set {case.read_bytes / 1e6:.1f} MB"
              f"{' (L2-resident)' if case.l2_resident else ''}; plain {plain_ms:.4f} ms, "
              f"library {'null' if library_ms is None else f'{library_ms:.4f} ms'}, bound "
              f"{case.bound_ms:.4f} ms ({case.bound_by}), "
              f"{100 * case.bound_ms / rec['ms']:.1f} % of it")

    # 7. the row probe at the mel kernel's own tile geometry, on the main-path buffer
    k1 = dma_bisect.k1_staging_case(
        y, n_fft=MAIN["n_fft"], hop=MAIN["hop_length"], n_out=MAIN["n_mels"],
        frames_per_tile=fused_stft._tile_frames(MAIN["n_fft"], MAIN["hop_length"]))
    errs[k1.name] = check_case(torch, k1)
    k1_probe_ms = time_ms(torch, k1.run, 24)
    k1_plain_ms = time_ms(torch, k1.plain, 3)
    timed[k1.name] = dict(ms=k1_probe_ms, plain_ms=k1_plain_ms, library_ms=None)
    print(f"staging at the mel kernel's geometry ({k1.kwargs['rows_per_tile']} rows of "
          f"{k1.kwargs['width']} per tile, {k1.n_tiles} tiles of {k1.kwargs['tt']} frames, "
          f"output {tuple(k1.out.shape)}): {k1_probe_ms:.4f} ms, staged {k1.staged_bytes} B, "
          f"written {k1.written_bytes} B; plain {k1_plain_ms:.4f} ms, library null, bound "
          f"{k1.bound_ms:.4f} ms ({k1.bound_by}), {100 * k1.bound_ms / k1_probe_ms:.1f} % of "
          f"it; stft_mel kernel {k1_ms:.4f} ms in this run: this "
          f"TMA pipeline moves its bytes in {100 * k1_probe_ms / k1_ms:.2f} % of its time "
          f"(a floor for staging and write-back, not the kernel's own share)")

    def entry(kernel: str, headline: str, names: list, replaces: str) -> dict:
        head = timed[headline]
        case = next(c for c in cases if c.name == headline)
        return {
            "name": kernel,
            "route": "cuda",
            "source": "librosa_tpu_torch/csrc/staged_probe.cu",
            "replaces": replaces,
            "launches": path_launches[kernel],
            "max_abs_err": max(errs[n] for n in names),
            "ms": head["ms"],
            "kernel_ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": case.bound_ms,
            "bound_by": case.bound_by,
            "library_ms": head["library_ms"],
            "headline": headline,
            "variants": {n: timed[n]["ms"] for n in names if n in timed},
        }

    colsum = [c.name for c in cases if c.kernel == "stage_colsum"]
    rowprobe = [c.name for c in [*cases, unaligned, k1] if c.kernel == "stage_rowprobe"]
    return [
        entry("stage_colsum", f"pipeline wrap {DIAG_FAR_WRAP}", colsum,
              "D1 scripts/dma_bisect.py:72 make_m0; D6 scripts/dma_pipeline_micro.py:59 run"),
        entry("stage_rowprobe", "scale_pre2d", rowprobe,
              "D2 scripts/dma_bisect.py:121 make_m_out; D3 :177 make_m_edge; "
              "D4 :270 make_m_kitchen; D5 :340 make_m_scale"),
    ]


def db_cases(torch, rng, device, mel):
    """(label, fn name, S, kwargs): the main shape and ragged ones for the dB kernel: channels
    of a few MB and one beyond the L2 cache, the 16-byte and the scalar path, one channel and
    16."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)

    power = lambda *shape: rng.randn(*shape) ** 2  # noqa: E731
    zeros = power(3, 64, 50)
    zeros[1] = 0.0
    tiny = power(2, 40, 31) * 1e-12
    tiny[0, :5] = 1e-14
    unaligned = t(power(4 * 300 + 1))[1:]   # N % 4 == 0 behind a 4-byte offset
    odd16 = t(power(16, 128, 8191))         # N % 4 != 0: the scalar path
    odd16[3, 5, 7] = float("nan")
    one = t(power(1, 513, 2049))            # one channel of 4.2 MB, scalar path
    one[0, 100, 100] = 1e6                  # a lone peak far above the rest
    return [
        ("main shape, ref 1", "power_to_db", mel, {}),
        ("main shape, ref max", "power_to_db", mel, dict(ref=np.max)),
        ("main shape, top_db None", "power_to_db", mel, dict(top_db=None)),
        ("main shape, whole array (one channel beyond L2)", "power_to_db", mel,
         dict(ref=np.max, axes=None)),
        ("16 channels of 128 x 8191 (scalar), a NaN in channel 3", "power_to_db", odd16,
         dict(ref=np.max)),
        ("1 channel of 513 x 2049 (scalar), a lone peak", "power_to_db", one, dict(ref=np.max)),
        ("1-d of 15000001 (scalar, beyond L2)", "power_to_db", t(power(15000001)),
         dict(ref=np.max, top_db=None)),
        ("amplitude_to_db 4 x 1025 x 300, ref max", "amplitude_to_db", t(rng.randn(4, 1025, 300)),
         dict(ref=np.max, top_db=60.0)),
        ("1-d of 1001", "power_to_db", t(power(1001)), dict(ref=np.max)),
        ("1-d of 1200 off a 16-byte boundary", "power_to_db", unaligned, dict(ref=np.max)),
        ("one channel of 37 x 53", "power_to_db", t(power(1, 37, 53)), {}),
        ("a channel of zeros", "power_to_db", t(zeros), dict(ref=np.max)),
        ("values below amin", "power_to_db", t(tiny), dict(ref=np.max, top_db=30.0)),
        ("top_db None", "power_to_db", t(power(2, 3, 16, 33)), dict(top_db=None)),
        ("ref 0.5, amin 1e-6, top_db 40", "power_to_db", t(power(5, 128, 60)),
         dict(ref=0.5, amin=1e-6, top_db=40.0)),
        ("amplitude_to_db, ref 1", "amplitude_to_db", t(rng.randn(4, 128, 61)), {}),
        ("amplitude_to_db, ref max, top_db 60", "amplitude_to_db", t(rng.randn(2, 1025, 44)),
         dict(ref=np.max, top_db=60.0)),
        ("amplitude_to_db, ref 3", "amplitude_to_db", t(rng.randn(3000)), dict(ref=3.0)),
    ]


# constants quoted beside this run's times, not measured by it: the dB kernel's time on config
# 1's mel and the earlier median kernel's (one delete-and-insert pass per output) at size 31 on
# config 4's |STFT| (PERF.md section 6)
DB_EARLIER_MS = 0.0812
MEDIAN_EARLIER_MS = {"harmonic (time)": 2.4983, "percussive (frequency)": 2.8758}


def db_kernel_phase(torch, L, rng, device, mel) -> dict:
    """Phase 4a: the dB kernel against its plain version, then timed. Its JSON entry, less
    launches."""
    from librosa_tpu_torch.core.spectrum import _db_axes
    from librosa_tpu_torch.ops import db_scale

    worst = 0.0
    cases = db_cases(torch, rng, device, mel)
    for label, fn, S, kw in cases:
        before = db_scale.launches
        poison(torch, tuple(S.shape), device)
        got = getattr(L, fn)(S, **kw)
        if db_scale.launches != before + 1:
            raise AssertionError(f"dB {label}: {fn} did not launch the db_scale kernel")
        full = dict(dict(ref=1.0, amin=1e-5 if fn == "amplitude_to_db" else 1e-10, top_db=80.0),
                    **kw)
        axes = _db_axes(S.ndim, full.pop("axes", "auto"))
        channels, n, parts = db_scale.launch_geometry(S, axes)
        want = db_scale.db_scale_reference(S, axes=axes, amplitude=fn == "amplitude_to_db",
                                           **full)
        torch.cuda.synchronize()
        nan_want = torch.isnan(want)
        if not torch.equal(torch.isnan(got), nan_want):
            raise AssertionError(f"dB {label}: NaN where the torch ops have none, or none where "
                                 "they have NaN (or values left unwritten)")
        if not bool(torch.isfinite(got[~nan_want]).all()):
            raise AssertionError(f"dB {label}: values unwritten or not finite")
        err = float((got - want)[~nan_want].abs().max())
        worst = max(worst, err)
        equal = torch.equal(got.masked_fill(nan_want, 0.0), want.masked_fill(nan_want, 0.0))
        note = "bit-equal" if equal else "not bit-equal"
        if full["ref"] is np.max:
            dims = None if axes is None else tuple(axes)
            peak = got.amax() if dims is None else got.amax(dim=dims)
            peak = peak[~torch.isnan(peak)]
            if not bool((peak == 0).all()):
                raise AssertionError(f"dB {label}: the peak is not exactly 0 dB with ref=max: "
                                     f"{peak.flatten()[:4].tolist()}")
            note += ", peak exactly 0 dB"
        print(f"dB kernel vs plain  {label} {tuple(S.shape)}: {channels} channel(s) of {4 * n} "
              f"bytes, {parts} part(s) each; design two-pass (db_peak, db_apply), 2 launches per "
              f"call; max |err| {err:.3e} dB "
              f"({note})")
        if not (equal and err <= DB_ATOL):
            raise AssertionError(f"dB kernel vs plain {label}: not bit-equal, {err:.3e} dB")
    print(f"dB kernel vs plain: {len(cases)} cases bit-equal (NaN where the torch ops have "
          "NaN), each on NaN-filled memory")

    axes = (-2, -1)
    kw = dict(ref=1.0, amin=1e-10, top_db=80.0, axes=axes)
    ms = time_ms(torch, lambda: db_scale.db_scale(mel, **kw), 20)
    ms_max = time_ms(torch, lambda: db_scale.db_scale(mel, **dict(kw, ref=np.max)), 20)
    plain_ms = time_ms(torch, lambda: db_scale.db_scale_reference(mel, **kw), 5)
    channels, n, parts = db_scale.launch_geometry(mel, axes)
    # the function reads its input once and writes its output once; a kernel whose input
    # exceeds the L2 cache must read it a second time after the peak is known
    bound_ms = 1e3 * 8 * mel.numel() / H100_HBM_BYTES_S
    two_pass_ms = 1e3 * 12 * mel.numel() / H100_HBM_BYTES_S
    print(f"db_scale launch geometry on {tuple(mel.shape)}, axes {axes}: {channels} channels of "
          f"{n} elements ({4 * n} bytes), {parts} parts each")
    print(f"db_scale kernel on {tuple(mel.shape)}: {ms:.4f} ms (ref max {ms_max:.4f} ms; "
          f"an earlier run {DB_EARLIER_MS} ms in PERF.md, a constant), plain torch ops "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes: {8 * mel.numel()} read and "
          f"written once; {two_pass_ms:.4f} ms for the {12 * mel.numel()} bytes of two reads "
          f"and a write)")
    return {
        "name": "db_scale",
        "route": "cuda",
        "source": "librosa_tpu_torch/csrc/db_scale.cu",
        "replaces": "librosa_tpu/core/spectrum.py:752 _db_maxref_core (an XLA program: no "
                    "Pallas kernel computes this step)",
        "max_abs_err": worst,
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "two_pass_bound_ms": two_pass_ms,
    }


def stft_project(torch, y, window, basis, n_fft, hop, power):
    """The library yardstick for the stft_mel kernel: torch.stft, |.|^power, torch.matmul."""
    spec = torch.stft(y, n_fft, hop, window=window, center=True, pad_mode="constant",
                      return_complex=True)
    mag = spec.real.square() + spec.imag.square() if power == 2.0 else spec.abs() ** power
    return torch.matmul(basis, mag)


def features64(y, window, mel_basis, chroma_basis, *, n_fft, hop):
    """(mfcc, chroma, centroid, roll-off bin) of one track in float64 numpy."""
    spec = spec64(y, window, n_fft=n_fft, hop=hop)
    mfcc = mfcc64(np.asarray(mel_basis, np.float64) @ spec**2)
    chroma = np.asarray(chroma_basis, np.float64) @ spec**2
    chroma = chroma / np.maximum(chroma.max(axis=0, keepdims=True), np.finfo(np.float32).tiny)
    freq = np.fft.rfftfreq(n_fft, 1.0 / SR)
    centroid = (freq[:, None] * spec).sum(axis=0, keepdims=True) / spec.sum(axis=0, keepdims=True)
    total = np.cumsum(spec, axis=0)
    roll_bin = (total < 0.85 * total[-1:]).sum(axis=0)  # the first bin at or above the threshold
    return mfcc, chroma, centroid, roll_bin


def feature_stack_phase(torch, L, device, y, win, mel_basis, k1_ms: float) -> dict:
    """Phase 4b: the feature stack driven, checked against float64 and timed; its launch counts."""
    from librosa_tpu_torch.core import spectrum
    from librosa_tpu_torch.entry import feature_stack
    from librosa_tpu_torch.feature import spectral
    from librosa_tpu_torch.ops import db_scale, fused_stft

    n_fft, hop = MAIN["n_fft"], MAIN["hop_length"]
    n_frames = 1 + MAIN_SHAPE[1] // hop
    forward, _ = feature_stack()
    fused_stft.launches = 0
    db_scale.launches = 0
    mfcc, chroma, centroid, rolloff = forward(y)
    torch.cuda.synchronize()
    counts = {"stft_mel": fused_stft.launches, "db_scale": db_scale.launches}
    print(f"feature stack: y {tuple(y.shape)} -> mfcc {tuple(mfcc.shape)}, chroma "
          f"{tuple(chroma.shape)}, centroid {tuple(centroid.shape)}, rolloff "
          f"{tuple(rolloff.shape)}; launches {counts}")
    if counts != {"stft_mel": 4, "db_scale": 1}:
        raise AssertionError(f"the feature stack launched {counts}, expected 4 and 1")
    for name, out, rows in (("mfcc", mfcc, 20), ("chroma", chroma, 12),
                            ("centroid", centroid, 1), ("rolloff", rolloff, 1)):
        if tuple(out.shape) != (MAIN_SHAPE[0], rows, n_frames):
            raise AssertionError(f"feature stack {name} shape {tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"feature stack {name} has non-finite values")

    chroma_basis = L.filters.chroma(sr=SR, n_fft=n_fft, tuning=0.0, n_chroma=12)
    bin_hz = SR / n_fft
    for track in (0, MAIN_SHAPE[0] - 1):
        want = features64(y[track].cpu().numpy(), win, mel_basis, chroma_basis, n_fft=n_fft,
                          hop=hop)
        snrs = [snr_db(got[track].cpu().numpy(), ref)
                for got, ref in zip((mfcc, chroma, centroid), want)]
        got_bin = np.rint(rolloff[track, 0].cpu().numpy().astype(np.float64) / bin_hz)
        off = np.abs(got_bin - want[3])
        equal = float((off == 0).mean())
        print(f"feature stack track {track} vs float64 numpy: mfcc {snrs[0]:.1f} dB, chroma "
              f"{snrs[1]:.1f} dB, centroid {snrs[2]:.1f} dB, rolloff on the float64 bin in "
              f"{100 * equal:.3f} % of {off.size} frames, at most {int(off.max())} bins off")
        for name, s, floor in zip(("mfcc", "chroma", "centroid"), snrs,
                                  (MIN_MFCC_SNR_DB, MIN_CHROMA_SNR_DB, MIN_CENTROID_SNR_DB)):
            if not s >= floor:
                raise AssertionError(f"feature stack {name}, track {track}: {s:.1f} dB < {floor}")
        if not (equal >= MIN_ROLLOFF_EQUAL and off.max() <= 1):
            raise AssertionError(f"feature stack rolloff, track {track}: {100 * equal:.3f} % "
                                 f"equal, {int(off.max())} bins off at most")
    del mfcc, chroma, centroid, rolloff

    # the mel kernel with its two other bases at the main shape, against their plain versions
    win_d = torch.from_numpy(win.astype(np.float32)).to(device)
    kw = dict(n_fft=n_fft, hop_length=hop, center=True, pad_mode="constant")
    chroma_d, chroma_bands = spectral._basis_device(
        L.filters.chroma, SR, n_fft, device, torch.float32, tuning=0.0, n_chroma=12)
    eye_d, eye_bands = spectrum._eye_device(n_fft, device)
    times = {}
    for label, basis, bands, power, floor, plain in (
        ("chroma", chroma_d, chroma_bands, 2.0, MIN_SNR_DB,
         lambda: fused_stft.stft_mel_reference(y, win_d, chroma_d, power=2.0, **kw)),
        ("identity", eye_d, eye_bands, 1.0, MIN_SNR_POWER1_DB,
         lambda: spectrum._stft_power_core(y, win_d, power=1.0, **kw)),
    ):
        poison(torch, (MAIN_SHAPE[0], basis.shape[0], n_frames), device)
        got = fused_stft._fused(y, win_d, basis, bands, power=power, **kw)
        want = plain()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"stft_mel with the {label} basis left values unwritten")
        err = (got - want).double().square().sum(dim=(-2, -1))
        sig = want.double().square().sum(dim=(-2, -1))
        worst = float((10 * torch.log10(sig / err.clamp(min=1e-300))).min())
        max_err = float((got - want).abs().max())
        del got, want, err, sig
        ms = time_ms(torch, lambda: fused_stft._fused(y, win_d, basis, bands, power=power,
                                                      **kw), 10)
        plain_ms = time_ms(torch, plain, 3)
        library_ms = time_ms(torch, lambda: stft_project(torch, y, win_d, basis, n_fft, hop,
                                                         power), 3)
        frames = MAIN_SHAPE[0] * n_frames
        out_bytes = 4 * basis.shape[0] * frames
        bytes_ms = 1e3 * (4 * y.numel() + out_bytes) / H100_HBM_BYTES_S
        ops_ms = 1e3 * (fused_stft.flops_per_frame(n_fft, int(torch.count_nonzero(basis)))
                        * frames / H100_F32_FLOP_S)
        times[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=max(bytes_ms, ops_ms),
                            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                            snr_db=worst, max_abs_err=max_err)
        print(f"stft_mel with the {label} basis ({basis.shape[0]} rows, power {power:g}) at the "
              f"main shape: {ms:.4f} ms, plain {plain_ms:.4f} ms, library (torch.stft, "
              f"|.|^{power:g}, exact-f32 torch.matmul) {library_ms:.4f} ms, bound "
              f"{max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f} ms with an output of "
              f"{out_bytes} bytes, operations {ops_ms:.4f} ms); per track at least "
              f"{worst:.1f} dB against plain (floor {floor}), max |err| {max_err:.3e}")
        if not worst >= floor:
            raise AssertionError(f"stft_mel with the {label} basis: {worst:.1f} dB < {floor}")

    # the tails alone, on the identity kernel's output
    S = fused_stft._fused(y, win_d, eye_d, eye_bands, power=1.0, **kw)
    freq = spectral._bin_frequencies(None, SR, n_fft, S)
    centroid_ms = time_ms(torch, lambda: spectral._centroid_core(S, freq), 3)
    rolloff_ms = time_ms(torch, lambda: spectral._rolloff_core(S, freq, roll_percent=0.85), 3)
    del S
    raw = fused_stft._fused(y, win_d, chroma_d, chroma_bands, power=2.0, **kw)
    norm_ms = time_ms(torch, lambda: L.util.normalize(raw, norm=np.inf, axis=-2), 5)
    del raw
    e2e_ms = time_ms(torch, lambda: forward(y), 3)
    parts = {"mfcc": lambda: L.feature.mfcc(y=y, sr=SR, n_mfcc=20, **MAIN),
             "chroma_stft": lambda: L.feature.chroma_stft(y=y, sr=SR, tuning=0.0, n_fft=n_fft,
                                                          hop_length=hop),
             "spectral_centroid": lambda: L.feature.spectral_centroid(y=y, sr=SR, n_fft=n_fft,
                                                                      hop_length=hop),
             "spectral_rolloff": lambda: L.feature.spectral_rolloff(y=y, sr=SR, n_fft=n_fft,
                                                                    hop_length=hop)}
    part_ms = {name: time_ms(torch, fn, 3) for name, fn in parts.items()}
    samples = MAIN_SHAPE[0] * MAIN_SHAPE[1]
    print(f"feature stack end to end: {e2e_ms:.4f} ms, {samples / (e2e_ms / 1e3):.6e} samples/s "
          f"on {MAIN_SHAPE}; its four calls alone: "
          + ", ".join(f"{name} {ms:.4f} ms" for name, ms in part_ms.items()))
    print(f"feature stack tails alone: centroid from |STFT| {centroid_ms:.4f} ms, rolloff from "
          f"|STFT| {rolloff_ms:.4f} ms, chroma normalisation {norm_ms:.4f} ms; stft_mel with "
          f"the mel basis {k1_ms:.4f} ms in this run")
    return {"launches": counts, "bases": times}


def snr_t(torch, got, want, mask=None) -> float:
    """SNR in dB of ``got`` against ``want``, both tensors on the card, summed in float64."""
    got, want = got.double(), want.double()
    if mask is not None:
        got, want = got[..., mask], want[..., mask]
    err = float((got - want).square().sum())
    return float(10 * np.log10(float(want.square().sum()) / max(err, 1e-300)))


def ola_cases():
    """(label, signal shape, stft kwargs, istft kwargs) for the synthesis kernel."""
    cases = []
    for n_fft in (512, 1024, 2048):
        n = 20 * n_fft + 77
        for hop, tag in ((n_fft // 4, "divides"), (441, "does not divide"), (n_fft, "equals")):
            for center in (True, False):
                cases.append((f"n_fft={n_fft} hop={hop} ({tag} n_fft) center={center}", (2, n),
                              dict(n_fft=n_fft, hop_length=hop, center=center),
                              dict(hop_length=hop, center=center)))
        hop = n_fft // 4
        for length, tag in ((n // 2, "shorter"), (n, "as long as the signal"),
                            (n + 3 * n_fft + 1, "longer")):
            cases.append((f"n_fft={n_fft} hop={hop} length={length} ({tag})", (3, n),
                          dict(n_fft=n_fft, hop_length=hop), dict(hop_length=hop, length=length)))
        cases.append((f"n_fft={n_fft} hop=441 length={n} uncentred", (2, n),
                      dict(n_fft=n_fft, hop_length=441, center=False),
                      dict(hop_length=441, center=False, length=n)))
    cases += [
        ("n_fft=1024 win_length=768 hamming", (2, 30000),
         dict(n_fft=1024, win_length=768, window="hamming"),
         dict(n_fft=1024, win_length=768, window="hamming", length=30000)),
        ("n_fft=512 hop=512 boxcar", (2, 20000), dict(n_fft=512, hop_length=512, window="boxcar"),
         dict(hop_length=512, window="boxcar")),
        ("one track", (40000,), dict(n_fft=2048, hop_length=512), dict(hop_length=512)),
        ("2 x 3 tracks", (2, 3, 25000), dict(n_fft=1024), dict(length=25000)),
        ("16 tracks", (16, 30000), dict(n_fft=2048, hop_length=512),
         dict(hop_length=512, length=30000)),
    ]
    return cases


def ola_inputs(torch, spectrum, D, istft_kw):
    """What ``istft(D, **istft_kw)`` hands its synthesis step: frames, window, envelope, hop, start.

    The float64 copies of window and envelope come with them.
    """
    window = istft_kw.get("window", "hann")
    n_fft, win_length, hop, n_frames, start, out_len = spectrum._istft_geometry(
        tuple(D.shape), n_fft=istft_kw.get("n_fft"), win_length=istft_kw.get("win_length"),
        hop_length=istft_kw.get("hop_length"), center=istft_kw.get("center", True),
        length=istft_kw.get("length"))
    frames = torch.fft.irfft(D[..., :n_frames].transpose(-2, -1), n=n_fft, dim=-1)
    tables = []
    for dtype in (torch.float32, torch.float64):
        tables.append(spectrum._win_device(window, win_length, n_fft, D.device, dtype))
        tables.append(spectrum._wss_device(window, n_frames=n_frames, win_length=win_length,
                                           n_fft=n_fft, hop_length=hop, start=start,
                                           out_len=out_len, device=D.device, dtype=dtype))
    return frames, tables, hop, start


def ola_kernel_phase(torch, L, rng, device) -> None:
    """Phase 4c: the synthesis kernel against its plain version and float64, and run twice."""
    from librosa_tpu_torch.core import spectrum
    from librosa_tpu_torch.ops import ola_norm

    cases = ola_cases()
    for label, shape, stft_kw, istft_kw in cases:
        y = torch.from_numpy((rng.randn(*shape) * 0.1).astype(np.float32)).to(device)
        D = L.stft(y, **stft_kw)
        frames, (win, wss, win64, wss64), hop, start = ola_inputs(torch, spectrum, D, istft_kw)
        before = ola_norm.launches
        poison(torch, (*D.shape[:-2], wss.shape[0]), device)
        got = L.istft(D, **istft_kw)
        if ola_norm.launches != before + 1:
            raise AssertionError(f"ola {label}: istft did not launch the ola_norm kernel")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"ola {label}: {int((~torch.isfinite(got)).sum())} of "
                                 f"{got.numel()} values unwritten or not finite")
        want = ola_norm.ola_norm_reference(frames, win, wss, hop_length=hop, start=start)
        again = ola_norm.ola_norm(frames, win, wss, hop_length=hop, start=start)
        want64 = ola_norm.ola_norm_reference(frames.double(), win64, wss64, hop_length=hop,
                                             start=start)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"ola {label}: two runs of the kernel differ")
        # Against float64, samples that only a window's skirt reaches (an envelope below a
        # thousandth of its peak) are left out: there the quotient is float32 rounding of
        # the frames over a vanishing window, in any float32 version.
        sound = (wss64 > 1e-3 * wss64.max()) | (wss64 == 0)
        s_plain, s64 = snr_t(torch, got, want), snr_t(torch, got, want64, sound)
        note = "bit-equal" if torch.equal(got, want) else "not bit-equal"
        # the launch's predicate for four samples a thread (torch's buffers are 16-byte aligned)
        vec = 4 if hop % 4 == 0 and frames.shape[-1] % 4 == 0 and start % 4 == 0 else 1
        print(f"ola kernel  {label} {tuple(frames.shape)} -> {tuple(got.shape)}, {vec} per "
              f"thread: vs plain {s_plain:.1f} dB ({note}), vs float64 {s64:.1f} dB on "
              f"{int(sound.sum())} of {sound.numel()} samples, second run bit-equal")
        if not s_plain >= MIN_OLA_PLAIN_SNR_DB:
            raise AssertionError(f"ola {label}: {s_plain:.1f} dB vs plain < "
                                 f"{MIN_OLA_PLAIN_SNR_DB}")
        if not s64 >= MIN_OLA_F64_SNR_DB:
            raise AssertionError(f"ola {label}: {s64:.1f} dB vs float64 < {MIN_OLA_F64_SNR_DB}")
    print(f"ola kernel vs plain and float64: {len(cases)} cases passed, each on NaN-filled "
          f"memory and run twice")


def istft64(D, window, *, n_fft, hop, length):
    """Centred inverse STFT in float64 numpy, to ``length`` samples."""
    frames = np.fft.irfft(D.T, n=n_fft, axis=-1) * window
    full = np.zeros(n_fft + hop * (len(frames) - 1))
    wss = np.zeros_like(full)
    for t, frame in enumerate(frames):
        full[t * hop:t * hop + n_fft] += frame
        wss[t * hop:t * hop + n_fft] += window**2
    y = np.zeros(length)
    w = np.zeros(length)
    take = min(length, len(full) - n_fft // 2)
    y[:take] = full[n_fft // 2:n_fft // 2 + take]
    w[:take] = wss[n_fft // 2:n_fft // 2 + take]
    good = w > np.finfo(np.float32).tiny
    return np.where(good, y / np.where(good, w, 1.0), y)


def griffinlim64(S, window, *, n_iter, n_fft, hop, length, momentum=0.99):
    """Griffin-Lim from zero phase in float64 numpy: the recurrence of ``griffinlim``."""
    S = np.asarray(S, dtype=np.float64)
    eps = np.finfo(np.float32).tiny
    angles = np.ones_like(S, dtype=np.complex128)
    rebuilt = np.zeros_like(angles)
    for _ in range(n_iter):
        tprev = rebuilt
        rebuilt = stft64(istft64(S * angles, window, n_fft=n_fft, hop=hop, length=length),
                         window, n_fft=n_fft, hop=hop)
        angles = rebuilt - (momentum / (1 + momentum)) * tprev
        angles = angles / (np.abs(angles) + eps)
    return istft64(S * angles, window, n_fft=n_fft, hop=hop, length=length)


def reconstruction_phase(torch, L, device, y, win) -> dict:
    """Phase 4d: config 3 driven, checked and timed; launch counts and the ola_norm entry."""
    import scipy.signal
    import torch.nn.functional as F

    from librosa_tpu_torch.core import spectrum
    from librosa_tpu_torch.entry import reconstruction
    from librosa_tpu_torch.ops import db_scale, fused_stft, ola_norm

    n_fft, hop = RECON["n_fft"], RECON["hop_length"]
    win64 = np.asarray(win, dtype=np.float64)
    forward, _ = reconstruction()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    fused_stft.launches = 0
    db_scale.launches = 0
    ola_norm.launches = 0
    y16k, y_hat = forward(y)
    torch.cuda.synchronize()
    counts = {"stft_mel": fused_stft.launches, "db_scale": db_scale.launches,
              "ola_norm": ola_norm.launches}
    peak_bytes = torch.cuda.max_memory_allocated()
    n16 = y16k.shape[-1]
    n_frames = 1 + n16 // hop
    print(f"reconstruction: y {tuple(y.shape)} -> y16k {tuple(y16k.shape)} -> y_hat "
          f"{tuple(y_hat.shape)} over {n_frames} frames, 32 rounds; launches {counts}; peak "
          f"memory {peak_bytes} bytes, {peak_bytes - base_bytes} above the {base_bytes} held "
          f"before the call")
    if counts != {"stft_mel": 1, "db_scale": 0, "ola_norm": 33}:
        raise AssertionError(f"reconstruction launched {counts}, expected 1, 0 and 33")
    want_n = -(-MAIN_SHAPE[1] * 320 // 441)
    if tuple(y16k.shape) != (MAIN_SHAPE[0], want_n) or tuple(y_hat.shape) != tuple(y16k.shape):
        raise AssertionError(f"reconstruction shapes {tuple(y16k.shape)}, {tuple(y_hat.shape)}")
    if not (torch.isfinite(y16k).all() and torch.isfinite(y_hat).all()):
        raise AssertionError("non-finite values on the reconstruction path")

    # resample against scipy in float64
    for track in (0, MAIN_SHAPE[0] - 1):
        want = scipy.signal.resample_poly(y[track].cpu().numpy().astype(np.float64), 320, 441)
        s = snr_db(y16k[track].cpu().numpy(), want)
        print(f"resample 22050 -> 16000 track {track} vs float64 scipy resample_poly: {s:.1f} dB")
        if not s >= MIN_RESAMPLE_SNR_DB:
            raise AssertionError(f"resample track {track}: {s:.1f} dB < {MIN_RESAMPLE_SNR_DB}")

    # istft(stft(y)) is y
    D = L.stft(y16k, **RECON)
    back = L.istft(D, hop_length=hop, length=n16)
    err = (back - y16k).double().square().sum(dim=-1)
    trip = 10 * torch.log10(y16k.double().square().sum(dim=-1) / err.clamp(min=1e-300))
    print(f"istft(stft(y16k)) vs y16k, per track: min {float(trip.min()):.1f} dB, max "
          f"{float(trip.max()):.1f} dB")
    if not float(trip.min()) >= MIN_ROUNDTRIP_SNR_DB:
        raise AssertionError(f"round trip {float(trip.min()):.1f} dB < {MIN_ROUNDTRIP_SNR_DB}")
    del back, err

    # the stft_mel kernel (identity basis, power 1) as this path calls it: rows of n16 floats,
    # so every odd track starts 8 bytes off a 16-byte boundary, and one frame past a multiple
    # of the kernel's frame tile; against its plain version and against float64
    win_d = spectrum._win_device("hann", n_fft, n_fft, device, torch.float32)
    poison(torch, (MAIN_SHAPE[0], 1 + n_fft // 2, n_frames), device)
    before = fused_stft.launches
    S, _ = spectrum._spectrogram(y=y16k, power=1, **RECON)
    if fused_stft.launches != before + 1:
        raise AssertionError("_spectrogram on the resampled batch did not launch stft_mel")
    if tuple(S.shape) != (MAIN_SHAPE[0], 1 + n_fft // 2, n_frames):
        raise AssertionError(f"|STFT| of the resampled batch has shape {tuple(S.shape)}")
    if not bool(torch.isfinite(S).all()):
        raise AssertionError("stft_mel on the resampled batch left values unwritten")
    plain = spectrum._stft_power_core(y16k, win_d, power=1.0, center=True, pad_mode="constant",
                                      **RECON)
    err = (S - plain).double().square().sum(dim=(-2, -1))
    sig = plain.double().square().sum(dim=(-2, -1))
    k1_tracks = 10 * torch.log10(sig / err.clamp(min=1e-300))
    k1_last = snr_t(torch, S[..., -1], plain[..., -1])
    k1_max_err = float((S - plain).abs().max())
    del plain, err, sig
    k1_f64 = [snr_db(S[track].cpu().numpy(),
                     spec64(y16k[track].cpu().numpy(), win64, n_fft=n_fft, hop=hop))
              for track in (0, 1, MAIN_SHAPE[0] - 1)]
    print(f"stft_mel (identity basis, power 1) on y16k {tuple(y16k.shape)} -> {tuple(S.shape)}, "
          f"{n_frames % 8} frame(s) past a multiple of 8, the kernel's rows {4 * n16} bytes "
          f"({4 * n16 % 16} past a 16-byte boundary; y16k itself has a row stride of "
          f"{4 * y16k.stride(0)} bytes and is made contiguous for the kernel): per track vs plain min "
          f"{float(k1_tracks.min()):.1f} dB (even tracks {float(k1_tracks[0::2].min()):.1f}, odd "
          f"tracks {float(k1_tracks[1::2].min()):.1f}), last frame {k1_last:.1f} dB, max |err| "
          f"{k1_max_err:.3e}; tracks 0, 1, 15 vs float64 numpy "
          + ", ".join(f"{s:.1f}" for s in k1_f64) + f" dB (floor {MIN_SNR_POWER1_DB})")
    if not (float(k1_tracks.min()) >= MIN_SNR_POWER1_DB and k1_last >= MIN_SNR_POWER1_DB
            and min(k1_f64) >= MIN_SNR_POWER1_DB):
        raise AssertionError(f"stft_mel on the resampled batch: {float(k1_tracks.min()):.1f} dB "
                             f"vs plain, last frame {k1_last:.1f} dB, vs float64 {k1_f64}")

    # four rounds from zero phase on one track against the float64 loop
    got = L.griffinlim(S[0], n_iter=4, init=None, length=n16, **RECON)
    want = griffinlim64(S[0].cpu().numpy(), win64, n_iter=4, n_fft=n_fft, hop=hop, length=n16)
    gl_snr = snr_db(got.cpu().numpy(), want)
    print(f"griffinlim init=None, 4 rounds, track 0 vs a float64 numpy loop: {gl_snr:.1f} dB")
    if not gl_snr >= MIN_GL_SNR_DB:
        raise AssertionError(f"griffinlim vs float64: {gl_snr:.1f} dB < {MIN_GL_SNR_DB}")

    # random phases: what the function promises
    def convergence(signal):
        rebuilt, _ = spectrum._spectrogram(y=signal, power=1, **RECON)
        return float(torch.linalg.vector_norm(rebuilt - S) / torch.linalg.vector_norm(S))

    conv32 = convergence(y_hat)
    y_hat4 = L.griffinlim(S, n_iter=4, rng=0, length=n16, **RECON)
    conv4 = convergence(y_hat4)
    conv0 = convergence(L.griffinlim(S, n_iter=0, rng=0, length=n16, **RECON))
    del y_hat4
    print(f"griffinlim init='random' spectral convergence || |stft(y_hat)| - S || / || S ||: "
          f"{conv0:.6f} after 0 rounds, {conv4:.6f} after 4, {conv32:.6f} after 32 "
          f"(limit {MAX_CONVERGENCE_32})")
    if not (conv32 < MAX_CONVERGENCE_32 and conv32 < conv4 < conv0):
        raise AssertionError(f"griffinlim convergence {conv0:.4f}, {conv4:.4f}, {conv32:.4f}")
    again = forward(y)[1]
    if not torch.equal(again, y_hat):
        raise AssertionError("the same seed gave two different reconstructions")
    print("reconstruction with the same seed twice: bit-equal")
    del again, y_hat

    # the synthesis kernel at the path's shape, against its plain version
    frames, (win_d, wss, _, _), _, start = ola_inputs(torch, spectrum, D,
                                                     dict(hop_length=hop, length=n16))
    poison(torch, (MAIN_SHAPE[0], n16), device)
    k_out = ola_norm.ola_norm(frames, win_d, wss, hop_length=hop, start=start)
    p_out = ola_norm.ola_norm_reference(frames, win_d, wss, hop_length=hop, start=start)
    if not bool(torch.isfinite(k_out).all()):
        raise AssertionError("ola_norm at the path's shape left values unwritten")
    max_abs_err = float((k_out - p_out).abs().max())
    ola_snr = snr_t(torch, k_out, p_out)
    print(f"ola_norm vs plain at the path's shape {tuple(frames.shape)} -> {tuple(k_out.shape)}: "
          f"{ola_snr:.1f} dB, max |err| {max_abs_err:.3e} "
          f"({'bit-equal' if torch.equal(k_out, p_out) else 'not bit-equal'})")
    if not ola_snr >= MIN_OLA_PLAIN_SNR_DB:
        raise AssertionError(f"ola_norm at the path's shape: {ola_snr:.1f} dB")
    del k_out, p_out

    # times
    ola_ms = time_ms(torch, lambda: ola_norm.ola_norm(frames, win_d, wss, hop_length=hop,
                                                      start=start), 10)
    plain_ms = time_ms(torch, lambda: ola_norm.ola_norm_reference(frames, win_d, wss,
                                                                 hop_length=hop, start=start), 3)
    # yardstick for the overlap-add alone: F.fold of frames already windowed and transposed
    columns = (frames * win_d).transpose(-2, -1).contiguous()
    full_len = n_fft + hop * (frames.shape[-2] - 1)
    fold_ms = time_ms(torch, lambda: F.fold(columns, (1, full_len), (1, n_fft),
                                            stride=(1, hop)), 3)
    del columns
    bound_bytes = 4 * (frames.numel() + win_d.numel() + wss.numel() + MAIN_SHAPE[0] * n16)
    bound_ms = 1e3 * bound_bytes / H100_HBM_BYTES_S
    del frames
    irfft_ms = time_ms(torch, lambda: torch.fft.irfft(D.transpose(-2, -1), n=n_fft, dim=-1), 5)
    istft_ms = time_ms(torch, lambda: L.istft(D, hop_length=hop, length=n16), 5)
    stft_ms = time_ms(torch, lambda: L.stft(y16k, **RECON), 5)
    # as inside griffinlim: every operand in stft's time-major layout
    estimate, tprev = D.clone(), D * 0.5
    S_tm = S.transpose(-2, -1).contiguous().transpose(-2, -1)
    update_ms = time_ms(torch, lambda: spectrum._phase_update(estimate, D, tprev, S_tm,
                                                              0.99 / 1.99), 5)
    del estimate, tprev, D, S_tm
    resample_ms = time_ms(torch, lambda: L.resample(y, orig_sr=SR, target_sr=RECON_SR,
                                                    res_type="polyphase"), 5)
    spec_ms = time_ms(torch, lambda: spectrum._spectrogram(y=y16k, power=1, **RECON), 5)
    gl_ms = time_ms(torch, lambda: L.griffinlim(S, n_iter=32, rng=0, length=n16, **RECON), 1,
                    groups=2)
    del S
    e2e_ms = time_ms(torch, lambda: forward(y), 1, groups=2)
    samples = MAIN_SHAPE[0] * MAIN_SHAPE[1]
    print(f"reconstruction end to end: {e2e_ms:.4f} ms, {samples / (e2e_ms / 1e3):.6e} input "
          f"samples/s on {MAIN_SHAPE}; alone: resample {resample_ms:.4f} ms, |STFT| by the "
          f"stft_mel kernel {spec_ms:.4f} ms, griffinlim (32 rounds) {gl_ms:.4f} ms")
    print(f"one round's parts at {tuple(y16k.shape)}: istft {istft_ms:.4f} ms (irfft "
          f"{irfft_ms:.4f} ms + ola_norm {ola_ms:.4f} ms), stft {stft_ms:.4f} ms, phase update "
          f"{update_ms:.4f} ms")
    print(f"ola_norm kernel {ola_ms:.4f} ms, plain torch ops {plain_ms:.4f} ms, F.fold of "
          f"windowed, transposed frames (the overlap-add alone) {fold_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms (bytes: {bound_bytes} read and written once)")
    entry = {
        "name": "ola_norm",
        "route": "cuda",
        "source": "librosa_tpu_torch/csrc/ola_norm.cu",
        "replaces": "librosa_tpu/core/spectrum.py:304 _istft_core, lines 304-318 (the tail of "
                    "an XLA program: no Pallas kernel computes this step)",
        "launches": counts["ola_norm"],
        "launches_by_path": {"mel_db_mfcc": 0, "feature_stack": 0,
                             "reconstruction": counts["ola_norm"]},
        "max_abs_err": max_abs_err,
        "ms": ola_ms,
        "kernel_ms": ola_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "fold_overlap_add_only_ms": fold_ms,
        "snr_db": ola_snr,
    }
    k1 = {"shape": [MAIN_SHAPE[0], n16], "snr_db": float(k1_tracks.min()),
          "last_frame_snr_db": k1_last, "max_abs_err": k1_max_err, "float64_snr_db": min(k1_f64)}
    return {"launches": counts, "ola_norm": entry, "stft_mel": k1, "e2e_ms": e2e_ms}


def tuning64(S, *, sr, n_fft, fmin=150.0, fmax=4000.0, threshold=0.1, bins_per_octave=12,
             resolution=TUNING_RESOLUTION):
    """estimate_tuning of magnitudes ``S`` (tracks, bins, T) in float64 numpy."""
    S = np.abs(np.asarray(S, dtype=np.float64))
    avg = np.gradient(S, axis=-2)
    a = S[:, 2:] + S[:, :-2] - 2 * S[:, 1:-1]
    b = (S[:, 2:] - S[:, :-2]) / 2
    shift = np.zeros_like(S)
    shift[:, 1:-1] = np.where(np.abs(b) >= np.abs(a), 0.0, -b / np.where(a == 0, 1.0, a))
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)[None, :, None]
    masked = S * (S > threshold * S.max(axis=-2, keepdims=True))
    peak = np.zeros(S.shape, dtype=bool)
    peak[:, 1:-1] = (masked[:, 1:-1] > masked[:, :-2]) & (masked[:, 1:-1] >= masked[:, 2:])
    peak[:, -1] = masked[:, -1] > masked[:, -2]
    peak &= (fmin <= freqs) & (freqs < fmax)
    pitch = np.where(peak, (np.arange(S.shape[-2])[None, :, None] + shift) * sr / n_fft, 0.0)
    mag = np.where(peak, S + 0.5 * avg * shift, 0.0)
    keep = pitch > 0
    keep &= mag >= np.median(mag[keep])
    frac = np.mod(bins_per_octave * np.log2(pitch[keep] / 27.5), 1.0)
    frac = np.where(frac >= 0.5, frac - 1.0, frac)
    cells = np.linspace(-0.5, 0.5, int(np.ceil(1.0 / resolution)) + 1)
    votes = np.histogram(frac, bins=cells)[0]
    return float(cells[int(np.argmax(votes))])


def tuning_phase(torch, L, device, y, win) -> dict:
    """Phase 4e: estimate_tuning against float64 on tones; chroma_stft with the default tuning."""
    from librosa_tpu_torch.core import spectrum
    from librosa_tpu_torch.ops import fused_stft

    n_fft, hop = MAIN["n_fft"], MAIN["hop_length"]
    # 16 tracks of a harmonic tone each, a semitone apart, all 0.23 semitones sharp
    detune, n = 0.23, 1 << 18
    t = torch.arange(n, device=device, dtype=torch.float64) / SR
    f0 = 220.0 * 2.0 ** ((torch.arange(16, device=device, dtype=torch.float64) + detune) / 12)
    tones = sum(torch.sin(2 * np.pi * (k + 1) * f0[:, None] * t) / (k + 1) for k in range(4))
    gen = torch.Generator(device=device).manual_seed(2)
    tones = (0.3 * tones).float() + 0.003 * torch.randn((16, n), generator=gen, device=device)
    got = L.estimate_tuning(y=tones, sr=SR)
    spec = np.stack([spec64(track, win, n_fft=n_fft, hop=hop) for track in tones.cpu().numpy()])
    want = tuning64(spec, sr=SR, n_fft=n_fft)
    print(f"estimate_tuning on 16 tones {detune} semitones sharp: {got:+.2f}, float64 numpy "
          f"{want:+.2f}")
    if not (abs(got - want) <= TUNING_RESOLUTION + 1e-9 and abs(got - detune) <= 0.03):
        raise AssertionError(f"estimate_tuning {got} against float64 {want}, tones at {detune}")
    # a callable ref other than a maximum: a reduction on the card, never a host copy. np.mean
    # and np.sum run as torch's reductions (as the JAX function runs them under jit), torch.mean
    # as it is; np.median, which the JAX function cannot trace, raises
    S_t = L.stft(tones[:2], n_fft=n_fft, hop_length=hop).abs()
    agree = {}
    for name, card_ref, host_ref in (("np.mean", np.mean, np.mean), ("np.sum", np.sum, np.sum),
                                     ("torch.mean", torch.mean, np.mean)):
        p_card, m_card = L.piptrack(S=S_t, sr=SR, ref=card_ref)
        p_host, m_host = L.piptrack(S=S_t.cpu(), sr=SR, ref=host_ref)
        if not p_card.is_cuda:
            raise AssertionError(f"piptrack ref={name} left the card")
        agree[name] = float(((p_card > 0).cpu() == (p_host > 0)).double().mean())
        del p_card, m_card, p_host, m_host
    try:
        L.piptrack(S=S_t, sr=SR, ref=np.median)
    except L.ParameterError:
        refused = True
    else:
        refused = False
    print("piptrack on the card against the CPU run, same magnitudes, peaks that agree: "
          + ", ".join(f"ref={k} {100 * v:.4f} %" for k, v in agree.items())
          + f" of {S_t.numel()} cells; ref=np.median on a CUDA tensor "
          + ("raises ParameterError" if refused else "does not raise"))
    if not (min(agree.values()) >= 0.9999 and refused):
        raise AssertionError(f"piptrack with a callable ref: agreement {agree}, "
                             f"refused={refused}")
    del tones, spec, S_t

    # chroma_stft with the default tuning on the main buffer, against float64 at that tuning
    fused_stft.launches = 0
    chroma = L.feature.chroma_stft(y=y, sr=SR, n_fft=n_fft, hop_length=hop)
    torch.cuda.synchronize()
    launches = fused_stft.launches
    S, _ = spectrum._spectrogram(y=y, power=2, n_fft=n_fft, hop_length=hop)
    tuning = L.estimate_tuning(S=S, sr=SR, bins_per_octave=12)
    del S
    n_frames = 1 + MAIN_SHAPE[1] // hop
    if tuple(chroma.shape) != (MAIN_SHAPE[0], 12, n_frames) or launches != 1:
        raise AssertionError(f"chroma_stft default tuning: shape {tuple(chroma.shape)}, "
                             f"{launches} stft_mel launches")
    basis = np.asarray(L.filters.chroma(sr=SR, n_fft=n_fft, tuning=tuning), np.float64)
    for track in (0, MAIN_SHAPE[0] - 1):
        ref = basis @ spec64(y[track].cpu().numpy(), win, n_fft=n_fft, hop=hop) ** 2
        ref = ref / np.maximum(ref.max(axis=0, keepdims=True), np.finfo(np.float32).tiny)
        s = snr_db(chroma[track].cpu().numpy(), ref)
        print(f"chroma_stft with the estimated tuning {tuning:+.2f}, track {track} vs float64 "
              f"numpy at that tuning: {s:.1f} dB")
        if not s >= MIN_CHROMA_SNR_DB:
            raise AssertionError(f"chroma_stft default tuning, track {track}: {s:.1f} dB")
    del chroma
    tuning_ms = time_ms(torch, lambda: L.estimate_tuning(y=y, sr=SR), 1, groups=2)
    S, _ = spectrum._spectrogram(y=y, power=1, n_fft=n_fft, hop_length=hop)
    piptrack_ms = time_ms(torch, lambda: L.piptrack(S=S, sr=SR), 1, groups=2)
    from_S_ms = time_ms(torch, lambda: L.estimate_tuning(S=S, sr=SR), 1, groups=2)
    pitch, mag = L.piptrack(S=S, sr=SR)
    del S
    voiced = int((pitch > 0).sum())
    vote_ms = time_ms(torch, lambda: L.pitch_tuning(pitch), 1, groups=2)
    del pitch, mag
    chroma_ms = time_ms(torch, lambda: L.feature.chroma_stft(y=y, sr=SR, n_fft=n_fft,
                                                             hop_length=hop), 1, groups=2)
    print(f"estimate_tuning from y on {MAIN_SHAPE}: {tuning_ms:.4f} ms; from the magnitude "
          f"{from_S_ms:.4f} ms, of which piptrack {piptrack_ms:.4f} ms ({voiced} peaks of "
          f"{MAIN_SHAPE[0] * 1025 * n_frames} cells) and pitch_tuning over all cells "
          f"{vote_ms:.4f} ms; chroma_stft with the default tuning: {chroma_ms:.4f} ms (one "
          f"stft_mel launch, identity basis)")
    return {"tuning_ms": tuning_ms, "chroma_ms": chroma_ms}


# ---------------------------------------------------------------------------
# 4f, 4g: the sliding median kernel, and config 4 (constant-Q transform and HPSS)
# ---------------------------------------------------------------------------

# outputs that share one sorted core in csrc/median_select.cuh:group_size, for the sizes of
# median_cases' axis lengths around the group
MEDIAN_GROUP = {2: 1, 3: 1, 5: 4, 8: 4, 9: 4, 16: 8, 17: 8, 31: 16, 32: 16, 33: 16, 48: 16,
                63: 32, 64: 32}


def median_bit_equal(torch, got, want) -> bool:
    """NaN at the same places and the same bits everywhere else."""
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    if not torch.equal(nan_g, nan_w):
        return False
    return torch.equal(got.masked_fill(nan_g, 0.0).view(torch.int32),
                       want.masked_fill(nan_w, 0.0).view(torch.int32))


def median_cases(torch, rng, device):
    """(label, x, size, axis): every window width the kernel instantiates, both axes, both
    layouts, axes shorter than half the window, NaN, infinities, zeros of both signs, ties."""
    cases = []
    for shape in ((3, 5), (2, 40, 150), (33, 7), (2, 3, 300, 129)):
        base = rng.randn(*shape).astype(np.float32)
        flat = base.reshape(-1)
        flat[::7] = np.round(flat[::7])
        flat[3], flat[5], flat[6], flat[-2] = np.nan, np.inf, -np.inf, np.nan
        flat[9], flat[10] = -0.0, 0.0
        if flat.size > 200:
            flat[100:120] = np.nan  # a run of NaN longer than half of most windows
        x = torch.from_numpy(base).to(device)
        time_major = x.transpose(-1, -2).contiguous().transpose(-1, -2)
        for size in (2, 3, 4, 5, 17, 31, 32, 33, 64):
            for axis in (-1, -2):
                cases.append((f"{shape} size {size} axis {axis}", x, size, axis))
                cases.append((f"{shape} size {size} axis {axis} time-major", time_major, size,
                              axis))
    # axis lengths around the window, the kernel's group of outputs and its run of 32 (those of
    # tests/test_torch_median_select.py), both axes, and the main path's 1025 and 8193 on a row
    def hard(*shape):
        x = rng.randn(*shape).astype(np.float32)
        flat = x.reshape(-1)
        flat[::7] = np.round(flat[::7])
        flat[::13] = np.nan
        flat[1::17] = -0.0
        flat[2::19] = np.inf
        return torch.from_numpy(x).to(device)

    for size, k in MEDIAN_GROUP.items():
        for n in sorted({n for n in (1, 2, size - 1, size, size + 1, k - 1, k, k + 1, 31, 32, 33)
                         if n >= 1}):
            cases.append((f"size {size} (group {k}), {n} along axis -1", hard(3, n), size, -1))
            cases.append((f"size {size} (group {k}), {n} along axis -2", hard(n, 3), size, -2))
        for n in (1025, 8193):
            cases.append((f"size {size}, one row of {n}", hard(1, n), size, -1))
    x = torch.from_numpy(rng.randn(4, 6, 50, 40).astype(np.float32)).to(device)
    cases.append(("(6, 4, 50, 40) leading dims that do not fold (copied)", x.transpose(0, 1), 31,
                  -1))
    cases.append(("1-d, 1000 samples", torch.from_numpy(rng.randn(1000).astype(np.float32))
                  .to(device), 31, -1))
    cases.append(("a column slice (not dense)", x[..., ::2], 9, -2))
    return cases


def median_kernel_phase(torch, L, rng, device) -> None:
    """Phase 4f: the median kernel against its plain version, bit for bit, in small cases."""
    from librosa_tpu_torch.ops import median

    cases = median_cases(torch, rng, device)
    copies = median.copies
    for label, x, size, axis in cases:
        before = median.launches
        poison(torch, tuple(x.shape), device)
        got = median.median_filter_1d(x, size=size, axis=axis)
        want = median.median_filter_reference(x, size=size, axis=axis)
        torch.cuda.synchronize()
        if median.launches != before + 1:
            raise AssertionError(f"median {label}: the kernel was not launched")
        if not median_bit_equal(torch, got, want):
            bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            raise AssertionError(f"median {label}: {bad} of {got.numel()} values differ from "
                                 "the plain version")
        if x.is_contiguous() or x.transpose(-1, -2).is_contiguous():
            if got.stride() != x.stride():
                raise AssertionError(f"median {label}: output strides {got.stride()} against "
                                     f"the input's {x.stride()}")
    if median.copies != copies + 1:
        raise AssertionError(f"median: {median.copies - copies} copies, expected 1")
    if L.decompose._median(cases[0][1], 1, -1) is not cases[0][1]:
        raise AssertionError("median of size 1 is not its input")
    print(f"median kernel vs plain: {len(cases)} cases bit-equal (NaN where the plain version "
          f"has NaN), each on NaN-filled memory; sizes 2-64, both axes, both layouts, axis "
          f"lengths around the window, the group and the run, 1025 and 8193; the output in the "
          f"input's layout; one input copied for leading dims that do not fold")


def hpss64(y, window, *, n_fft, hop, kernel=31):
    """effects.hpss of one track in float64 numpy and scipy (median_filter, mode 'reflect')."""
    import scipy.ndimage

    D = stft64(y, window, n_fft=n_fft, hop=hop)
    S = np.abs(D)
    phase = np.where(S == 0, 1.0, D / np.where(S == 0, 1.0, S))
    harm = scipy.ndimage.median_filter(S, size=(1, kernel), mode="reflect")
    perc = scipy.ndimage.median_filter(S, size=(kernel, 1), mode="reflect")
    big = np.maximum(harm, perc)
    empty = big < np.finfo(np.float64).tiny
    scale = np.where(empty, 1.0, big)
    h2, p2 = (harm / scale) ** 2, (perc / scale) ** 2
    mask_h = np.where(empty, 0.5, h2 / np.where(empty, 1.0, h2 + p2))
    mask_p = np.where(empty, 0.5, p2 / np.where(empty, 1.0, h2 + p2))
    return tuple(istft64(S * m * phase, window, n_fft=n_fft, hop=hop, length=len(y))
                 for m in (mask_h, mask_p))


def cqt_hpss_phase(torch, L, device, y, win) -> dict:
    """Phase 4g: config 4 (entry.cqt_hpss) driven, checked and timed; the median kernel at the
    path's full width against its plain version; K1 with the pseudo-CQT basis."""
    from librosa_tpu_torch.core import constantq, spectrum
    from librosa_tpu_torch.entry import cqt_hpss
    from librosa_tpu_torch.ops import db_scale, fused_stft, median, ola_norm

    n_fft, hop = 2048, 512
    forward, _ = cqt_hpss()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    fused_stft.launches = db_scale.launches = ola_norm.launches = median.launches = 0
    copies = median.copies
    C, y_harm, y_perc = forward(y)
    torch.cuda.synchronize()
    counts = {"stft_mel": fused_stft.launches, "db_scale": db_scale.launches,
              "ola_norm": ola_norm.launches, "median_filter": median.launches}
    if median.copies != copies:
        raise AssertionError("the median wrapper copied its input on the cqt_hpss path")
    peak_bytes = torch.cuda.max_memory_allocated()
    n_frames = 1 + MAIN_SHAPE[1] // hop
    print(f"cqt_hpss: y {tuple(y.shape)} -> C {tuple(C.shape)} {C.dtype}, y_harm "
          f"{tuple(y_harm.shape)}, y_perc {tuple(y_perc.shape)}; launches {counts}; peak memory "
          f"{peak_bytes} bytes, {peak_bytes - base_bytes} above the {base_bytes} held before")
    if counts != {"stft_mel": 0, "db_scale": 0, "ola_norm": 2, "median_filter": 2}:
        raise AssertionError(f"cqt_hpss launched {counts}, expected median_filter 2, ola_norm 2")
    if (tuple(C.shape) != (MAIN_SHAPE[0], 84, n_frames) or C.dtype != torch.complex64
            or tuple(y_harm.shape) != MAIN_SHAPE or tuple(y_perc.shape) != MAIN_SHAPE):
        raise AssertionError(f"cqt_hpss shapes {tuple(C.shape)}, {tuple(y_harm.shape)}")
    if not (torch.isfinite(torch.view_as_real(C)).all() and torch.isfinite(y_harm).all()
            and torch.isfinite(y_perc).all()):
        raise AssertionError("non-finite values on the cqt_hpss path")

    # the octave plan, as the ladder runs it
    cq = dict(sr=SR, hop_length=hop, n_bins=84, bins_per_octave=12)
    freqs, alpha, _, _ = constantq._grid(sr=SR, fmin=None, n_bins=84, intervals="equal",
                                         bins_per_octave=12, tuning=0.0, window="hann",
                                         filter_scale=1, gamma=0)
    plan = []
    for rate, rung_hop, bins in constantq._ladder_plan(SR, hop, freqs, 12, 7):
        _, rung_fft, _ = constantq._filters_fft(rate, freqs[bins], 1, 1, 0.01, window="hann",
                                                gamma=0, alpha=alpha[bins])
        plan.append((rate, rung_hop, rung_fft))
    print("cqt octave plan, top octave first (rate Hz, hop, n_fft): "
          + ", ".join(f"({r:g}, {h}, {f})" for r, h, f in plan))

    # cqt of track 0 against the port's own CPU run of the same call in float64
    C64 = L.cqt(y[0].cpu().double(), res_type="polyphase", **cq)
    got0, want0 = C[0].cpu().numpy(), C64.numpy()
    cqt_snr = float(10 * np.log10(np.sum(np.abs(want0) ** 2) / np.sum(np.abs(got0 - want0) ** 2)))
    print(f"cqt track 0 vs the port's float64 CPU run: {cqt_snr:.1f} dB (floor {MIN_CQT_SNR_DB})")
    if not cqt_snr >= MIN_CQT_SNR_DB:
        raise AssertionError(f"cqt vs float64: {cqt_snr:.1f} dB < {MIN_CQT_SNR_DB}")
    del C64

    # effects.hpss of tracks 0 and 15 against float64 numpy and scipy
    for track in (0, MAIN_SHAPE[0] - 1):
        want_h, want_p = hpss64(y[track].cpu().numpy(), win, n_fft=n_fft, hop=hop)
        s_h = snr_db(y_harm[track].cpu().numpy(), want_h)
        s_p = snr_db(y_perc[track].cpu().numpy(), want_p)
        print(f"effects.hpss track {track} vs float64 numpy/scipy: harmonic {s_h:.1f} dB, "
              f"percussive {s_p:.1f} dB (floor {MIN_HPSS_SNR_DB})")
        if not (s_h >= MIN_HPSS_SNR_DB and s_p >= MIN_HPSS_SNR_DB):
            raise AssertionError(f"effects.hpss track {track}: {s_h:.1f}, {s_p:.1f} dB")
    del C, y_harm, y_perc

    # the median kernel at the path's full width: |STFT| in stft's layout, both axes, track by
    # track against the plain version (whose window stack is paid for one track at a time)
    S = L.stft(y, n_fft=n_fft, hop_length=hop).abs()
    entry = {}
    for axis, name in ((-1, "harmonic (time)"), (-2, "percussive (frequency)")):
        poison(torch, tuple(S.shape), device)
        got = median.median_filter_1d(S, size=31, axis=axis)
        torch.cuda.synchronize()
        for track in range(MAIN_SHAPE[0]):
            want = median.median_filter_reference(S[track], size=31, axis=axis)
            if not median_bit_equal(torch, got[track], want):
                raise AssertionError(f"median at full width, {name}, track {track}: not "
                                     "bit-equal to the plain version")
        del got, want
        kernel_ms = time_ms(torch, lambda: median.median_filter_1d(S, size=31, axis=axis), 10)

        def plain():
            for track in range(MAIN_SHAPE[0]):
                median.median_filter_reference(S[track], size=31, axis=axis)

        plain_ms = time_ms(torch, plain, 1, groups=1)
        windows = L.util.pad_center(S, size=S.shape[axis] + 30, axis=axis,
                                    mode="symmetric").movedim(axis, -1).unfold(-1, 31, 1)

        def library():
            for track in range(MAIN_SHAPE[0]):
                torch.median(windows[track], dim=-1)

        library_ms = time_ms(torch, library, 1, groups=1)
        del windows
        bound_bytes = 2 * 4 * S.numel()
        bound_ms = 1e3 * bound_bytes / H100_HBM_BYTES_S
        entry[name] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms)
        print(f"median_filter kernel, size 31 along the {name} axis of |STFT| {tuple(S.shape)} "
              f"(strides {S.stride()}): {kernel_ms:.4f} ms (the earlier kernel "
              f"{MEDIAN_EARLIER_MS[name]} ms in PERF.md, a constant), plain (pad, unfold, "
              f"torch.median; {MAIN_SHAPE[0]} tracks one by one) {plain_ms:.4f} ms, "
              f"torch.median over the unfolded padded view ({MAIN_SHAPE[0]} tracks) "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes: {bound_bytes} read and "
              f"written once); bit-equal on all {MAIN_SHAPE[0]} tracks")

    # the parts of the path alone
    D = L.stft(y, n_fft=n_fft, hop_length=hop)
    stft_ms = time_ms(torch, lambda: L.stft(y, n_fft=n_fft, hop_length=hop), 3)
    magphase_ms = time_ms(torch, lambda: L.magphase(D), 3)
    mag, _ = L.magphase(D)
    harm = median.median_filter_1d(mag, size=31, axis=-1)
    perc = median.median_filter_1d(mag, size=31, axis=-2)
    mask_ms = time_ms(torch, lambda: L.util.utils._softmask_core(harm, perc * 1.0, power=2.0,
                                                                  split_zeros=True), 3)
    del mag, harm, perc
    decompose_ms = time_ms(torch, lambda: L.decompose.hpss(D), 3)
    H, _ = L.decompose.hpss(D)
    istft_ms = time_ms(torch, lambda: L.istft(H, n_fft=n_fft, hop_length=hop,
                                              length=MAIN_SHAPE[1]), 3)
    del H, D, S
    y_rung = L.resample(y, orig_sr=2, target_sr=1, res_type="polyphase", scale=True)
    resample_ms = time_ms(torch, lambda: L.resample(y, orig_sr=2, target_sr=1,
                                                    res_type="polyphase", scale=True), 3)
    del y_rung
    cqt_ms = time_ms(torch, lambda: L.cqt(y, res_type="polyphase", **cq), 3)
    hpss_ms = time_ms(torch, lambda: L.effects.hpss(y), 3)
    e2e_ms = time_ms(torch, lambda: forward(y), 3)
    samples = MAIN_SHAPE[0] * MAIN_SHAPE[1]
    print(f"cqt_hpss end to end: {e2e_ms:.4f} ms, {samples / (e2e_ms / 1e3):.6e} samples/s on "
          f"{MAIN_SHAPE}; alone: cqt {cqt_ms:.4f} ms (of which the first 2:1 polyphase rung "
          f"{resample_ms:.4f} ms), effects.hpss {hpss_ms:.4f} ms")
    print(f"effects.hpss parts: stft {stft_ms:.4f} ms, decompose.hpss from the complex STFT "
          f"{decompose_ms:.4f} ms (magphase {magphase_ms:.4f} ms, one soft mask {mask_ms:.4f} "
          f"ms, the two medians in the kernel rows above), one istft {istft_ms:.4f} ms")

    # K1 with the pseudo-CQT basis: |STFT| (hann, power 1) projected onto |filters|
    fmin = L.note_to_hz("C5")
    before = fused_stft.launches
    P = L.pseudo_cqt(y, sr=SR, hop_length=hop, fmin=fmin, n_bins=36)
    if fused_stft.launches != before + 1:
        raise AssertionError("pseudo_cqt did not launch the stft_mel kernel")
    pfreqs = L.cqt_frequencies(36, fmin=fmin)
    palpha = L.filters._relative_bandwidth(freqs=pfreqs)
    basis, p_fft, bands = constantq._filters_device(device, torch.float32, SR, pfreqs, 1, 1,
                                                    0.01, hop_length=hop, alpha=palpha,
                                                    magnitude=True)
    pwin = spectrum._win_device("hann", p_fft, p_fft, device, torch.float32)
    kw = dict(n_fft=p_fft, hop_length=hop, center=True, pad_mode="constant")
    poison(torch, (MAIN_SHAPE[0], 36, n_frames), device)
    got = fused_stft._fused(y, pwin, basis, bands, power=1.0, **kw)
    want = fused_stft.stft_mel_reference(y, pwin, basis, power=1.0, **kw)
    err = (got - want).double().square().sum(dim=(-2, -1))
    worst = float((10 * torch.log10(want.double().square().sum(dim=(-2, -1))
                                    / err.clamp(min=1e-300))).min())
    max_err = float((got - want).abs().max())
    via = snr_t(torch, torch.view_as_real(P)[..., 0], want / float(np.float32(np.sqrt(p_fft))))
    del got, want, err, P
    print(f"stft_mel with the pseudo-CQT basis (36 rows from C5, n_fft {p_fft}, power 1) at the "
          f"main shape: per track at least {worst:.1f} dB against plain, max |err| "
          f"{max_err:.3e}; pseudo_cqt against the plain projection {via:.1f} dB (floor "
          f"{MIN_SNR_POWER1_DB})")
    if not (worst >= MIN_SNR_POWER1_DB and via >= MIN_SNR_POWER1_DB):
        raise AssertionError(f"stft_mel with the pseudo-CQT basis: {worst:.1f}, {via:.1f} dB")
    k1_ms = time_ms(torch, lambda: fused_stft._fused(y, pwin, basis, bands, power=1.0, **kw), 10)
    k1_plain_ms = time_ms(torch, lambda: fused_stft.stft_mel_reference(y, pwin, basis, power=1.0,
                                                                       **kw), 3)
    k1_library_ms = time_ms(torch, lambda: stft_project(torch, y, pwin, basis, p_fft, hop, 1.0), 3)
    frames = MAIN_SHAPE[0] * n_frames
    bytes_ms = 1e3 * (4 * y.numel() + 4 * 36 * frames) / H100_HBM_BYTES_S
    ops_ms = 1e3 * (fused_stft.flops_per_frame(p_fft, int(torch.count_nonzero(basis)))
                    * frames / H100_F32_FLOP_S)
    before = fused_stft.launches
    hybrid_ms = time_ms(torch, lambda: L.hybrid_cqt(y, res_type="polyphase", **cq), 1, groups=2)
    hybrid_launches = (fused_stft.launches - before) // 3
    print(f"stft_mel with the pseudo-CQT basis: {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms, "
          f"library (torch.stft, |.|, exact-f32 torch.matmul) {k1_library_ms:.4f} ms, bound "
          f"{max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, operations {ops_ms:.4f}); "
          f"hybrid_cqt at 84 bins {hybrid_ms:.4f} ms with {hybrid_launches} stft_mel launch per "
          "call")
    if hybrid_launches != 1:
        raise AssertionError(f"hybrid_cqt launched stft_mel {hybrid_launches} times per call")
    k1 = dict(ms=k1_ms, plain_ms=k1_plain_ms, library_ms=k1_library_ms,
              bound_ms=max(bytes_ms, ops_ms),
              bound_by="bytes" if bytes_ms >= ops_ms else "operations", snr_db=worst,
              max_abs_err=max_err, rows=36, n_fft=p_fft)
    harm_entry = entry["harmonic (time)"]
    median_entry = {
        "name": "median_filter",
        "route": "cuda",
        "source": "librosa_tpu_torch/csrc/median_filter.cu",
        "replaces": "librosa_tpu/ops/median.py:23 median_filter_1d (an XLA program: no Pallas "
                    "kernel computes the sliding median)",
        "launches": counts["median_filter"],
        "launches_by_path": {"mel_db_mfcc": 0, "feature_stack": 0, "reconstruction": 0,
                             "cqt_hpss": counts["median_filter"]},
        "max_abs_err": 0.0,
        "ms": harm_entry["ms"],
        "kernel_ms": harm_entry["ms"],
        "plain_ms": harm_entry["plain_ms"],
        "bound_ms": harm_entry["bound_ms"],
        "bound_by": "bytes",
        "library_ms": harm_entry["library_ms"],
        "by_axis": entry,
    }
    return {"launches": counts, "median_filter": median_entry, "pseudo_cqt_basis": k1,
            "e2e_ms": e2e_ms}


FILES_N = 1 << 22                  # output samples of every file, as the main path's tracks
FILES_SR_HIGH = 44100              # the stereo files' rate: 2:1 to 22050 on the card
FILES_KINDS = ("wav", "flac", "wav44k")  # 8 mono WAV, 4 mono FLAC, 4 stereo WAV at 44.1 kHz
STREAM_KW = dict(block_length=256, frame_length=2048, hop_length=512)


def write_files(tmp, rng) -> list:
    """The 16 files of phase 4h: (kind, path, pcm int16 (n, channels)), from a seeded source."""
    import wave
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from flac_writer import write_flac

    out = []
    for i, kind in enumerate(["wav"] * 8 + ["flac"] * 4 + ["wav44k"] * 4):
        sr, n, ch = ((FILES_SR_HIGH, 2 * FILES_N, 2) if kind == "wav44k" else (SR, FILES_N, 1))
        t = np.arange(n) / sr
        x = 0.25 * np.sin(2 * np.pi * (110.0 * (i + 1)) * t)[:, None] + 0.08 * rng.randn(n, ch)
        pcm = np.clip(np.round(x * 32767), -32768, 32767).astype("<i2")
        path = f"{tmp}/{i:02d}_{kind}.{'flac' if kind == 'flac' else 'wav'}"
        if kind == "flac":
            write_flac(path, pcm, sr)
        else:
            with wave.open(path, "wb") as w:
                w.setnchannels(ch)
                w.setsampwidth(2)
                w.setframerate(sr)
                w.writeframes(pcm.tobytes())
        out.append((kind, path, pcm))
    return out


def best_s(fn, repeats: int = 3) -> float:
    """Best of ``repeats`` host-clock timings of ``fn()``, in seconds."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def files_phase(torch, L, device, smi: str) -> dict:
    """Phase 4h: config 1 from audio files: decode on the host, load, the forward on the card,
    stream; checked and timed."""
    import ctypes
    import tempfile
    import warnings

    import scipy.signal
    from librosa_tpu_torch._device import as_tensor
    from librosa_tpu_torch.entry import entry
    from librosa_tpu_torch.io import _native, _soxr
    from librosa_tpu_torch.ops import db_scale, fused_stft, median, ola_norm

    lib = _native.library()
    if lib is None:
        raise AssertionError("the port's audio decoder did not build or load")
    lib_path = _native.library_path()
    if lib_path.parent.name != "_build" or lib_path.parent.parent.name != "librosa_tpu_torch":
        raise AssertionError(f"decoder library outside librosa_tpu_torch/_build: {lib_path}")
    codecs = {}
    for name, sonames in (("libvorbisfile", ("libvorbisfile.so.3", "libvorbisfile.so")),
                          ("libmpg123", ("libmpg123.so.0", "libmpg123.so"))):
        codecs[name] = False
        for soname in sonames:
            try:
                ctypes.CDLL(soname)
            except OSError:
                continue
            codecs[name] = True
            break
    print(f"decoder: {lib_path}; libsoxr loads {_soxr.available()}, "
          + ", ".join(f"{k} loads {v}" for k, v in codecs.items())
          + " (the decoder dlopens the last two for Ogg Vorbis and MP3 files only)")
    forward, _ = entry()
    rng = np.random.RandomState(8)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        files = write_files(tmp, rng)
        print(f"4h files: {len(files)} written in {time.perf_counter() - t0:.2f} s "
              f"({sum(p.nbytes for _, _, p in files) / 1e6:.1f} MB of PCM)")

        # load every file with its defaults; the resampled ones warn once that soxr_hq is replaced
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            loaded = []
            for kind, path, _ in files:
                with L.io.AudioReader(path) as reader:
                    if reader._nat is None:
                        raise AssertionError(f"{path} was read by the wave fallback")
                loaded.append(L.load(path))
        for w in caught:
            print(f"4h load warning: {w.message}")
        for (kind, path, pcm), (y, sr) in zip(files, loaded):
            if sr != SR or y.shape != (FILES_N,) or y.dtype != np.float32:
                raise AssertionError(f"load({path}) -> {y.shape} {y.dtype} at {sr}")
            if kind != "wav44k":
                if not np.array_equal(y, pcm[:, 0].astype(np.float32) / 32768.0):
                    raise AssertionError(f"{kind} file {path} is not bit-equal to its PCM")
        resample_snr = []
        for (kind, path, pcm), (y, _) in zip(files, loaded):
            if kind == "wav44k":
                mix = (pcm.astype(np.float64) / 32768.0).mean(axis=1)
                want = scipy.signal.resample_poly(mix, 1, 2)[:FILES_N]
                resample_snr.append(snr_db(y, want))
        print(f"4h native-rate tracks bit-equal to pcm / 32768: 12 of 12; 2:1 resampled tracks "
              f"vs float64 resample_poly: min {min(resample_snr):.1f} dB (floor "
              f"{MIN_RESAMPLE_SNR_DB})")
        if not min(resample_snr) >= MIN_RESAMPLE_SNR_DB:
            raise AssertionError(f"4h resample {min(resample_snr):.1f} dB < {MIN_RESAMPLE_SNR_DB}")

        batch = np.stack([y for y, _ in loaded])
        fused_stft.launches = db_scale.launches = ola_norm.launches = median.launches = 0
        out = forward(batch)
        torch.cuda.synchronize()
        counts = {"stft_mel": fused_stft.launches, "db_scale": db_scale.launches,
                  "ola_norm": ola_norm.launches, "median_filter": median.launches}
        batch_d = torch.from_numpy(batch).to(device)
        direct = forward(batch_d)
        print(f"4h forward on the loaded batch {batch.shape}: mfcc {tuple(out.shape)}, launches "
              f"{counts}; bit-equal to the forward on the same samples put on the card directly: "
              f"{bool(torch.equal(out, direct))}")
        if counts["stft_mel"] < 1 or counts["db_scale"] < 1:
            raise AssertionError(f"config 1 from files did not launch both kernels: {counts}")
        if tuple(out.shape) != (16, 20, 1 + FILES_N // 512) or not torch.isfinite(out).all():
            raise AssertionError(f"4h mfcc {tuple(out.shape)}")
        if not torch.equal(out, direct):
            raise AssertionError("4h: the mfcc of the loaded batch differs from the direct run")
        del direct

        # stream one FLAC and one WAV file at the native rate, mel per block (center=False)
        mel_kw = dict(sr=SR, n_fft=2048, hop_length=512, n_mels=128, center=False)
        stream_rows = {}
        for kind in ("flac", "wav"):
            path = next(p for k, p, _ in files if k == kind)
            parts = [L.feature.melspectrogram(y=torch.from_numpy(b).to(device), **mel_kw)
                     for b in L.stream(path, **STREAM_KW) if b.shape[-1] >= 2048]
            got = torch.cat(parts, dim=-1)
            y_full, _ = L.load(path, sr=None)
            whole = L.feature.melspectrogram(y=torch.from_numpy(y_full).to(device), **mel_kw)
            if got.shape != whole.shape:
                raise AssertionError(f"4h stream {kind}: {tuple(got.shape)} frames against "
                                     f"{tuple(whole.shape)}")
            s = (float("inf") if torch.equal(got, whole)
                 else snr_db(got.cpu().numpy(), whole.cpu().numpy()))
            equal = float((got == whole).all(dim=0).double().mean())
            print(f"4h stream {kind}: {len(parts)} blocks, mel {tuple(got.shape)} vs the whole "
                  f"file's: {s:.1f} dB (floor {MIN_SNR_DB}), {100 * equal:.2f} % of frames "
                  "bit-equal")
            if not s >= MIN_SNR_DB:
                raise AssertionError(f"4h stream {kind}: {s:.1f} dB")

            def run_stream(path=path):
                n = 0
                for b in L.stream(path, **STREAM_KW):
                    if b.shape[-1] >= 2048:
                        L.feature.melspectrogram(y=torch.from_numpy(b).to(device), **mel_kw)
                    n += 1
                torch.cuda.synchronize()
                return n

            n_blocks = run_stream()
            stream_rows[kind] = n_blocks / best_s(run_stream)

        # times: decode, load and its stages, the forward, end to end, stream
        rows = {}
        for kind in FILES_KINDS:
            path = next(p for k, p, _ in files if k == kind)
            decode_s = best_s(lambda: L.io.read_audio(path))
            y_host, native_sr = L.io.read_audio(path)
            h2d_s = best_s(lambda: (as_tensor(y_host), torch.cuda.synchronize()))
            yd = as_tensor(y_host)
            mono_ms = time_ms(torch, lambda: L.to_mono(yd), 5)
            ym = L.to_mono(yd)
            res_ms = (time_ms(torch, lambda: L.resample(ym, orig_sr=native_sr, target_sr=SR,
                                                        res_type="polyphase"), 5)
                      if native_sr != SR else 0.0)
            y_out = (L.resample(ym, orig_sr=native_sr, target_sr=SR, res_type="polyphase")
                     if native_sr != SR else ym)
            d2h_s = best_s(lambda: y_out.cpu().numpy())
            load_s = best_s(lambda: L.load(path, res_type="polyphase"))
            rows[kind] = dict(decode_ms=1e3 * decode_s, h2d_ms=1e3 * h2d_s, mono_ms=mono_ms,
                              resample_ms=res_ms, d2h_ms=1e3 * d2h_s, load_ms=1e3 * load_s)
            print(f"4h {kind}: load {1e3 * load_s:.4f} ms a file; its stages alone: decode "
                  f"{1e3 * decode_s:.4f} ms, copy to the card {1e3 * h2d_s:.4f} ms, to_mono "
                  f"{mono_ms:.4f} ms, resample {res_ms:.4f} ms, copy back {1e3 * d2h_s:.4f} ms "
                  f"(host clock; to_mono and resample by CUDA events; {smi})")
        batch_d = torch.from_numpy(batch).to(device)
        forward_ms = time_ms(torch, lambda: forward(batch_d), 5)
        del batch_d

        def end_to_end():
            ys = [L.load(path, res_type="polyphase")[0] for _, path, _ in files]
            forward(np.stack(ys))
            torch.cuda.synchronize()

        e2e_s = best_s(end_to_end, 2)
        samples = len(files) * FILES_N
        print(f"4h forward on the loaded batch: {forward_ms:.4f} ms; config 1 from files end to "
              f"end (16 loads, stack, forward): {1e3 * e2e_s:.4f} ms, "
              f"{samples / e2e_s:.6e} samples/s; stream with mel per block: "
              + ", ".join(f"{k} {v:.2f} blocks/s" for k, v in stream_rows.items()) + f" ({smi})")
    return {"launches": counts, "rows": rows, "forward_ms": forward_ms, "e2e_ms": 1e3 * e2e_s,
            "stream_blocks_s": stream_rows}


# ---------------------------------------------------------------------------
# 4i: config 5 (onset strength, tempo, beats, pYIN) and its two kernels
# ---------------------------------------------------------------------------

PYIN5 = dict(fmin=65.0, fmax=800.0)  # bench.py's pyin call: 870 states at resolution 0.1
MIN_ENV_SNR_DB = 110.0    # the onset_strength golden's floor
MIN_F0_SNR_DB = 100.0     # f0 where both runs say voiced
MIN_VOICED_EQUAL = 0.999  # share of frames with the same voicing decision
BEAT_TOL_FRAMES = 1       # the beat golden's rule: each beat within a frame, one beat more or less
# the earlier designs' times on this path (PERF.md §5 and §6, NVIDIA H100 80GB HBM3, 700 W):
# kernel B one block per row, kernel A one warp per row and one frame a step, and its chain probe
VITERBI_EARLIER_MS = 357.2833
BEAT_DP_EARLIER_MS = 3.5958
BEAT_DP_EARLIER_CHAIN_MS = 1.2978
CONFIG5_EARLIER_MS = 630.2430


def config5_signal(torch, shape, seed, device):
    """Tracks of a melody over clicks, each at a tempo of its own, made from ``seed`` on ``device``.

    Per track: a tempo of 80-160 BPM; a tone of four harmonics whose pitch
    steps by up to three semitones on each beat (at most an octave from a
    start of 110-440 Hz), with a 5 Hz vibrato of 0.3 %, decaying after each
    beat; a noise burst on each beat; a noise floor 40 dB down.
    """
    g = torch.Generator(device=device).manual_seed(seed)
    rows, n = shape
    f64 = dict(device=device, dtype=torch.float64)
    t = torch.arange(n, **f64) / SR
    bpm = 80 + 80 * torch.rand(rows, 1, generator=g, **f64)
    f0 = 110 * 2 ** (2 * torch.rand(rows, 1, generator=g, **f64))
    beat_pos = t * bpm / 60
    steps = torch.randint(-3, 4, (rows, int(beat_pos.max()) + 2), generator=g, device=device)
    semis = torch.cumsum(steps, 1).clamp(-12, 12).double().gather(1, beat_pos.long())
    pitch = f0 * 2 ** (semis / 12) * (1 + 0.003 * torch.sin(2 * np.pi * 5 * t))
    phase = 2 * np.pi * torch.cumsum(pitch / SR, dim=1)
    tone = sum(torch.sin(k * phase) / k for k in range(1, 5))
    frac = torch.frac(beat_pos)
    noise = torch.randn(rows, n, generator=g, **f64)
    y = 0.2 * tone * torch.exp(-8 * frac) + 0.3 * noise * torch.exp(-frac * 60 / bpm * 200)
    return (y + 0.01 * noise).float()


def beats_agree(got, want, tol: int = BEAT_TOL_FRAMES) -> bool:
    """The beat golden's comparison: one beat more or less, the rest within ``tol`` frames."""
    g, w = np.sort(np.asarray(got).ravel()), np.sort(np.asarray(want).ravel())
    if abs(len(g) - len(w)) > 1:
        return False
    n = min(len(g), len(w))
    return any(np.all(np.abs(g[o:o + n] - w[:n]) <= tol) for o in range(len(g) - n + 1)) \
        or bool(np.all(np.abs(g[:n] - w[:n]) <= tol))


def poison_all(torch, shapes, device) -> None:
    """NaN-filled buffers of every shape, held together and then freed (see :func:`poison`)."""
    bufs = [torch.full(s, float("nan"), dtype=torch.float32, device=device) for s in shapes]
    del bufs


def beat_dp_kernel_phase(torch, rng, device) -> None:
    """Phase 4i, kernel A: the batched beat DP against its plain version, bit for bit."""
    from librosa_tpu_torch.ops import beat_dp

    cases = [(f"T {T}, 16 rows, fpb 38-48 a row", 16, T, False, 43, 5, False)
             for T in (1, 31, 1023, 1025, 8193)]
    cases += [("T 1025, 16 rows, fpb per frame", 16, 1025, True, 43, 5, False),
              ("T 8193, 1 row, fpb per frame", 1, 8193, True, 30, 8, False),
              ("T 2000, 1 row, fpb 700 (2 fpb beyond the 1024 window)", 1, 2000, False, 700, 0,
               False),
              ("T 1025, 16 rows, row 3 all negative (first-beat gating)", 16, 1025, False, 43, 5,
               True),
              ("T 3000, 16 rows, fpb 1-3 per frame (one or two frames a step)", 16, 3000, True, 2,
               1, False),
              ("T 8193, 16 rows, fpb per frame swinging 2-60", 16, 8193, True, 31, 29, False),
              ("T 7, 16 rows, shorter than one step", 16, 7, False, 43, 5, False)]
    for label, rows, T, tv, fpb0, spread, negative in cases:
        ls = rng.randn(rows, T).astype(np.float32)
        if negative:
            ls[3] = -np.abs(ls[3])
        fpb = (fpb0 + rng.randint(-spread, spread + 1, size=(rows, T if tv else 1)))
        ls_d = torch.from_numpy(ls).to(device)
        fpb_d = torch.from_numpy(fpb.astype(np.float32)).to(device)
        steps = max(len(beat_dp.step_schedule(fpb[r], T)) for r in range(rows))
        poison_all(torch, [(rows, T), (rows, T)], device)
        got_b, got_c = beat_dp.beat_dp(ls_d, fpb_d, 100.0)
        want_b, want_c = beat_dp.beat_dp_reference(ls_d, fpb_d, 100.0)
        torch.cuda.synchronize()
        ok = torch.equal(got_b, want_b) and torch.equal(got_c, want_c)
        links = int((got_b >= 0).sum())
        print(f"beat_dp kernel vs plain, {label}: {'bit-equal' if ok else 'DIFFERENT'} "
              f"({links} backlinks set; {steps} steps on the slowest row)")
        if not ok:
            raise AssertionError(f"beat_dp kernel vs plain, {label}: "
                                 f"{int((got_b != want_b).sum())} backlinks and "
                                 f"{int((got_c != want_c).sum())} scores differ")
    print(f"beat_dp kernel vs plain: {len(cases)} cases bit-equal, each on NaN-filled memory")


def viterbi_on_route(torch, viterbi, lp_d, lt_d, lpi_d, route):
    """States and logp of the Viterbi kernels with the forward pass forced onto ``route``."""
    ptrs, states, logp = viterbi.forward(lp_d, lt_d, lpi_d, route)
    viterbi.backtrack(ptrs, states, lp_d.shape[-1])
    return states, logp


def viterbi_kernel_phase(torch, rng, device, pyin_trans) -> None:
    """Phase 4i, kernel B: the Viterbi kernels against their plain version, bit for bit, on
    every route of the forward pass."""
    from librosa_tpu_torch.ops import viterbi

    lt870, lpi870 = pyin_trans

    def random_case(rows, T, S, pruned):
        lp = np.log(rng.rand(rows, T, S)).astype(np.float32)
        lp[rng.rand(rows, T, S) < 0.05] = -np.inf  # empty states, as pYIN's float32 log gives
        lt = np.log(rng.rand(S, S)).astype(np.float32)
        if pruned:
            lt[rng.rand(S, S) < 0.3] = -np.inf
        return lp, lt, np.log(np.full(S, 1.0 / S)).astype(np.float32)

    def tie_case(rows, T, S):
        lp = rng.randint(-3, 1, size=(rows, T, S)).astype(np.float32)
        return lp, np.zeros((S, S), np.float32), np.zeros(S, np.float32)

    def pyin_case(rows, T):
        return random_case(rows, T, 870, False)[0], lt870, lpi870

    def empty_columns_case():
        lt = lt870.copy()
        lt[:, [17, 600]] = -np.inf  # two states that no state reaches
        return random_case(4, 216, 870, False)[0], lt, lpi870

    def empty_runs_case():
        # every p of column 300's runs is -inf in frames 40-49: its sums are all -inf there
        lp = random_case(2, 216, 870, False)[0]
        lp[:, 40:50, np.isfinite(lt870[:, 300])] = -np.inf
        return lp, lt870, lpi870

    edge = viterbi.CLUSTER_MIN_STATES
    cases = [("S 2, T 1, 16 rows", *random_case(16, 1, 2, False)),
             ("S 2, T 8193, 16 rows", *random_case(16, 8193, 2, False)),
             ("S 5, T 2, 16 rows", *random_case(16, 2, 5, True)),
             ("S 5, T 216, 4 rows, exact ties everywhere", *tie_case(4, 216, 5)),
             ("S 870, T 216, 16 rows, pYIN's pruned transitions", *pyin_case(16, 216)),
             ("S 870, T 8193, 2 rows, pYIN's pruned transitions", *pyin_case(2, 8193)),
             ("S 1027, T 216, 3 rows, a third of the transitions -inf",
              *random_case(3, 216, 1027, True)),
             ("S 1027, T 8193, 1 row, a third of the transitions -inf",
              *random_case(1, 8193, 1027, True)),
             ("S 870, T 216, 2 rows, exact ties everywhere", *tie_case(2, 216, 870)),
             ("S 870, T 216, 4 rows, pYIN's transitions with two all -inf columns",
              *empty_columns_case()),
             ("S 870, T 216, 2 rows, log_prob -inf over column 300's runs in 10 frames",
              *empty_runs_case()),
             ("S 870, T 216, 2 rows, dense transitions (values in global memory)",
              *random_case(2, 216, 870, False)),
             (f"S {edge - 1}, T 1000, 4 rows, pruned (below the route threshold)",
              *random_case(4, 1000, edge - 1, True)),
             (f"S {edge}, T 1000, 4 rows, pruned (at the route threshold)",
              *random_case(4, 1000, edge, True)),
             ("S 870, T 216, 1 row, pYIN's transitions (bench.py's 5 s pyin)", *pyin_case(1, 216)),
             ("S 870, T 64, 17 rows, pYIN's transitions (more clusters than 16)",
              *pyin_case(17, 64))]
    for label, lp, lt, lpi in cases:
        lp_d, lt_d, lpi_d = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                             for a in (lp, lt, lpi))
        rows, T, S = lp.shape
        want_s, want_p = viterbi.viterbi_reference(lp_d, lt_d, lpi_d)
        results = []
        for route in viterbi.ROUTES:
            poison_all(torch, [(rows, T), (rows,)], device)
            results.append((route, *viterbi_on_route(torch, viterbi, lp_d, lt_d, lpi_d, route)))
        poison_all(torch, [(rows, T), (rows,)], device)
        results.append((f"viterbi_decode ({viterbi.route_for(S, rows)})",
                        *viterbi.viterbi_decode(lp_d, lt_d, lpi_d)))
        torch.cuda.synchronize()
        for route, got_s, got_p in results:
            ok = torch.equal(got_s, want_s) and torch.equal(got_p, want_p)
            print(f"viterbi kernel vs plain, {label}, {route}: "
                  f"{'bit-equal' if ok else 'DIFFERENT'}")
            if not ok:
                raise AssertionError(f"viterbi kernel vs plain, {label}, {route}: "
                                     f"{int((got_s != want_s).sum())} states differ, logp "
                                     f"{got_p.tolist()[:4]} vs {want_p.tolist()[:4]}")
    print(f"viterbi kernels vs plain: {len(cases)} cases bit-equal on every route "
          f"({', '.join(viterbi.ROUTES)}) and through viterbi_decode, each on NaN-filled "
          f"memory")


def priors_equal(torch, got, want) -> bool:
    """Bit for bit, NaN where the other has NaN, and the plain version's layout."""
    nan = torch.isnan(want)
    return (got.shape == want.shape and got.stride() == want.stride()
            and torch.equal(torch.isnan(got), nan)
            and torch.equal(torch.where(nan, 0.0, got), torch.where(nan, 0.0, want)))


def trough_priors_phase(torch, L, rng, device) -> dict:
    """Phase 4i, the trough priors kernel: against the plain loop on the card, bit for bit, in
    float32 and float64, on pYIN's own inputs and on edge cases, its launches on the path, and
    its time beside the loop's and the bound by bytes."""
    from librosa_tpu_torch.core import pitch
    from librosa_tpu_torch.ops import trough_priors as tp

    key = (float(SR), PYIN5["fmin"], PYIN5["fmax"], 512, 100, (2.0, 18.0), 0.1, 35.92, 0.01,
           1e-4)
    thresholds, beta_probs, _, _ = pitch._pyin_tables(*key)
    yin_kw = dict(sr=SR, fmin=PYIN5["fmin"], fmax=PYIN5["fmax"], frame_length=2048,
                  hop_length=512, center=True, pad_mode="constant")

    def path_case(rows, n, seed, dtype):  # the CMND and troughs pyin computes, on the card
        y = config5_signal(torch, (rows, n), seed, device).to(dtype)
        yin, _, trough, _ = pitch._yin_frames(y, **yin_kw)
        return yin, trough

    def host_case(values, trough):  # made on the CPU from numpy, copied up
        return (torch.from_numpy(np.ascontiguousarray(values)).to(device),
                torch.from_numpy(np.ascontiguousarray(trough)).to(device))

    def edge_case(np_dtype):
        t = thresholds[1:].astype(np_dtype)
        v = t[rng.randint(0, 100, size=(3, 314, 64))].astype(np_dtype)  # every value a threshold
        v[:, :, 32:] = (rng.rand(3, 314, 32) * 1.2).astype(np_dtype)
        m = rng.rand(3, 314, 64) < 0.3
        m[:, :, 0] = False                                   # no trough
        m[:, :, 1] = False
        m[:, 100, 1] = True                                  # one trough
        m[:, :, 2] = False
        m[:, ::2, 2] = True                                  # every other lag
        m[:, :, 3] = True                                    # every lag
        m[:, :, 4] = False
        m[:, 7, 4] = m[:, 250, 4] = True
        v[:, 7, 4] = v[:, 250, 4] = v[:, 7, 5]               # two lowest troughs, equal
        return host_case(v, m)

    cases = []
    for dtype, np_dtype in ((torch.float32, np.float32), (torch.float64, np.float64)):
        name = str(dtype).replace("torch.", "")
        cases += [
            (f"{name}, pyin's input (16, 314, 8193)", *path_case(16, 1 << 22, 5, dtype)),
            (f"{name}, pyin's input (32, 314, 1292), 30 s clips", *path_case(32, 661500, 6, dtype)),
            (f"{name}, random CMND from numpy (4, 314, 1000)",
             *host_case((rng.rand(4, 314, 1000) * 1.2).astype(np_dtype),
                        rng.rand(4, 314, 1000) < 0.3)),
            (f"{name}, no trough / one / every other lag / every lag / values at the float "
             f"thresholds / equal lowest troughs", *edge_case(np_dtype)),
            (f"{name}, T = 1", *host_case((rng.rand(16, 314, 1) * 1.2).astype(np_dtype),
                                          rng.rand(16, 314, 1) < 0.3)),
            (f"{name}, P = 2047", *host_case((rng.rand(2, 2047, 300) * 1.2).astype(np_dtype),
                                             rng.rand(2, 2047, 300) < 0.3)),
        ]
        yin, trough = path_case(4, 1 << 18, 7, dtype)
        cases.append((f"{name}, a non-contiguous view (every other track and frame)",
                      yin[::2, :, ::2], trough[::2, :, ::2]))
    for label, yin, trough in cases:
        want = tp.trough_priors_reference(yin, trough, thresholds, beta_probs, 2.0, 0.01)
        poison(torch, tuple(want.shape), device)
        before = tp.launches
        got = tp.trough_priors(yin, trough, thresholds, beta_probs, 2.0, 0.01)
        torch.cuda.synchronize()
        ok = priors_equal(torch, got, want) and tp.launches == before + 1
        print(f"trough priors kernel vs plain, {label}, yin strides {yin.stride()}: "
              f"{'bit-equal' if ok else 'DIFFERENT'}")
        if not ok:
            bad = int((got != want).sum())
            raise AssertionError(f"trough priors kernel vs plain, {label}: {bad} elements differ "
                                 f"(launches {tp.launches - before}, strides {got.stride()} vs "
                                 f"{want.stride()})")
    print(f"trough priors kernel vs plain: {len(cases)} cases bit-equal in float32 and float64, "
          f"each on NaN-filled memory")

    # once per pyin call on the main path
    y = config5_signal(torch, (2, 1 << 18), 8, device)
    L.pyin(y, sr=SR, **PYIN5)
    before = tp.launches
    for _ in range(3):
        L.pyin(y, sr=SR, **PYIN5)
    torch.cuda.synchronize()
    per_call = (tp.launches - before) / 3
    print(f"trough priors launches per pyin call: {per_call}")
    if per_call != 1:
        raise AssertionError(f"pyin launched the trough priors kernel {per_call} times a call")

    # times at pyin's shape on the main buffer, beside the loop's and the bound by bytes
    yin, trough = path_case(16, 1 << 22, 5, torch.float32)
    run = lambda: tp.trough_priors(yin, trough, thresholds, beta_probs, 2.0, 0.01)
    kernel_ms = time_ms(torch, run, 20)
    yin64, trough64 = path_case(16, 1 << 22, 5, torch.float64)
    kernel64_ms = time_ms(torch, lambda: tp.trough_priors(yin64, trough64, thresholds, beta_probs,
                                                          2.0, 0.01), 10)
    del yin64, trough64
    plain_ms = time_ms(torch, lambda: tp.trough_priors_reference(yin, trough, thresholds,
                                                                 beta_probs, 2.0, 0.01), 1,
                       groups=2)
    bytes_moved = 9 * yin.numel()  # yin and the mask read once, the priors written once
    bound_ms = 1e3 * bytes_moved / H100_HBM_BYTES_S
    print(f"trough priors kernel {kernel_ms:.4f} ms on {tuple(yin.shape)} float32 (float64 "
          f"{kernel64_ms:.4f} ms), plain loop {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by bytes "
          f"({bytes_moved} bytes); {kernel_ms / bound_ms:.2f}x the bound; yin strides "
          f"{yin.stride()}, trough strides {trough.stride()}")
    return {
        "name": "trough_priors", "route": "cuda",
        "source": "librosa_tpu_torch/csrc/trough_priors.cu",
        "replaces": "librosa_tpu/core/pitch.py:773 _pyin_trough_probs (an XLA program: no Pallas "
                    "kernel computes the trough priors)",
        "launches": 0, "launches_by_path": {}, "max_abs_err": 0.0, "ms": kernel_ms,
        "kernel_ms": kernel_ms, "float64_ms": kernel64_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
    }


def viterbi_route_times(torch, rng, device, lt870, lpi870) -> dict:
    """Kernel B's forward pass by each route on (16, 8193, S), S = 2, 5, 64, 128, 256, 870."""
    from librosa_tpu_torch.ops import viterbi

    times = {}
    for S in (2, 5, 64, 128, 256, 870):
        if S == 870:
            lt_d, lpi_d = lt870, lpi870
        else:
            lt_d = torch.from_numpy(np.log(rng.rand(S, S)).astype(np.float32)).to(device)
            lpi_d = torch.full((S,), float(np.log(1.0 / S)), device=device)
        lp_d = torch.log(torch.rand((16, 8193, S), generator=torch.Generator(device=device)
                                    .manual_seed(S), device=device))
        runs = viterbi.run_table(lt_d.cpu().numpy()).on(device)
        times[S] = {route: time_ms(torch, lambda: viterbi.forward(lp_d, lt_d, lpi_d, route, runs),
                                   1, groups=2)
                    for route in viterbi.ROUTES}
        del lp_d
    faster = [S for S, t in times.items() if t["cluster"] < t["block"]]
    print("viterbi forward by route on (16, 8193, S): " + "; ".join(
        f"S {S}: block {t['block']:.4f} ms, cluster {t['cluster']:.4f} ms"
        for S, t in times.items()))
    print(f"viterbi route threshold: the cluster route is faster at S in {faster}; "
          f"viterbi_decode takes it from S >= {viterbi.CLUSTER_MIN_STATES} "
          f"(CLUSTER_MIN_STATES)")
    return times


def dp_candidates(fpb: np.ndarray, T: int, window: int = 1024) -> int:
    """Candidates the beat DP scores on these rows: d with round(fpb/2) <= d <= min(2 fpb, i, 1024)."""
    i = np.arange(T)[None, :]
    lo = np.maximum(np.round(fpb / 2), 1)
    hi = np.minimum(np.minimum(np.floor(2 * fpb), i), window)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def config5_phase(torch, L, device) -> dict:
    """Phase 4i: config 5 (entry.onset_beat_pyin) driven, checked against the port's float64 CPU
    run, bench.py's 1-D shapes, the two kernels at the path's shapes, and the times."""
    from librosa_tpu_torch import beat
    from librosa_tpu_torch.core import pitch
    from librosa_tpu_torch.entry import onset_beat_pyin
    from librosa_tpu_torch.ops import (beat_dp, db_scale, fused_stft, median, ola_norm,
                                       trough_priors, viterbi)

    rng = np.random.RandomState(5)
    key = (float(SR), PYIN5["fmin"], PYIN5["fmax"], 512, 100, (2.0, 18.0), 0.1, 35.92, 0.01,
           1e-4)
    _, _, log_trans, log_p_init = pitch._pyin_tables(*key)
    lt = torch.from_numpy(log_trans.astype(np.float32)).to(device)
    lpi = torch.from_numpy(log_p_init.astype(np.float32)).to(device)
    print(f"pyin at fmin {PYIN5['fmin']}, fmax {PYIN5['fmax']}: {lt.shape[0]} states, "
          f"{int(torch.isinf(lt).sum())} of {lt.numel()} transitions pruned to -inf")
    beat_dp_kernel_phase(torch, rng, device)
    viterbi_kernel_phase(torch, rng, device, (lt.cpu().numpy(), lpi.cpu().numpy()))
    priors_entry = trough_priors_phase(torch, L, rng, device)
    route_times = viterbi_route_times(torch, rng, device, lt, lpi)

    counters = (fused_stft, db_scale, ola_norm, median, beat_dp, viterbi, trough_priors)
    names = ("stft_mel", "db_scale", "ola_norm", "median_filter", "beat_dp", "viterbi",
             "trough_priors")

    def zero():
        for mod in counters:
            mod.launches = 0
        for r in viterbi.launches_by_route:
            viterbi.launches_by_route[r] = 0

    def read():
        return {n: mod.launches for n, mod in zip(names, counters)}

    y = config5_signal(torch, MAIN_SHAPE, 5, device)
    forward, _ = onset_beat_pyin()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    zero()
    t0 = time.perf_counter()
    env, tempo, beats, (f0, vflag, vprob) = forward(y)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = read()
    route_counts = dict(viterbi.launches_by_route)
    peak_bytes = torch.cuda.max_memory_allocated()
    rows, n_frames = MAIN_SHAPE[0], 1 + MAIN_SHAPE[1] // 512
    print(f"onset_beat_pyin: y {tuple(y.shape)} -> envelope {tuple(env.shape)}, tempo "
          f"{tempo.shape}, beats {beats.shape}, f0 {tuple(f0.shape)}; launches {counts}; first "
          f"call {first_s:.3f} s; peak memory {peak_bytes} bytes, {peak_bytes - base_bytes} "
          f"above the {base_bytes} held before")
    want = {"stft_mel": 1, "db_scale": 1, "ola_norm": 0, "median_filter": 0, "beat_dp": 1,
            "viterbi": 1, "trough_priors": 1}
    if counts != want:
        raise AssertionError(f"onset_beat_pyin launched {counts}, expected {want}")
    for name, t in (("envelope", env), ("f0", f0), ("voiced_flag", vflag),
                    ("voiced_prob", vprob)):
        if tuple(t.shape) != (rows, n_frames):
            raise AssertionError(f"onset_beat_pyin {name} shape {tuple(t.shape)}")
    if tempo.shape != (rows, 1) or beats.shape != (rows, n_frames) or beats.dtype != bool:
        raise AssertionError(f"onset_beat_pyin tempo {tempo.shape}, beats {beats.shape}")
    if not (bool(torch.isfinite(env).all()) and bool(torch.isfinite(f0[vflag]).all())
            and bool(torch.isnan(f0[~vflag]).all()) and bool((vprob >= 0).all())
            and bool((vprob <= 1).all())):
        raise AssertionError("onset_beat_pyin: non-finite or out-of-range values")
    print(f"onset_beat_pyin: tempo per track {np.round(tempo.ravel(), 2).tolist()} BPM; beats "
          f"per track {beats.sum(-1).tolist()}; voiced share "
          f"{float(vflag.float().mean()):.4f}")

    # tracks 0 and 1 against the port's own float64 run of the same forward on the CPU
    t0 = time.perf_counter()
    env64, tempo64, beats64, (f064, vflag64, _) = forward(y[:2].cpu().double())
    cpu_s = time.perf_counter() - t0
    env_snr = [snr_db(env[r].cpu().numpy(), env64[r].numpy()) for r in range(2)]
    tempo_equal = bool(np.array_equal(tempo[:2], tempo64))
    beats_ok = [beats_agree(np.flatnonzero(beats[r]), np.flatnonzero(beats64[r]))
                for r in range(2)]
    v32, v64 = vflag[:2].cpu().numpy(), vflag64.numpy()
    voiced_equal = float((v32 == v64).mean())
    both = v32 & v64
    f0_snr = snr_db(f0[:2].cpu().numpy()[both], f064.numpy()[both])
    print(f"onset_beat_pyin tracks 0 and 1 vs the float64 CPU run ({cpu_s:.1f} s): envelope "
          f"{env_snr[0]:.1f} / {env_snr[1]:.1f} dB (floor {MIN_ENV_SNR_DB}), tempo "
          f"{'equal' if tempo_equal else 'DIFFERENT'}, beats within {BEAT_TOL_FRAMES} frame "
          f"{beats_ok}, voicing equal in {voiced_equal:.5f} of frames (floor "
          f"{MIN_VOICED_EQUAL}), f0 where both voiced ({int(both.sum())} frames) {f0_snr:.1f} dB "
          f"(floor {MIN_F0_SNR_DB})")
    if not (min(env_snr) >= MIN_ENV_SNR_DB and tempo_equal and all(beats_ok)
            and voiced_equal >= MIN_VOICED_EQUAL and f0_snr >= MIN_F0_SNR_DB):
        raise AssertionError("onset_beat_pyin disagrees with its float64 CPU run")

    # bench.py's 1-D shapes: beat_track of 30 s (the host DP), pyin of 5 s (the Viterbi kernel)
    y30, y5 = y[2, :30 * SR], y[3, :5 * SR]
    zero()
    tempo30, beats30 = L.beat.beat_track(y=y30, sr=SR)
    f0_5, v5, _ = L.pyin(y5, sr=SR, **PYIN5)
    torch.cuda.synchronize()
    bench_counts = read()
    route_counts = {r: n + viterbi.launches_by_route[r] for r, n in route_counts.items()}
    tempo30_64, beats30_64 = L.beat.beat_track(y=y30.cpu().double(), sr=SR)
    f0_5_64, v5_64, _ = L.pyin(y5.cpu().double(), sr=SR, **PYIN5)
    both5 = (v5.cpu() & v5_64).numpy()
    v5_equal = float((v5.cpu() == v5_64).float().mean())
    f0_5_snr = snr_db(f0_5.cpu().numpy()[both5], f0_5_64.numpy()[both5])
    beat30_s = best_s(lambda: L.beat.beat_track(y=y30, sr=SR))
    pyin5_s = best_s(lambda: (L.pyin(y5, sr=SR, **PYIN5)[0].sum().item()))
    print(f"bench.py's 1-D shapes: beat_track of 30 s {1e3 * beat30_s:.4f} ms (tempo "
          f"{float(np.atleast_1d(tempo30)[0]):.2f}, {len(beats30)} beats, host DP), pyin of 5 s "
          f"{1e3 * pyin5_s:.4f} ms (host clock, best of 3); launches {bench_counts}; vs float64: "
          f"beats within a frame {beats_agree(beats30, beats30_64)}, tempo "
          f"{'equal' if np.array_equal(tempo30, tempo30_64) else 'DIFFERENT'}, voicing equal "
          f"{v5_equal:.5f}, f0 {f0_5_snr:.1f} dB")
    if bench_counts != {"stft_mel": 1, "db_scale": 1, "ola_norm": 0, "median_filter": 0,
                        "beat_dp": 0, "viterbi": 1, "trough_priors": 1}:
        raise AssertionError(f"bench.py's 1-D shapes launched {bench_counts}")
    if not (beats_agree(beats30, beats30_64) and np.array_equal(tempo30, tempo30_64)
            and v5_equal >= MIN_VOICED_EQUAL and f0_5_snr >= MIN_F0_SNR_DB):
        raise AssertionError("bench.py's 1-D shapes disagree with their float64 CPU runs")

    # times of the path and its parts
    e2e_ms = time_ms(torch, lambda: forward(y), 1, groups=2)
    onset_ms = time_ms(torch, lambda: L.onset.onset_strength(y=y, sr=SR, aggregate=np.median), 3)
    tempo_ms = time_ms(torch, lambda: L.feature.tempo(onset_envelope=env, sr=SR), 3)
    track_ms = time_ms(torch, lambda: L.beat.beat_track(onset_envelope=env, sr=SR, bpm=tempo,
                                                        sparse=False), 1, groups=2)
    fpb = np.round(SR / 512 * 60.0 / tempo)
    ls = beat._local_score(env.cpu().numpy(), fpb)
    ls_d = torch.from_numpy(ls.astype(np.float32)).to(device)
    fpb_d = torch.from_numpy(fpb.astype(np.float32)).to(device)
    dp_got = beat_dp.beat_dp(ls_d, fpb_d, 100.0)
    dp_want = beat_dp.beat_dp_reference(ls_d, fpb_d, 100.0)
    dp_equal = torch.equal(dp_got[0], dp_want[0]) and torch.equal(dp_got[1], dp_want[1])
    dp_err = float((dp_got[1] - dp_want[1]).abs().max())
    dp_steps = max(len(beat_dp.step_schedule(fpb[r], n_frames)) for r in range(fpb.shape[0]))
    dp_ms = time_ms(torch, lambda: beat_dp.beat_dp(ls_d, fpb_d, 100.0), 10)
    dp_plain_ms = time_ms(torch, lambda: beat_dp.beat_dp_reference(ls_d, fpb_d, 100.0), 1,
                          groups=1)
    yin_kw = dict(sr=SR, fmin=PYIN5["fmin"], fmax=PYIN5["fmax"], frame_length=2048,
                  hop_length=512, center=True, pad_mode="constant")
    yin_ms = time_ms(torch, lambda: pitch._yin_frames(y, **yin_kw), 3)
    thresholds, beta_probs, _, _ = pitch._pyin_tables(*key)
    obs_kw = dict(sr=SR, fmin=PYIN5["fmin"], fmax=PYIN5["fmax"], frame_length=2048,
                  thresholds=thresholds, beta_probs=beta_probs, n_pitch_bins=435,
                  n_bins_per_semitone=10, boltzmann_parameter=2.0, no_trough_prob=0.01)

    def observe():  # pad, frame and the frame-wise half, as pyin runs them
        frames = L.util.frame(torch.nn.functional.pad(y, (1024, 1024)), frame_length=2048,
                              hop_length=512)
        return pitch._pyin_observe(frames, **obs_kw)

    observe_ms = time_ms(torch, observe, 2)
    obs_full, _ = observe()
    lp = pitch._pyin_log_prob(obs_full).transpose(-2, -1).contiguous()
    del obs_full
    table = viterbi.run_table(log_trans).on(device)  # as sequence._decode caches it for pyin
    vit_got = viterbi.viterbi_decode(lp, lt, lpi, table)
    vit_want = viterbi.viterbi_reference(lp, lt, lpi)
    vit_equal = torch.equal(vit_got[0], vit_want[0]) and torch.equal(vit_got[1], vit_want[1])
    vit_ms = time_ms(torch, lambda: viterbi.viterbi_decode(lp, lt, lpi, table), 1, groups=3)
    route = viterbi.route_for(lp.shape[-1], lp.shape[0])
    fwd_ms = time_ms(torch, lambda: viterbi.forward(lp, lt, lpi, route, table), 1, groups=3)
    ptrs, st_bt, _ = viterbi.forward(lp, lt, lpi, route, table)
    back_ms = time_ms(torch, lambda: viterbi.backtrack(ptrs, st_bt, lp.shape[-1]), 5)
    del ptrs, st_bt
    exchange_ms = viterbi.exchange_floor_ms(lp.shape[0], lp.shape[1], table)
    occupancy = viterbi.max_active_clusters(table)
    vit_plain_ms = time_ms(torch, lambda: viterbi.viterbi_reference(lp, lt, lpi), 1, groups=1)
    pyin_ms = time_ms(torch, lambda: L.pyin(y, sr=SR, **PYIN5), 1, groups=2)
    print(f"at the path's shapes: beat_dp kernel vs plain {'bit-equal' if dp_equal else 'DIFFERENT'}"
          f" on {tuple(ls_d.shape)}; viterbi kernel vs plain "
          f"{'bit-equal' if vit_equal else 'DIFFERENT'} on {tuple(lp.shape)}")
    if not (dp_equal and vit_equal):
        raise AssertionError("a config 5 kernel disagrees with its plain version at the path's "
                             "shapes")

    # bounds: bytes (each input read once, each output written once) and operations
    T, S = n_frames, lp.shape[-1]
    dp_bytes_ms = 1e3 * (4 * ls_d.numel() + 4 * fpb_d.numel() + 8 * ls_d.numel()) / H100_HBM_BYTES_S
    n_cand = dp_candidates(fpb, T)
    dp_ops_ms = 1e3 * 5 * n_cand / H100_F32_FLOP_S  # sub, mul, mul, sub, compare a candidate
    # the chain of steps: the probe runs only each step's flags, ring read, warp reduction,
    # ring write and barrier, as many full steps as the slowest row takes, on as many rows
    dp_chain_ms = beat_dp.chain_floor_ms(ls_d.shape[0], dp_steps, device)
    dp_terms = {"bytes": dp_bytes_ms, "operations": dp_ops_ms, "dependence chain": dp_chain_ms}
    dp_binding = max(dp_terms, key=dp_terms.get)
    vit_bytes_ms = 1e3 * (4 * lp.numel() + 4 * S * S + 4 * S + 4 * rows * T + 4 * rows) \
        / H100_HBM_BYTES_S
    # an add and a compare a pair; an exact scan may skip the pairs whose transition is -inf
    finite_pairs = rows * (T - 1) * table.n_finite
    vit_ops_ms = 1e3 * 2 * finite_pairs / H100_F32_FLOP_S
    vit_dense_ms = 1e3 * 2 * rows * (T - 1) * S * S / H100_F32_FLOP_S
    vit_terms = {"bytes": vit_bytes_ms, "operations": vit_ops_ms}
    vit_binding = max(vit_terms, key=vit_terms.get)
    print(f"config 5 end to end {e2e_ms:.4f} ms on {MAIN_SHAPE} "
          f"({MAIN_SHAPE[0] * MAIN_SHAPE[1] / (e2e_ms / 1e3):.6e} samples/s; the earlier "
          f"kernels' run in PERF.md: {CONFIG5_EARLIER_MS} ms); alone: onset_strength (median) "
          f"{onset_ms:.4f} ms, tempo {tempo_ms:.4f} ms, beat_track from the envelope "
          f"{track_ms:.4f} ms, pyin {pyin_ms:.4f} ms (yin frames {yin_ms:.4f} ms, observation "
          f"{observe_ms:.4f} ms, Viterbi kernels {vit_ms:.4f} ms)")
    print(f"beat_dp kernel {dp_ms:.4f} ms (the one-frame-a-step design in PERF.md: "
          f"{BEAT_DP_EARLIER_MS} ms, its chain probe {BEAT_DP_EARLIER_CHAIN_MS} ms), plain "
          f"{dp_plain_ms:.4f} ms, bound {max(dp_bytes_ms, dp_ops_ms):.6f} ms by bytes and "
          f"operations (bytes {dp_bytes_ms:.6f}, operations {dp_ops_ms:.6f}: {n_cand} "
          f"candidates); a chain of {dp_steps} steps of up to {beat_dp.STEP_FRAMES} frames on "
          f"the slowest row ({T} frames), {1e6 * dp_ms / dp_steps:.2f} ns a step, whose floor "
          f"(the step probe, measured) is {dp_chain_ms:.4f} ms, "
          f"{1e6 * dp_chain_ms / dp_steps:.2f} ns a step; the {dp_binding} binds: the kernel "
          f"runs at {dp_ms / dp_terms[dp_binding]:.2f}x that bound")
    print(f"viterbi kernels {vit_ms:.4f} ms by the {route} route (the one-block-per-row design "
          f"in PERF.md: {VITERBI_EARLIER_MS} ms), plain {vit_plain_ms:.4f} ms; forward "
          f"{fwd_ms:.4f} ms at cluster {viterbi.CLUSTER} (group {table.group(viterbi.CLUSTER)} "
          f"lanes a column, values on chip {viterbi.keeps_values_on_chip(table)}), backtrack "
          f"{back_ms:.4f} ms; cudaOccupancyMaxActiveClusters {occupancy} at cluster "
          f"{viterbi.CLUSTER} for {rows} rows; the exchange probe (distributed-shared-memory "
          f"stores and one cluster barrier a frame) {exchange_ms:.4f} ms")
    print(f"viterbi bound {max(vit_terms.values()):.4f} ms by {vit_binding} (finite-pair "
          f"operations {vit_ops_ms:.4f}: {finite_pairs:.4e} add-and-compare pairs, "
          f"{table.n_finite} of {S * S} transitions finite; dense operations {vit_dense_ms:.4f}; "
          f"bytes {vit_bytes_ms:.4f}); the kernels run at "
          f"{vit_ms / max(vit_terms.values()):.2f}x it")
    paths = {"mel_db_mfcc": 0, "feature_stack": 0, "reconstruction": 0, "cqt_hpss": 0,
             "config1_files": 0}
    dp_entry = {
        "name": "beat_dp", "route": "cuda", "source": "librosa_tpu_torch/csrc/beat_dp.cu",
        "replaces": "librosa_tpu/beat.py:35 _beat_dp_scan (an XLA program: no Pallas kernel "
                    "computes the beat DP)",
        "launches": counts["beat_dp"] + bench_counts["beat_dp"],
        "launches_by_path": {**paths, "onset_beat_pyin": counts["beat_dp"],
                             "config5_bench_1d": bench_counts["beat_dp"]},
        "max_abs_err": dp_err, "ms": dp_ms, "kernel_ms": dp_ms, "plain_ms": dp_plain_ms,
        "bound_ms": max(dp_bytes_ms, dp_ops_ms),
        "bound_by": "bytes" if dp_bytes_ms >= dp_ops_ms else "operations",
        "library_ms": None, "dependent_steps": dp_steps, "ns_per_step": 1e6 * dp_ms / dp_steps,
        "chain_bound_ms": dp_chain_ms, "binding_term": dp_binding,
    }
    vit_entry = {
        "name": "viterbi", "route": "cuda", "source": "librosa_tpu_torch/csrc/viterbi.cu",
        "replaces": "librosa_tpu/sequence.py:609 _viterbi_scan (an XLA program: no Pallas kernel "
                    "computes the Viterbi scan)",
        "launches": counts["viterbi"] + bench_counts["viterbi"],
        "launches_by_path": {**paths, "onset_beat_pyin": counts["viterbi"],
                             "config5_bench_1d": bench_counts["viterbi"]},
        "launches_by_route": {**route_counts},
        "max_abs_err": float((vit_got[1] - vit_want[1]).abs().max()), "ms": vit_ms,
        "kernel_ms": vit_ms, "forward_ms": fwd_ms, "backtrack_ms": back_ms,
        "plain_ms": vit_plain_ms,
        "bound_ms": max(vit_terms.values()), "bound_by": vit_binding,
        "ratio_to_bound": vit_ms / max(vit_terms.values()), "dense_bound_ms": vit_dense_ms,
        "bytes_bound_ms": vit_bytes_ms, "finite_pairs": finite_pairs,
        "cluster_blocks": viterbi.CLUSTER, "group_lanes": table.group(viterbi.CLUSTER),
        "max_active_clusters": occupancy, "chain_bound_ms": exchange_ms,
        "route_forward_ms": route_times, "library_ms": None, "states": S,
    }
    priors_entry["launches"] = counts["trough_priors"] + bench_counts["trough_priors"]
    priors_entry["launches_by_path"] = {**paths, "onset_beat_pyin": counts["trough_priors"],
                                        "config5_bench_1d": bench_counts["trough_priors"]}
    return {"launches": counts, "bench_launches": bench_counts, "beat_dp": dp_entry,
            "viterbi": vit_entry, "trough_priors": priors_entry, "e2e_ms": e2e_ms}


# ---------------------------------------------------------------------------
# Phases 4j and 4k: alignment and structure; effects
# ---------------------------------------------------------------------------

STRUCT_PERIOD_S = 5.0      # bench.py's synthetic chirp: 110 Hz to 8 kHz in 5 s, tiled
STRUCT_NOISE = 0.01        # a seeded noise floor 40 dB under the chirp
AFFINITY_RTOL = 1e-4       # the recurrence golden's rtol: float32 distances into exp(-d / bw)
NN_FILTER_RTOL = 1e-6      # a float64 mean over the same neighbours, stored as float32
DTW_RTOL = 1e-9            # the same float64 costs accumulated in another order
RQA_FRAMES = 2048          # the RQA DP is host numpy over N x M cells: cut to 2048 frames
RQA_CORNER = 384           # cells checked against a scalar float64 loop (it runs in Python)
MIN_STRETCH_SNR_DB = 45.0  # the time_stretch / pitch_shift goldens' floor (float32 phase sums)
MIN_PV_MAG_SNR_DB = 60.0   # the phase_vocoder golden's floor, on the magnitudes
MIN_PRE_SNR_DB = 130.0     # an FIR of two taps in float32: 148 dB on the CPU
MIN_DE_SNR_DB = 120.0      # the doubling scan in float32: 132.5 dB on the CPU (golden 125)
TRIM_TIE_DB = 1e-3         # a frame this close to the threshold in float64 may go either way
F1_START = 3 * SR          # where the copy of track 0 falls silent ...
F1_SILENCE = SR // 2       # ... for 11025 samples: 17 whole frames of zeros at n_fft 2048


def chirp_batch(torch, L, device):
    """The structure phase's input: bench.py's 5 s chirp tiled to ``MAIN_SHAPE``, each track
    started at its own point of the sweep, over a seeded noise floor, as float32 on ``device``."""
    rows, n = MAIN_SHAPE
    base = np.asarray(L.chirp(fmin=110, fmax=8000, sr=SR, duration=STRUCT_PERIOD_S))
    tiled = np.tile(base, -(-n // len(base)) + 1)
    shift = len(base) // rows
    y = np.stack([tiled[r * shift:r * shift + n] for r in range(rows)])
    y = y + STRUCT_NOISE * np.random.RandomState(7).randn(rows, n)
    return torch.from_numpy(y.astype(np.float32)).to(device)


def knn64(Q, C, m, *, exclude_self):
    """The ``m`` nearest rows of ``C`` to each row of ``Q`` in float64 numpy: (dist, idx), nearest first."""
    Q = np.asarray(Q, np.float64)
    C = np.asarray(C, np.float64)
    mu = C.mean(axis=0)
    Q, C = Q - mu, C - mu
    c_sq = np.sum(C * C, axis=1)
    dist = np.empty((len(Q), m))
    idx = np.empty((len(Q), m), dtype=np.int64)
    for s in range(0, len(Q), 1024):
        q = Q[s:s + 1024]
        d = np.sqrt(np.maximum(np.sum(q * q, axis=1)[:, None] + c_sq[None] - 2 * q @ C.T, 0))
        if exclude_self:
            rows = np.arange(len(q))
            d[rows, s + rows] = np.inf
        part = np.argpartition(d, m, axis=1)[:, :m + 1]
        pd = np.take_along_axis(d, part, axis=1)
        order = np.lexsort((part, pd), axis=1)[:, :m]
        idx[s:s + 1024] = np.take_along_axis(part, order, axis=1)
        dist[s:s + 1024] = np.take_along_axis(pd, order, axis=1)
    return dist, idx


def pair_dist64(Q, C, rows, cols):
    """Float64 distances of the pairs (``rows[i]``, ``cols[i]``)."""
    Q = np.asarray(Q, np.float64)
    C = np.asarray(C, np.float64)
    return np.sqrt(np.sum((Q[rows] - C[cols]) ** 2, axis=1))


def check_neighbours(label, d32, i32, Q, C, m, *, exclude_self):
    """The card's ``m`` nearest candidates against float64: the same sets, except near-ties.

    A near-tie is a candidate that only one side keeps and whose float64
    distance lies within the float32 search's own error of the m-th
    distance: four times the largest gap between the card's distance and
    float64's over that row's candidates. They are named. Returns the count.
    """
    d64, i64 = knn64(Q, C, m, exclude_self=exclude_self)
    n = len(Q)
    rows = np.repeat(np.arange(n), m)
    own64 = pair_dist64(Q, C, rows, i32.ravel()).reshape(n, m)
    err = np.abs(d32.astype(np.float64) - own64).max(axis=1)
    tol = 4 * np.maximum(err, 1e-12 * d64[:, -1])
    ties, bad = [], []
    for r in np.flatnonzero(np.any(np.sort(i32, axis=1) != np.sort(i64, axis=1), axis=1)):
        only = np.setxor1d(i32[r], i64[r])
        gaps = np.abs(pair_dist64(Q, C, np.full(len(only), r), only) - d64[r, -1])
        (ties if np.all(gaps <= tol[r]) else bad).append((int(r), only.tolist(),
                                                          float(gaps.max()), float(tol[r])))
    print(f"{label}: {n} frames x {m} candidates against float64: {len(ties)} frames differ "
          f"at near-ties{' ' + str(ties[:8]) if ties else ''}; largest float32 distance error "
          f"{float(err.max()):.3e} (largest m-th distance {float(d64[:, -1].max()):.4g})")
    if bad:
        raise AssertionError(f"{label}: candidates differ from float64 beyond near-ties "
                             f"(frame, candidates, gap, tolerance): {bad[:8]}")
    return len(ties)


def recurrence_from_candidates(i32, n, k, width, *, nearest):
    """The kept links of a recurrence matrix, as a set of (neighbour, frame) pairs, from the
    candidates: drop |i - j| < width, then keep ``k`` (the nearest, or the lowest indices)."""
    links = set()
    for j, cand in enumerate(i32):
        cand = [int(c) for c in cand if abs(int(c) - j) >= width]
        for c in (cand[:k] if nearest else sorted(cand)[:k]):
            links.add((c, j))
    return links


def dtw64(C):
    """Accumulated DTW cost in float64 numpy by anti-diagonals (steps (1,1), (0,1), (1,0))."""
    N, M = C.shape
    D = np.full((N, M), np.inf)
    D[0] = np.cumsum(C[0])
    D[:, 0] = np.cumsum(C[:, 0])
    for s in range(2, N + M - 1):
        i = np.arange(max(1, s - M + 1), min(N - 1, s - 1) + 1)
        j = s - i
        D[i, j] = C[i, j] + np.minimum(np.minimum(D[i - 1, j - 1], D[i - 1, j]), D[i, j - 1])
    return D


def rqa64(sim, n, gap_onset=1.0, gap_extend=1.0):
    """RQA's score over the top-left ``n x n`` cells, by a scalar float64 loop (knight moves on)."""
    sim = np.asarray(sim, np.float64)[:n, :n].tolist()
    score = [[0.0] * n for _ in range(n)]
    for i in range(n):
        score[i][0] = sim[i][0]
        score[0][i] = sim[0][i]
    for i in range(1, n):
        for j in range(1, n):
            cands = []
            for di, dj in ((1, 1), (1, 2), (2, 1)):
                if i >= di and j >= dj:
                    cands.append((score[i - di][j - dj], sim[i - di][j - dj] > 0))
                else:
                    cands.append((0.0, False))
            if sim[i][j] > 0:
                score[i][j] = max(s for s, _ in cands) + sim[i][j]
            else:
                score[i][j] = max(0.0, max(s - (gap_onset if t else gap_extend)
                                           for s, t in cands))
    return np.array(score)


def structure_phase(torch, L, device, win) -> dict:
    """Phase 4j: alignment and structure on the chirp batch, checked against float64 and timed."""
    import scipy.sparse
    import scipy.spatial.distance

    from librosa_tpu_torch.ops import db_scale, fused_stft, knn, median, ola_norm

    y = chirp_batch(torch, L, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    fused_stft.launches = db_scale.launches = ola_norm.launches = median.launches = 0
    mfcc = L.feature.mfcc(y=y, sr=SR)
    chroma = L.feature.chroma_stft(y=y, sr=SR)
    torch.cuda.synchronize()
    X0, X1 = mfcc[0], mfcc[1]
    t = X0.shape[-1]
    times = {}

    def host_s(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    R, times["recurrence connectivity (search + host graph)"] = host_s(
        lambda: L.segment.recurrence_matrix(X0))
    A, times["recurrence affinity, sparse"] = host_s(
        lambda: L.segment.recurrence_matrix(X0, mode="affinity", sparse=True))
    lag, times["recurrence_to_lag, sparse"] = host_s(
        lambda: L.segment.recurrence_to_lag(scipy.sparse.csc_matrix(R)))
    xsim, times["cross_similarity"] = host_s(lambda: L.segment.cross_similarity(X1, X0))
    nn, times["nn_filter (search + host product)"] = host_s(
        lambda: L.decompose.nn_filter(chroma[0]))
    (D, wp), times["dtw (card cost + host DP + backtrack)"] = host_s(
        lambda: L.sequence.dtw(X=chroma[0], Y=chroma[1]))
    sim, times["rqa input: cosine affinity, sym"] = host_s(
        lambda: L.segment.recurrence_matrix(chroma[0][:, :RQA_FRAMES], mode="affinity",
                                            metric="cosine", sym=True))
    (score, path), times["rqa (host DP + backtrack)"] = host_s(lambda: L.sequence.rqa(sim))
    counts = {"stft_mel": fused_stft.launches, "db_scale": db_scale.launches,
              "ola_norm": ola_norm.launches, "median_filter": median.launches}
    peak_bytes = torch.cuda.max_memory_allocated()
    print(f"structure: y {tuple(y.shape)} -> mfcc {tuple(mfcc.shape)}, chroma "
          f"{tuple(chroma.shape)}; R {R.shape} {R.dtype}, A {A.shape} {A.format} ({A.nnz} links), "
          f"lag {lag.shape}, xsim {xsim.shape}, nn_filter {nn.shape}, D {D.shape}, path "
          f"{wp.shape}, rqa score {score.shape}, path {path.shape}; launches {counts}; peak "
          f"memory {peak_bytes} bytes, {peak_bytes - base_bytes} above the {base_bytes} held "
          f"before")
    if counts["stft_mel"] < 2 or counts["ola_norm"] or counts["median_filter"]:
        raise AssertionError(f"structure launched {counts}: the mel kernel carries mfcc and "
                             "chroma, no synthesis or median")
    if R.shape != (t, t) or R.dtype != bool or xsim.shape != (t, t) or D.shape != (t, t):
        raise AssertionError(f"structure shapes {R.shape} {R.dtype}, {xsim.shape}, {D.shape}")

    # K1 at this path's input against its plain version, track by track
    mel_basis = L.filters.mel(sr=SR, n_fft=2048, n_mels=128)
    win_d = torch.from_numpy(win.astype(np.float32)).to(device)
    basis_d = torch.from_numpy(mel_basis.astype(np.float32)).to(device)
    got = checked_kernel(torch, fused_stft, y, win_d, basis_d, n_fft=2048, hop_length=512)
    want = fused_stft.stft_mel_reference(y, win_d, basis_d, n_fft=2048, hop_length=512)
    err = (got.double() - want.double()).square().sum(dim=(-2, -1))
    k1_snr = float((10 * torch.log10(want.double().square().sum(dim=(-2, -1))
                                     / err.clamp(min=1e-300))).min())
    print(f"stft_mel kernel vs plain on the chirp batch, worst track: {k1_snr:.1f} dB "
          f"(floor {MIN_SNR_DB})")
    if not k1_snr >= MIN_SNR_DB:
        raise AssertionError(f"stft_mel on the chirp batch: {k1_snr:.1f} dB < {MIN_SNR_DB}")
    del got, want, err

    # the searches against float64: the card's candidates, then the graphs built from them
    Q0, Q1 = X0.T.cpu().numpy(), X1.T.cpu().numpy()
    width = 1
    k = int(2 * np.ceil(np.sqrt(t - 2 * width + 1)))
    m = min(t - 1, k + 2 * width)
    d32, i32 = knn.topm(X0.T, X0.T, m, exclude_self=True)
    ties = check_neighbours("recurrence search (mfcc, track 0)", d32, i32, Q0, Q0, m,
                            exclude_self=True)
    links = recurrence_from_candidates(i32, t, k, width, nearest=False)
    got_links = set(zip(*(v.tolist() for v in np.nonzero(R))))
    if got_links != links:
        raise AssertionError(f"recurrence connectivity: {len(got_links ^ links)} links differ "
                             "from the pruning rule applied to the card's candidates")
    # affinity: the k nearest after the band, exp(-d64 / median of each frame's k-th distance)
    near = recurrence_from_candidates(i32, t, k, width, nearest=True)
    cols, rows = np.array(sorted((j, i) for i, j in near)).T
    d_link = pair_dist64(Q0, Q0, cols, rows)
    kth = np.full(t, -np.inf)
    np.maximum.at(kth, cols, d_link)
    aff64 = np.exp(-d_link / np.nanmedian(np.where(np.isfinite(kth), kth, np.nan)))
    got_aff = np.asarray(A[rows, cols]).ravel()
    aff_err = float(np.max(np.abs(got_aff - aff64) / aff64))
    print(f"recurrence affinity against float64 over {len(aff64)} links: max relative error "
          f"{aff_err:.3e} (rtol {AFFINITY_RTOL})")
    if A.nnz != len(aff64) or not aff_err <= AFFINITY_RTOL:
        raise AssertionError(f"recurrence affinity: {A.nnz} links, relative error {aff_err:.3e}")
    lag_rows, lag_cols = lag.nonzero()
    want_lag = {((i - j) % (2 * t), j) for i, j in got_links}
    if set(zip(lag_rows.tolist(), lag_cols.tolist())) != want_lag or lag.shape != (2 * t, t):
        raise AssertionError("recurrence_to_lag: links not at (i - j mod 2n, j)")
    k_x = int(min(t, 2 * np.ceil(np.sqrt(t))))
    dx, ix = knn.topm(X1.T, X0.T, k_x)
    ties += check_neighbours("cross_similarity search (mfcc, track 1 against 0)", dx, ix, Q1,
                             Q0, k_x, exclude_self=False)
    want_x = {(int(c), j) for j, row in enumerate(ix) for c in row}
    if set(zip(*(v.tolist() for v in np.nonzero(xsim)))) != want_x:
        raise AssertionError("cross_similarity links differ from the card's candidates")

    # nn_filter: the chroma graph against float64, then the mean over it in float64
    S0 = chroma[0].cpu().numpy()
    dc, ic = knn.topm(chroma[0].T, chroma[0].T, m, exclude_self=True)
    ties += check_neighbours("nn_filter search (chroma, track 0)", dc, ic, S0.T, S0.T, m,
                             exclude_self=True)
    nbrs = [[] for _ in range(t)]
    for i, j in recurrence_from_candidates(ic, t, k, width, nearest=False):
        nbrs[j].append(i)
    S64 = S0.astype(np.float64)
    want_nn = np.stack([S64[:, sorted(v)].mean(axis=1) if v else S64[:, j]
                        for j, v in enumerate(nbrs)], axis=1)
    nn_err = float(np.max(np.abs(nn - want_nn) / np.maximum(np.abs(want_nn), 1e-30)))
    print(f"nn_filter against a float64 mean over the same neighbours: max relative error "
          f"{nn_err:.3e} (rtol {NN_FILTER_RTOL})")
    if not nn_err <= NN_FILTER_RTOL:
        raise AssertionError(f"nn_filter: {nn_err:.3e} > {NN_FILTER_RTOL}")

    # dtw against a float64 anti-diagonal DP over scipy's float64 cost
    C0, C1 = chroma[0].T.cpu().double().numpy(), chroma[1].T.cpu().double().numpy()
    t0 = time.perf_counter()
    C64 = scipy.spatial.distance.cdist(C0, C1)
    D64 = dtw64(C64)
    times["float64 reference dtw (scipy cost + anti-diagonals)"] = time.perf_counter() - t0
    dtw_err = float(np.max(np.abs(D - D64) / np.maximum(D64, 1e-300)))
    steps = -np.diff(wp, axis=0)
    path_cost = float(C64[wp[:, 0], wp[:, 1]].sum())
    print(f"dtw {C64.shape} against float64: max relative error of D {dtw_err:.3e} (rtol "
          f"{DTW_RTOL}); path of {len(wp)} cells costs {path_cost:.10g}, D[-1, -1] "
          f"{float(D64[-1, -1]):.10g}")
    if not dtw_err <= DTW_RTOL:
        raise AssertionError(f"dtw D: {dtw_err:.3e} > {DTW_RTOL}")
    if (wp[0].tolist() != [t - 1, t - 1] or wp[-1].tolist() != [0, 0]
            or not all(tuple(s) in ((1, 1), (0, 1), (1, 0)) for s in steps)
            or not abs(path_cost - D64[-1, -1]) <= DTW_RTOL * D64[-1, -1]):
        raise AssertionError("dtw path: not a monotone path of the optimal cost")
    del C64, D64, D

    # rqa: the top-left corner against a scalar float64 loop, bit for bit; the path's moves
    t0 = time.perf_counter()
    want_score = rqa64(sim, RQA_CORNER)
    times[f"float64 reference rqa ({RQA_CORNER}^2 cells, scalar)"] = time.perf_counter() - t0
    path = path.astype(np.int64)
    moves = np.diff(path, axis=0)
    if not np.array_equal(score[:RQA_CORNER, :RQA_CORNER], want_score):
        raise AssertionError("rqa score: the corner differs from the scalar float64 loop")
    if (len(path) == 0 or tuple(path[-1]) != np.unravel_index(np.argmax(score), score.shape)
            or not all(tuple(mv) in ((1, 1), (1, 2), (2, 1)) for mv in moves)):
        raise AssertionError("rqa path: does not end at the best score by the DP's moves")
    print(f"rqa on {sim.shape} (cut from {t} frames): the {RQA_CORNER}^2 corner bit-equal to a "
          f"scalar float64 loop; path of {len(path)} cells to the best score "
          f"{float(score.max()):.6g}; {ties} near-tie frames in all")

    # device parts alone, by CUDA events
    device_ms = {
        "mfcc (16 tracks)": time_ms(torch, lambda: L.feature.mfcc(y=y, sr=SR), 3),
        "chroma_stft (16 tracks)": time_ms(torch, lambda: L.feature.chroma_stft(y=y, sr=SR), 3),
        "topm, recurrence (8193 x 8193, m 184)": time_ms(
            torch, lambda: knn.topm(X0.T, X0.T, m, exclude_self=True), 3),
        "dtw cost on the card (torch.cdist float64)": time_ms(
            torch, lambda: torch.cdist(chroma[0].T.double(), chroma[1].T.double(),
                                       compute_mode="donot_use_mm_for_euclid_dist"), 3),
    }
    Xc = (X0.T - X0.T.mean(dim=0)).contiguous()
    block = Xc[:4096]
    device_ms["topm block: product + sort (4096 x 8193, exact f32)"] = time_ms(
        torch, lambda: knn._topm_block(block, Xc, None, 0, m=m, exclude_self=False,
                                       take_sqrt=False), 3)
    dist_blk = torch.rand(4096, t, device=device)
    device_ms["topm block sort alone (4096 x 8193, stable)"] = time_ms(
        torch, lambda: torch.sort(dist_blk, dim=1, stable=True), 5)
    del dist_blk
    print("structure device times (ms, CUDA events): "
          + ", ".join(f"{k} {v:.4f}" for k, v in device_ms.items()))
    print("structure host times (s, host clock): "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    return {"launches": counts, "device_ms": device_ms, "host_s": times,
            "peak_bytes": peak_bytes - base_bytes}


def phase_vocoder64(D, rate):
    """The phase vocoder in float64 numpy: linear magnitudes, summed phase advances."""
    n = D.shape[-1]
    t = np.arange(0.0, n, rate)
    i0 = np.floor(t).astype(np.int64)
    i1 = np.minimum(i0 + 1, n - 1)
    ph = np.where(D == 0, 0.0, np.angle(D))  # an exact-zero bin has phase 0, as in the port
    phase = np.cumsum(np.concatenate([ph[:, i0[:1]], (ph[:, i1] - ph[:, i0])[:, :-1]], axis=1),
                      axis=1)
    i0e = np.clip(i0, 0, n - 2)
    frac = t - i0e
    mag = np.abs(D)
    return (mag[:, i0e] * (1 - frac) + mag[:, i0e + 1] * frac) * np.exp(1j * phase)


def effects_phase(torch, L, device, y, win) -> dict:
    """Phase 4k: the effects on the main buffer, each against float64 numpy on track 0; the
    synthesis and dB kernels at these shapes against their plain versions; times."""
    import scipy.signal

    from librosa_tpu_torch.core import spectrum
    from librosa_tpu_torch.ops import db_scale, fused_stft, median, ola_norm

    rows, n = MAIN_SHAPE
    ys = y.clone()  # silence at both ends and in the middle, so that trim and split have work
    q = n // 4
    ys[:, :q] = 0
    ys[:, 2 * q:2 * q + q // 4] = 0
    ys[:, n - q // 2:] = 0
    ys *= torch.linspace(0.2, 1.0, rows, device=device)[:, None]
    iv = np.array([[0, q], [2 * q, 3 * q], [q, 2 * q]])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    fused_stft.launches = db_scale.launches = ola_norm.launches = median.launches = 0
    out = {"stretch 1.25": L.effects.time_stretch(y, rate=1.25),
           "stretch 0.8": L.effects.time_stretch(y, rate=0.8),
           "pitch +3": L.effects.pitch_shift(y, sr=SR, n_steps=3, res_type="fft"),
           "remix": L.effects.remix(y, iv, align_zeros=False),
           "remix zeros": L.effects.remix(y, iv, align_zeros=True)}
    yt, idx = L.effects.trim(ys)
    intervals = L.effects.split(ys)
    out["pre"] = L.effects.preemphasis(y)
    out["de"] = L.effects.deemphasis(out["pre"])
    torch.cuda.synchronize()
    counts = {"stft_mel": fused_stft.launches, "db_scale": db_scale.launches,
              "ola_norm": ola_norm.launches, "median_filter": median.launches}
    peak_bytes = torch.cuda.max_memory_allocated()
    print(f"effects: y {tuple(y.shape)} -> " + ", ".join(f"{k} {tuple(v.shape)}"
                                                        for k, v in out.items())
          + f", trim {tuple(yt.shape)} at {idx.tolist()}, split {len(intervals)} intervals; "
          f"launches {counts}; peak memory {peak_bytes} bytes, {peak_bytes - base_bytes} above "
          f"the {base_bytes} held before")
    if counts != {"stft_mel": 0, "db_scale": 2, "ola_norm": 3, "median_filter": 0}:
        raise AssertionError(f"effects launched {counts}, expected db_scale 2 (trim, split), "
                             "ola_norm 3 (the stretches and the shift)")
    lengths = {"stretch 1.25": round(n / 1.25), "stretch 0.8": round(n / 0.8), "pitch +3": n,
               "remix": 3 * q, "pre": n, "de": n}
    for key, value in out.items():  # the zero-aligned remix's length depends on the crossings
        if (tuple(value.shape) != (rows, lengths.get(key, value.shape[-1]))
                or not bool(torch.isfinite(value).all())):
            raise AssertionError(f"effects {key}: shape {tuple(value.shape)} or not finite")

    # track 0 against float64 numpy and scipy
    y0 = y[0].cpu().numpy()
    D64 = stft64(y0, win, n_fft=2048, hop=512)
    snrs = {}
    for rate in (1.25, 0.8):
        want = istft64(phase_vocoder64(D64, rate), win, n_fft=2048, hop=512,
                       length=round(n / rate))
        snrs[f"stretch {rate}"] = snr_db(out[f"stretch {rate}"][0].cpu().numpy(), want)
    pv = L.phase_vocoder(L.stft(y[:1]), rate=0.8)[0].abs().cpu().numpy()
    snrs["phase_vocoder 0.8, |.|"] = snr_db(pv, np.abs(phase_vocoder64(D64, 0.8)))
    del pv
    rate = 2.0 ** (-3 / 12)
    slow = istft64(phase_vocoder64(D64, rate), win, n_fft=2048, hop=512, length=round(n / rate))
    # resample's length, from the rates as pitch_shift hands them over
    num = int(np.ceil(len(slow) * (float(SR) / (float(SR) / rate))))
    snrs["pitch +3"] = snr_db(out["pitch +3"][0].cpu().numpy(),
                              scipy.signal.resample(slow, num)[:n])
    y64 = y0.astype(np.float64)
    pre64 = scipy.signal.lfilter([1.0, -0.97], [1.0], y64, zi=[2 * y64[0] - y64[1]])[0]
    snrs["pre"] = snr_db(out["pre"][0].cpu().numpy(), pre64)
    p64 = out["pre"][0].cpu().double().numpy()
    start = ((2 - 0.97) * p64[0] - p64[1]) / (3 - 0.97)
    snrs["de"] = snr_db(out["de"][0].cpu().numpy(),
                        scipy.signal.lfilter([1.0], [1.0, -0.97], p64)
                        - start * 0.97 ** np.arange(n))
    floors = {"stretch 1.25": MIN_STRETCH_SNR_DB, "stretch 0.8": MIN_STRETCH_SNR_DB,
              "phase_vocoder 0.8, |.|": MIN_PV_MAG_SNR_DB,
              "pitch +3": MIN_STRETCH_SNR_DB, "pre": MIN_PRE_SNR_DB, "de": MIN_DE_SNR_DB}
    # a copy of track 0 with 11025 samples of exact silence: whole frames of zeros, whose
    # bins must keep phase 0 whatever the sign of zero cuFFT gives them
    y_sil = y[:1].clone()
    y_sil[:, F1_START:F1_START + F1_SILENCE] = 0
    D_sil = L.stft(y_sil)
    zero = D_sil == 0
    neg_zero = int((zero & torch.signbit(D_sil.real)).sum())
    del D_sil
    D64 = stft64(y_sil[0].cpu().numpy(), win, n_fft=2048, hop=512)
    snrs["silent stretch 0.8"] = snr_db(
        L.effects.time_stretch(y_sil, rate=0.8)[0].cpu().numpy(),
        istft64(phase_vocoder64(D64, 0.8), win, n_fft=2048, hop=512, length=round(n / 0.8)))
    rate = 2.0 ** (-2 / 12)
    slow = istft64(phase_vocoder64(D64, rate), win, n_fft=2048, hop=512, length=round(n / rate))
    num = int(np.ceil(len(slow) * (float(SR) / (float(SR) / rate))))
    snrs["silent pitch +2"] = snr_db(
        L.effects.pitch_shift(y_sil, sr=SR, n_steps=2, res_type="fft")[0].cpu().numpy(),
        scipy.signal.resample(slow, num)[:n])
    floors["silent stretch 0.8"] = floors["silent pitch +2"] = MIN_STRETCH_SNR_DB
    print(f"silent stretch: {int(zero.sum())} exact-zero bins in the card's STFT of the copy, "
          f"{neg_zero} of them with a real part of -0.0")
    del zero, y_sil
    print("effects track 0 vs float64 numpy/scipy: " + ", ".join(
        f"{k} {v:.1f} dB (floor {floors[k]})" for k, v in snrs.items()))
    for key, s in snrs.items():
        if not s >= floors[key]:
            raise AssertionError(f"effects {key}: {s:.1f} dB < {floors[key]}")
    del D64, slow

    # remix: the same samples as numpy slices, with bounds snapped to float64 zero crossings
    host = y.cpu().numpy()
    mono = host.astype(np.float64).mean(axis=0)
    signs = np.signbit(np.where(np.abs(mono) <= 1e-10, 0.0, mono))
    zeros = np.append(np.flatnonzero(np.concatenate([[True], signs[1:] != signs[:-1]])), n)
    snapped = [[int(zeros[np.argmin(np.abs(zeros - b))]) for b in pair] for pair in iv]
    for key, bounds in (("remix", iv.tolist()), ("remix zeros", snapped)):
        want = np.concatenate([host[:, a:b] for a, b in bounds], axis=1)
        if not np.array_equal(out[key].cpu().numpy(), want):
            raise AssertionError(f"effects {key}: not the samples of {bounds}")

    # trim and split: the loud frames by float64 RMS in dB against the peak, max over tracks
    rms = np.stack([np.sqrt(np.mean(np.lib.stride_tricks.sliding_window_view(
        np.pad(track, 1024), 2048)[::512] ** 2, axis=-1)) for track in ys.cpu().double().numpy()])
    level = (20 * np.log10(np.maximum(rms, 1e-5)) - 20 * np.log10(max(rms.max(), 1e-5))).max(0)
    loud = level > -60
    near = np.flatnonzero(np.abs(level + 60) <= TRIM_TIE_DB)
    edges = np.diff(np.concatenate([[0], loud.astype(np.int8), [0]]))
    want_iv = np.minimum(np.stack([np.flatnonzero(edges > 0), np.flatnonzero(edges < 0)], 1)
                         * 512, n)
    want_idx = [int(want_iv[0, 0]), int(want_iv[-1, 1])]
    print(f"trim {idx.tolist()} / split {intervals.tolist()} against float64: "
          f"{idx.tolist() == want_idx and np.array_equal(intervals, want_iv)}; frames within "
          f"{TRIM_TIE_DB} dB of the threshold: {near.tolist()}")
    if not near.size and (idx.tolist() != want_idx or not np.array_equal(intervals, want_iv)):
        raise AssertionError(f"trim / split: {idx.tolist()}, {intervals.tolist()} against "
                             f"{want_idx}, {want_iv.tolist()}")
    if not torch.equal(yt, ys[:, idx[0]:idx[1]]):
        raise AssertionError("trim: not the samples between its bounds")

    # the synthesis kernel at the slow stretch's shape, and the dB kernel at trim's
    D = L.stft(y)
    Ds = L.phase_vocoder(D, rate=0.8)
    del D
    length = round(n / 0.8)
    _, _, hop, n_frames, start, out_len = spectrum._istft_geometry(
        Ds.shape, n_fft=None, win_length=None, hop_length=None, center=True, length=length)
    win_s = torch.from_numpy(win.astype(np.float32)).to(device)
    wss = spectrum._wss_device("hann", n_frames=n_frames, win_length=2048, n_fft=2048,
                               hop_length=hop, start=start, out_len=out_len, device=device,
                               dtype=torch.float32)
    fr = torch.fft.irfft(Ds[..., :n_frames].transpose(-2, -1), n=2048, dim=-1)
    del Ds
    poison(torch, (rows, out_len), device)
    got = ola_norm.ola_norm(fr, win_s, wss, hop_length=hop, start=start)
    want = ola_norm.ola_norm_reference(fr, win_s, wss, hop_length=hop, start=start)
    if not torch.equal(got, want):
        raise AssertionError("ola_norm at the stretch's shape: not bit-equal to its plain version")
    ola_ms = time_ms(torch, lambda: ola_norm.ola_norm(fr, win_s, wss, hop_length=hop,
                                                      start=start), 5)
    del fr, got, want
    mse = L.feature.rms(y=ys)[..., 0, :]
    got = db_scale.db_scale(mse, ref=np.max, amin=1e-5, top_db=None, axes=(-2, -1),
                            amplitude=True)
    want = db_scale.db_scale_reference(mse, ref=np.max, amin=1e-5, top_db=None, axes=(-2, -1),
                                       amplitude=True)
    if not bool(((got - want).abs() <= DB_ATOL).all()):
        raise AssertionError("db_scale at trim's shape: beyond its atol from the plain version")
    print(f"ola_norm at the 0.8 stretch's shape {(rows, out_len)}: "
          f"bit-equal to plain, {ola_ms:.4f} ms; db_scale at trim's {tuple(mse.shape)}: within "
          f"{DB_ATOL} dB of plain")

    D = L.stft(y)
    times = {
        "time_stretch 1.25": time_ms(torch, lambda: L.effects.time_stretch(y, rate=1.25), 2),
        "time_stretch 0.8": time_ms(torch, lambda: L.effects.time_stretch(y, rate=0.8), 2),
        "phase_vocoder 0.8 alone": time_ms(torch, lambda: L.phase_vocoder(D, rate=0.8), 2),
        "pitch_shift +3 (fft)": time_ms(torch, lambda: L.effects.pitch_shift(
            y, sr=SR, n_steps=3, res_type="fft"), 2),
        "preemphasis": time_ms(torch, lambda: L.effects.preemphasis(y), 5),
        "deemphasis (doubling scan)": time_ms(torch, lambda: L.effects.deemphasis(out["pre"]),
                                              5),
        "trim": time_ms(torch, lambda: L.effects.trim(ys), 5),
        "split": time_ms(torch, lambda: L.effects.split(ys), 5),
        "remix (device slices)": time_ms(torch, lambda: L.effects.remix(y, iv,
                                                                        align_zeros=False), 5),
    }
    del D
    t0 = time.perf_counter()
    L.effects.remix(y, iv, align_zeros=True)
    torch.cuda.synchronize()
    host_s = {"remix with zero crossings (host copy and mean)": time.perf_counter() - t0}
    print("effects times (ms, CUDA events): "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    print("effects host times (s, host clock): "
          + ", ".join(f"{k} {v:.4f}" for k, v in host_s.items()))
    return {"launches": counts, "device_ms": times, "host_s": host_s,
            "peak_bytes": peak_bytes - base_bytes, "ola_ms": ola_ms}


MIN_DESCRIPTOR_SNR_DB = 100.0   # bandwidth (the golden asks 55), contrast, flatness, poly: float32
                                # sums of |STFT| over 1025 bins (126-146 dB on the CPU, 2 tracks)
MIN_TONNETZ_SNR_DB = 110.0      # the chroma projection, then a 6 x 12 product (124.8 on the CPU)
MIN_DELTA_SNR_DB = 120.0        # nine-tap float32 sums against float64 savgol_filter (140.2)
MIN_MFCC_TO_MEL_SNR_DB = 120.0  # one float32 product and 10**(x / 10) (144.8)
MIN_NNLS_FIT_SNR_DB = 100.0     # mel projection of the float32 FISTA against float64's (124.5)
NNLS_OBJECTIVE_RATIO = 1.5      # the float32 objective at most this times float64's (1.0)
NNLS_FRAMES = 128               # track 0's frames solved again by the float64 FISTA (host)
MAX_GL_CONVERGENCE = 0.25       # || |STFT(y)| - S || / ||S|| after 32 rounds, S from the NNLS
                                # (0.152 on the CPU)
MIN_PCEN_SNR_DB = 110.0         # the pcen golden's 90 dB; a float32 doubling scan (125.9-128.0)
MIN_PCEN_STREAM_SNR_DB = 120.0  # two halves joined by zi / zf against the whole (139.8)
MIN_REASSIGN_SNR_DB = 120.0     # a quotient of float32 spectra, bins above 1e-3 of the peak
                                # (140.5-151.3)
MIN_IIRT_SNR_DB = 120.0         # the iirt golden's floor (145.6 on the CPU)
MIN_FMT_SNR_DB = 115.0          # a float32 spline solve, then an FFT (132.4 on 2**14 samples)
FMT_SAMPLES = 1 << 18           # fmt's default grid grows as n log n: 66.9 M points a track at 2**22


def db64(x, top_db=80.0):
    db = 10 * np.log10(np.maximum(1e-10, x))
    return np.maximum(db, db.max() - top_db)


def descriptors64(S, *, sr, n_fft):
    """Bandwidth, contrast, flatness and order-2 polynomial fits of a float64 |STFT| (F, T).

    The contrast's octave bands are the package's own host table (numpy, the
    same on the card and the CPU, where the tests hold it against the JAX
    package); what is checked here is the arithmetic on the device."""
    from librosa_tpu_torch.feature.spectral import _contrast_bands

    freq = np.fft.rfftfreq(n_fft, 1.0 / sr)
    Sn = S / np.maximum(S.sum(axis=0, keepdims=True), np.finfo(np.float32).tiny)
    centroid = (freq[:, None] * Sn).sum(axis=0, keepdims=True)
    bandwidth = np.sqrt((Sn * (freq[:, None] - centroid) ** 2).sum(axis=0, keepdims=True))
    peaks, valleys = [], []
    for members, n_take in _contrast_bands(freq, sr=sr, fmin=200.0, n_bands=6, quantile=0.02):
        ordered = np.sort(S[members], axis=0)
        valleys.append(ordered[:n_take].mean(axis=0))
        peaks.append(ordered[-n_take:].mean(axis=0))
    contrast = db64(np.stack(peaks)) - db64(np.stack(valleys))
    P = np.maximum(1e-10, S**2)
    flatness = np.exp(np.log(P).mean(axis=0, keepdims=True)) / P.mean(axis=0, keepdims=True)
    poly = np.linalg.pinv(np.vander(freq, 3)) @ S
    return {"spectral_bandwidth": bandwidth, "spectral_contrast": contrast,
            "spectral_flatness": flatness, "poly_features (order 2)": poly}


def fista64(A, B, x0, n_iter=300):
    """The JAX package's NNLS FISTA in float64 numpy from the start ``x0``."""
    AtA, AtB = A.T @ A, A.T @ B
    v = np.ones(AtA.shape[0]) / np.sqrt(AtA.shape[0])
    for _ in range(30):
        w = AtA @ v
        v = w / (np.linalg.norm(w) + 1e-30)
    step = 1.0 / (v @ AtA @ v + 1e-12)
    x, yk, t = x0, x0, 1.0
    for _ in range(n_iter):
        x_new = np.maximum(0.0, yk - step * (AtA @ yk - AtB))
        t_new = 0.5 * (1 + np.sqrt(1 + 4 * t * t))
        yk = x_new + ((t - 1) / t_new) * (x_new - x)
        x, t = x_new, t_new
    return x


def pcen64(S, *, sr, hop, b=None, max_size=1, gain=0.98, bias=2.0, power=0.5,
           time_constant=0.4, eps=1e-6):
    """pcen of a float64 (F, T) power spectrogram by scipy's lfilter, zi = 1 - b as the port's."""
    import scipy.ndimage
    import scipy.signal

    if b is None:
        t_frames = time_constant * sr / float(hop)
        b = (np.sqrt(1 + 4 * t_frames**2) - 1) / (2 * t_frames**2)
    ref = S if max_size == 1 else scipy.ndimage.maximum_filter1d(S, max_size, axis=0,
                                                                  mode="nearest")
    M = scipy.signal.lfilter([b], [1, b - 1], ref, axis=-1,
                             zi=np.full(S.shape[:-1] + (1,), 1.0 - b))[0]
    smooth = np.exp(-gain * (np.log(eps) + np.log1p(M / eps)))
    return (bias**power) * np.expm1(power * np.log1p(S * smooth / bias))


def iirt64(y_groups, sos_groups, *, n_frames, hop, win, sr):
    """iirt's frame energies in float64: scipy sosfiltfilt per band of each group's signal."""
    import scipy.signal

    out = []
    for cur_sr, y in y_groups.items():
        factor = sr / cur_sr
        hop_g, win_g = hop / factor, round(win / factor)
        n_rs = len(y)
        start = np.arange(0, n_rs - win_g, hop_g)
        pad_to = n_rs
        if len(start) < n_frames:
            pad_to = int(np.ceil(n_frames * hop_g)) + win_g
            start = np.arange(0, pad_to - win_g, hop_g)
        idx = np.round(start).astype(np.int64)[:n_frames]
        csum = None
        for sos in sos_groups[cur_sr]:
            f = np.pad(scipy.signal.sosfiltfilt(sos, y), (0, pad_to - n_rs))
            csum = np.concatenate([[0.0], np.cumsum(f * f)])  # float64 sums of squares
            out.append(factor * (csum[idx + win_g] - csum[idx]))
    return np.stack(out)


class CallSpy:
    """Records the arguments of the calls to ``module.name`` made inside a ``with`` block (the
    last ``keep`` of them) and passes each call on unchanged: a wrapper's count still rises
    once a launch, and a kernel can then be held against its plain version on exactly the
    inputs a path gave it."""

    def __init__(self, module, name, keep):
        self.module, self.name, self.keep, self.calls = module, name, keep, []

    def __enter__(self):
        inner = self.inner = getattr(self.module, self.name)

        def spy(*args, **kw):
            self.calls = (self.calls + [(args, kw)])[-self.keep:]
            return inner(*args, **kw)

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


def features_inversion_phase(torch, L, device, y, win) -> dict:
    """Phase 4l: the spectral descriptors, tonnetz, delta, stack_memory and the inversions on the
    main buffer and the chirp batch, each against float64 numpy on track 0; times, peak memory."""
    import scipy.fft
    import scipy.signal

    from librosa_tpu_torch.feature.spectral import _contrast_bands
    from librosa_tpu_torch.ops import db_scale, fused_stft, median, ola_norm

    rows, n = MAIN_SHAPE
    chirps = chirp_batch(torch, L, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    fused_stft.launches = db_scale.launches = ola_norm.launches = median.launches = 0
    # the spies keep the inputs of contrast's two dB calls and of the last synthesis
    with CallSpy(db_scale, "db_scale", keep=2) as db_spy, \
            CallSpy(ola_norm, "ola_norm", keep=1) as ola_spy:
        out = {"spectral_bandwidth": L.feature.spectral_bandwidth(y=y, sr=SR),
               "spectral_contrast": L.feature.spectral_contrast(y=y, sr=SR),
               "spectral_flatness": L.feature.spectral_flatness(y=y),
               "poly_features (order 2)": L.feature.poly_features(y=y, sr=SR, order=2)}
        contrast_db_calls = db_spy.calls
        chroma = L.feature.chroma_stft(y=y, sr=SR, tuning=0.0)
        out["tonnetz"] = L.feature.tonnetz(chroma=chroma)
        mfcc = L.feature.mfcc(y=y, sr=SR)
        out["delta 1"] = L.feature.delta(mfcc)
        out["delta 2"] = L.feature.delta(mfcc, order=2)
        out["stack_memory"] = L.feature.stack_memory(mfcc, n_steps=3, delay=-2)
        out["mfcc_to_mel"] = L.feature.inverse.mfcc_to_mel(mfcc)
        M = L.feature.melspectrogram(y=chirps, sr=SR)
        out["mel_to_stft"] = L.feature.inverse.mel_to_stft(M, sr=SR)
        out["mel_to_audio (32 rounds)"] = L.feature.inverse.mel_to_audio(M, sr=SR, n_iter=32,
                                                                          length=n)
    torch.cuda.synchronize()
    counts = {"stft_mel": fused_stft.launches, "db_scale": db_scale.launches,
              "ola_norm": ola_norm.launches, "median_filter": median.launches}
    peak_bytes = torch.cuda.max_memory_allocated()
    print(f"features and inversion: y {tuple(y.shape)}, chirps {tuple(chirps.shape)} -> "
          + ", ".join(f"{k} {tuple(v.shape)}" for k, v in out.items())
          + f"; launches {counts}; peak memory {peak_bytes} bytes, {peak_bytes - base_bytes} "
          f"above the {base_bytes} held before")
    want = {"stft_mel": 7, "db_scale": 3, "ola_norm": 33, "median_filter": 0}
    if counts != want:
        raise AssertionError(f"features and inversion launched {counts}, expected {want} (K1: "
                             "four descriptors, chroma, mfcc, the chirps' mel; db_scale: "
                             "contrast's two and mfcc's; ola_norm: 32 rounds and the last istft)")
    if len(contrast_db_calls) != 2:
        raise AssertionError(f"spectral_contrast launched db_scale {len(contrast_db_calls)} "
                             "times, expected its peak's and its valley's")

    # the dB kernel on contrast's peaks and valleys, the synthesis kernel on the frames of
    # mel_to_audio's last istft: each against its plain version on the same inputs
    for (args, kw), part in zip(contrast_db_calls, ("peak", "valley")):
        want = db_scale.db_scale_reference(*args, **kw)
        poison(torch, tuple(want.shape), device)
        got = db_scale.db_scale(*args, **kw)
        err = float((got - want).abs().max())
        print(f"db_scale on contrast's {part} {tuple(args[0].shape)} {kw}: max |kernel - plain| "
              f"{err:.3g} dB (atol {DB_ATOL})")
        if not err <= DB_ATOL:
            raise AssertionError(f"db_scale on contrast's {part}: {err} dB from its plain version")
    (args, kw), = ola_spy.calls
    want = ola_norm.ola_norm_reference(*args, **kw)
    poison(torch, tuple(want.shape), device)
    got = ola_norm.ola_norm(*args, **kw)
    print(f"ola_norm on mel_to_audio's last frames {tuple(args[0].shape)} -> {tuple(got.shape)}: "
          f"bit-equal to plain: {bool(torch.equal(got, want))}")
    if not torch.equal(got, want):
        raise AssertionError("ola_norm at mel_to_audio's shape: not bit-equal to its plain version")
    del contrast_db_calls, db_spy, ola_spy, args, kw, got, want

    frames = 1 + n // 512
    for key, value in out.items():
        if not bool(torch.isfinite(value).all()):
            raise AssertionError(f"features {key}: not finite")
    shapes = {"spectral_contrast": (rows, 7, frames), "poly_features (order 2)": (rows, 3, frames),
              "tonnetz": (rows, 6, frames), "stack_memory": (rows, 60, frames),
              "mfcc_to_mel": (rows, 128, frames), "mel_to_stft": (rows, 1025, frames),
              "mel_to_audio (32 rounds)": (rows, n)}
    for key, value in out.items():
        if tuple(value.shape) != shapes.get(key, (rows, 20 if "delta" in key else 1, frames)):
            raise AssertionError(f"features {key}: shape {tuple(value.shape)}")

    # track 0 against float64 numpy and scipy
    S64 = spec64(y[0].cpu().numpy(), win, n_fft=2048, hop=512)
    want64 = descriptors64(S64, sr=SR, n_fft=2048)
    snrs = {k: snr_db(out[k][0].cpu().numpy(), v) for k, v in want64.items()}
    # witnesses for the contrast: from cuFFT's |STFT| (no K1), from K1's plain version, and
    # the port on the CPU from the same track; and where its largest error sits
    witness = {"cuFFT |stft|": L.stft(y).abs()}
    witness["K1's plain version"] = fused_stft.stft_mel_reference(
        y, torch.from_numpy(win.astype(np.float32)).to(device),
        torch.eye(1025, dtype=torch.float32, device=device), n_fft=2048, hop_length=512,
        power=1.0)
    for key, S_w in witness.items():
        got = L.feature.spectral_contrast(S=S_w, sr=SR)
        snrs[f"spectral_contrast from {key}"] = snr_db(got[0].cpu().numpy(),
                                                       want64["spectral_contrast"])
    del witness, S_w, got
    snrs["spectral_contrast on the CPU"] = snr_db(
        L.feature.spectral_contrast(y=y[:1].cpu(), sr=SR)[0].numpy(), want64["spectral_contrast"])
    err = np.abs(out["spectral_contrast"][0].cpu().numpy() - want64["spectral_contrast"])
    band, frame = np.unravel_index(err.argmax(), err.shape)
    members, n_take = _contrast_bands(np.fft.rfftfreq(2048, 1.0 / SR), sr=SR, fmin=200.0,
                                      n_bands=6, quantile=0.02)[band]
    col = np.sort(S64[members, frame])
    print(f"spectral_contrast's largest error {err.max():.4g} dB at band {band}, frame {frame}: "
          f"its float64 valley {col[:n_take].mean():.4g} lies "
          f"{20 * np.log10(np.median(col) / col[:n_take].mean()):.1f} dB below the band's median "
          "bin, where a float32 |STFT| keeps few digits on any route")
    chroma_basis = np.asarray(L.filters.chroma(sr=SR, n_fft=2048, tuning=0.0), np.float64)
    raw = chroma_basis @ S64**2
    c64 = raw / np.maximum(np.abs(raw).max(axis=0, keepdims=True), np.finfo(np.float32).tiny)
    angle = np.pi * np.linspace(0, 12, num=12, endpoint=False)
    phi = np.stack([r * f(k * angle) for k, r in ((7 / 6, 1.0), (3 / 2, 1.0), (2 / 3, 0.5))
                    for f in (np.sin, np.cos)])
    snrs["tonnetz"] = snr_db(out["tonnetz"][0].cpu().numpy(), phi @ (c64 / c64.sum(axis=0)))
    m64 = mfcc[0].cpu().double().numpy()
    for order in (1, 2):
        snrs[f"delta {order}"] = snr_db(out[f"delta {order}"][0].cpu().numpy(),
                                        scipy.signal.savgol_filter(m64, 9, order, deriv=order,
                                                                   mode="interp", axis=-1))
    m32 = mfcc[0].cpu().numpy()
    stacked = np.concatenate([np.pad(m32, ((0, 0), (0, 2 * k)))[:, -m32.shape[-1]:]
                              for k in range(3)])
    if not np.array_equal(out["stack_memory"][0].cpu().numpy(), stacked):
        raise AssertionError("stack_memory: not the shifted copies of the mfcc")
    logmel = scipy.fft.idct(np.pad(m64, ((0, 108), (0, 0))), type=2, norm="ortho", axis=0)
    snrs["mfcc_to_mel"] = snr_db(out["mfcc_to_mel"][0].cpu().numpy(), 10.0 ** (logmel / 10.0))

    # mel_to_stft: track 0's first NNLS_FRAMES frames by the float64 FISTA from the same start
    t0 = time.perf_counter()
    A = np.asarray(L.filters.mel(sr=SR, n_fft=2048), np.float64)
    B = M[0, :, :NNLS_FRAMES].cpu().double().numpy()
    pinv = np.linalg.pinv(A, rcond=10 * max(A.shape) * np.finfo(np.float32).eps)
    x64 = fista64(A, B, np.maximum(0.0, pinv @ B))
    nnls_host_s = time.perf_counter() - t0
    x32 = out["mel_to_stft"][0, :, :NNLS_FRAMES].cpu().double().numpy() ** 2
    objective = {k: float(np.linalg.norm(A @ x - B) / np.linalg.norm(B))
                 for k, x in (("float32 card", x32), ("float64 host", x64))}
    snrs["mel_to_stft fit A x"] = snr_db(A @ x32, A @ x64)
    nnls_x_snr = snr_db(np.sqrt(x32), np.sqrt(x64))
    print(f"mel_to_stft on track 0's first {NNLS_FRAMES} frames (the float64 FISTA runs on the "
          f"host: {nnls_host_s:.2f} s): objective ||A x - B|| / ||B|| {objective}, S itself "
          f"{nnls_x_snr:.1f} dB against float64 (the null space keeps its start's rounding)")
    if not objective["float32 card"] <= NNLS_OBJECTIVE_RATIO * objective["float64 host"] + 1e-7:
        raise AssertionError(f"mel_to_stft objective {objective}")

    # mel_to_audio: the spectral convergence of its 32 rounds against the NNLS magnitude
    S_nnls = out["mel_to_stft"]
    rebuilt = L.stft(out["mel_to_audio (32 rounds)"]).abs()
    convergence = float(torch.linalg.vector_norm(rebuilt - S_nnls)
                        / torch.linalg.vector_norm(S_nnls))
    del rebuilt
    floors = {"tonnetz": MIN_TONNETZ_SNR_DB,
              "delta 1": MIN_DELTA_SNR_DB, "delta 2": MIN_DELTA_SNR_DB,
              "mfcc_to_mel": MIN_MFCC_TO_MEL_SNR_DB, "mel_to_stft fit A x": MIN_NNLS_FIT_SNR_DB}
    print("features track 0 vs float64 numpy/scipy: " + ", ".join(
        f"{k} {v:.1f} dB (floor {floors.get(k, MIN_DESCRIPTOR_SNR_DB)})" for k, v in snrs.items())
        + f"; mel_to_audio convergence after 32 rounds {convergence:.4f} "
        f"(at most {MAX_GL_CONVERGENCE}); stack_memory equal")
    for key, s in snrs.items():
        if not s >= floors.get(key, MIN_DESCRIPTOR_SNR_DB):
            raise AssertionError(f"features {key}: {s:.1f} dB < {floors.get(key)}")
    if not convergence <= MAX_GL_CONVERGENCE:
        raise AssertionError(f"mel_to_audio convergence {convergence:.4f} > {MAX_GL_CONVERGENCE}")
    del out

    times = {
        "spectral_bandwidth": time_ms(torch, lambda: L.feature.spectral_bandwidth(y=y, sr=SR), 3),
        "spectral_contrast": time_ms(torch, lambda: L.feature.spectral_contrast(y=y, sr=SR), 3),
        "spectral_flatness": time_ms(torch, lambda: L.feature.spectral_flatness(y=y), 3),
        "poly_features (order 2)": time_ms(torch, lambda: L.feature.poly_features(y=y, sr=SR,
                                                                                  order=2), 3),
        "tonnetz (from chroma)": time_ms(torch, lambda: L.feature.tonnetz(chroma=chroma), 5),
        "delta (order 1)": time_ms(torch, lambda: L.feature.delta(mfcc), 5),
        "stack_memory": time_ms(torch, lambda: L.feature.stack_memory(mfcc, n_steps=3,
                                                                      delay=-2), 5),
        "mfcc_to_mel": time_ms(torch, lambda: L.feature.inverse.mfcc_to_mel(mfcc), 5),
        "mel_to_stft (NNLS, 300 rounds)": time_ms(
            torch, lambda: L.feature.inverse.mel_to_stft(M, sr=SR), 1, groups=1),
        "mel_to_audio (NNLS + 32 rounds)": time_ms(
            torch, lambda: L.feature.inverse.mel_to_audio(M, sr=SR, n_iter=32, length=n), 1,
            groups=1),
    }
    print("features and inversion times (ms, CUDA events): "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    print(f"features and inversion host times (s, host clock): float64 FISTA on "
          f"{NNLS_FRAMES} frames {nnls_host_s:.4f}")
    return {"launches": counts, "device_ms": times, "peak_bytes": peak_bytes - base_bytes,
            "snr_db": snrs, "nnls_objective": objective, "gl_convergence": convergence}


def pcen_spectrum_ext_phase(torch, L, device, y, win) -> dict:
    """Phase 4m: pcen on the main buffer's power spectrogram (whole, max-filtered, streamed),
    the reassigned spectrogram of the chirp batch, iirt of the main buffer and fmt of a cut,
    each against float64 on track 0; times, peak memory."""
    import scipy.interpolate
    import scipy.signal

    from librosa_tpu_torch.ops import db_scale, fused_stft, iir, median, ola_norm, spline

    rows, n = MAIN_SHAPE
    chirps = chirp_batch(torch, L, device)
    P = L.stft(y).abs() ** 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    fused_stft.launches = db_scale.launches = ola_norm.launches = median.launches = 0
    half = P.shape[-1] // 2
    out = {"pcen": L.pcen(P, sr=SR), "pcen max_size 5": L.pcen(P, sr=SR, max_size=5, max_axis=-2)}
    first, zf = L.pcen(P[..., :half], sr=SR, return_zf=True)
    out["pcen streamed"] = torch.cat([first, L.pcen(P[..., half:], sr=SR, zi=zf)], dim=-1)
    del first
    freqs, times_r, mags = L.reassigned_spectrogram(chirps, sr=SR)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out["iirt"] = L.iirt(y, sr=SR, res_type="polyphase")
    stop.record()
    stop.synchronize()
    iirt_ms = start.elapsed_time(stop)
    out["fmt"] = L.fmt(y[:, :FMT_SAMPLES])
    torch.cuda.synchronize()
    counts = {"stft_mel": fused_stft.launches, "db_scale": db_scale.launches,
              "ola_norm": ola_norm.launches, "median_filter": median.launches}
    peak_bytes = torch.cuda.max_memory_allocated()
    # fmt's grid is the package's own host table (numpy, as on the CPU, where the tests hold
    # it against the JAX package); the check below is of the spline and the FFT on the card
    targets = L.core.spectrum_ext._fmt_targets(FMT_SAMPLES, 0.5, None, 1.0)
    n_fmt = len(targets)
    frames = 1 + n // 512
    print(f"pcen and spectrum_ext: P {tuple(P.shape)}, chirps {tuple(chirps.shape)} -> "
          + ", ".join(f"{k} {tuple(v.shape)}" for k, v in out.items())
          + f", reassigned 3 x {tuple(mags.shape)}; launches {counts}; peak memory {peak_bytes} "
          f"bytes, {peak_bytes - base_bytes} above the {base_bytes} held before; fmt cut to the "
          f"first {FMT_SAMPLES} samples of each track (its default grid grows as n log n: "
          f"{n_fmt} points a track here, {L.core.spectrum_ext._fmt_default_points(n, 0.5, 1.0)} "
          f"at {n})")
    shapes = {"iirt": (rows, 85, frames), "fmt": (rows, n_fmt // 2 + 1)}
    for key, value in out.items():
        if (tuple(value.shape) != shapes.get(key, tuple(P.shape))
                or not bool(torch.isfinite(value).all())):
            raise AssertionError(f"{key}: shape {tuple(value.shape)} or not finite")
    if counts != {"stft_mel": 0, "db_scale": 0, "ola_norm": 0, "median_filter": 0}:
        raise AssertionError(f"pcen and spectrum_ext launched {counts}, expected none")

    # track 0 against float64
    P64 = spec64(y[0].cpu().numpy(), win, n_fft=2048, hop=512) ** 2
    snrs = {"pcen": snr_db(out["pcen"][0].cpu().numpy(), pcen64(P64, sr=SR, hop=512)),
            "pcen max_size 5": snr_db(out["pcen max_size 5"][0].cpu().numpy(),
                                      pcen64(P64, sr=SR, hop=512, max_size=5)),
            "pcen streamed vs whole (card)": snr_db(out["pcen streamed"][0].cpu().numpy(),
                                                    out["pcen"][0].cpu().numpy())}
    del P64
    c0 = chirps[0].cpu().numpy()
    D = stft64(c0, win, n_fft=2048, hop=512)
    w = np.asarray(win, np.float64)
    Ddh = stft64(c0, np.gradient(np.pad(w, 1, mode="wrap"))[1:-1], n_fft=2048, hop=512)
    Dth = stft64(c0, w * np.arange(0.5 - 1024, 1024), n_fft=2048, hop=512)
    m64 = np.abs(D)
    keep = m64 > 1e-3 * m64.max()
    with np.errstate(divide="ignore", invalid="ignore"):
        f64 = np.fft.rfftfreq(2048, 1 / SR)[:, None] - np.imag(Ddh / D) * (0.5 * SR / np.pi)
        t64 = (np.arange(D.shape[-1]) * 512 / SR)[None] + np.real(Dth / D) / SR
    f64, t64 = np.clip(f64, 0, SR / 2), np.clip(t64, 0, n / SR)
    for key, got, want in (("reassigned freqs", freqs, f64), ("reassigned times", times_r, t64)):
        g = got[0].cpu().numpy()
        snrs[key] = snr_db(np.where(keep, np.nan_to_num(g), 0.0), np.where(keep, want, 0.0))
    snrs["reassigned mags"] = snr_db(mags[0].cpu().numpy(), m64)
    del D, Ddh, Dth, freqs, times_r, mags

    # iirt: track 0 resampled to each rate by float64 scipy resample_poly, through float64
    # scipy sosfiltfilt; the port's own resampling at those rates is held against it too
    t0 = time.perf_counter()
    bank, rates = L.filters.semitone_filterbank(flayout="sos")
    padded = torch.nn.functional.pad(y[:1], (1024, 1024))
    padded64 = padded[0].cpu().double().numpy()
    y_groups = {r: padded64 if r == SR else scipy.signal.resample_poly(padded64, 1, round(SR / r))
                for r in np.unique(rates)}
    for r in np.unique(rates):
        if r != SR:
            snrs[f"resample {SR} -> {r:g} (iirt's rates)"] = snr_db(
                L.resample(padded, orig_sr=SR, target_sr=r, res_type="polyphase")[0]
                .cpu().numpy(), y_groups[r])
    sos_groups = {r: [bank[i] for i in np.flatnonzero(rates == r)] for r in np.unique(rates)}
    want = iirt64(y_groups, sos_groups, n_frames=frames, hop=512, win=2048, sr=SR)
    order = np.argsort(np.concatenate([np.flatnonzero(rates == r) for r in np.unique(rates)]))
    snrs["iirt"] = snr_db(out["iirt"][0].cpu().numpy(), want[order])
    iirt_host_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    y0 = y[0, :FMT_SAMPLES].cpu().double().numpy()
    fit = scipy.interpolate.interp1d(np.linspace(0, 1, FMT_SAMPLES, endpoint=False), y0,
                                     kind="cubic")
    fmt_want = np.fft.rfft(fit(targets) * targets**0.5 * np.sqrt(FMT_SAMPLES) / n_fmt)
    snrs["fmt"] = float(10 * np.log10(np.sum(np.abs(fmt_want) ** 2) / np.sum(
        np.abs(out["fmt"][0].cpu().numpy() - fmt_want) ** 2)))
    fmt_host_s = time.perf_counter() - t0
    floors = {"pcen": MIN_PCEN_SNR_DB, "pcen max_size 5": MIN_PCEN_SNR_DB,
              "pcen streamed vs whole (card)": MIN_PCEN_STREAM_SNR_DB,
              "reassigned freqs": MIN_REASSIGN_SNR_DB, "reassigned times": MIN_REASSIGN_SNR_DB,
              "reassigned mags": MIN_REASSIGN_SNR_DB, "iirt": MIN_IIRT_SNR_DB,
              "fmt": MIN_FMT_SNR_DB}
    floors.update({k: MIN_RESAMPLE_SNR_DB for k in snrs if k.startswith("resample")})
    print("pcen and spectrum_ext track 0 vs float64: " + ", ".join(
        f"{k} {v:.1f} dB (floor {floors[k]})" for k, v in snrs.items()))
    for key, s in snrs.items():
        if not s >= floors[key]:
            raise AssertionError(f"{key}: {s:.1f} dB < {floors[key]}")
    del out

    yc = y[:, :FMT_SAMPLES]
    resampled = spline.uniform_cubic_resample(yc, targets, x0=0.0, dx=1.0 / FMT_SAMPLES)
    # one block of iirt's 22050 Hz group (the tracks of one call of the bank), alone
    bank, rates = L.filters.semitone_filterbank(flayout="sos")
    group = np.stack([bank[i] for i in np.flatnonzero(rates == SR)])
    padlen = iir._bank_padlen(group)
    block = y[:L.core.spectrum_ext.iirt_block_tracks(len(group), n + 2048 + 2 * padlen, 4)]
    block = torch.nn.functional.pad(block, (1024, 1024))
    params = iir._bank_tensors(group, block.shape[-1] + 2 * padlen, block)
    zi_unit = torch.as_tensor(np.stack([iir.sosfilt_zi(s) for s in group]),
                              dtype=torch.float32, device=device)
    c = block[:, None, None, :].expand(block.shape[0], len(group), 2, block.shape[-1]).contiguous()
    times = {
        "fmt: the spline resample alone": time_ms(
            torch, lambda: spline.uniform_cubic_resample(yc, targets, x0=0.0,
                                                         dx=1.0 / FMT_SAMPLES), 3),
        f"fmt: rfft of {n_fmt} points a track alone": time_ms(
            torch, lambda: torch.fft.rfft(resampled, dim=-1), 3),
        f"iirt: bank filtfilt of one block ({block.shape[0]} tracks x {len(group)} bands "
        f"at {SR} Hz)": time_ms(torch, lambda: iir._bank_filtfilt_core(
            block, *params[:4], zi_unit, *params[4:], padlen=padlen), 1, groups=1),
        "iirt: one doubling scan of that block's forcing": time_ms(
            torch, lambda: iir._prefix_affine_scan(params[3][0], c), 1, groups=1),
        "pcen": time_ms(torch, lambda: L.pcen(P, sr=SR), 3),
        "pcen max_size 5": time_ms(torch, lambda: L.pcen(P, sr=SR, max_size=5, max_axis=-2), 3),
        "reassigned_spectrogram": time_ms(torch, lambda: L.reassigned_spectrogram(chirps, sr=SR),
                                          2),
        f"fmt on {FMT_SAMPLES} samples a track": time_ms(torch, lambda: L.fmt(yc), 3),
        "iirt (one call)": iirt_ms,
    }
    del resampled, c, block
    print("pcen and spectrum_ext times (ms, CUDA events): "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    print(f"pcen and spectrum_ext host times (s, host clock): float64 iirt reference "
          f"{iirt_host_s:.4f}, float64 fmt reference {fmt_host_s:.4f}")
    return {"launches": counts, "device_ms": times, "peak_bytes": peak_bytes - base_bytes,
            "snr_db": snrs}


PATH_N = 15                   # path_enhance(R, 15): upstream's docstring example, 7 filters
MIN_PATH_SNR_DB = 110.0       # the path_enhance golden's floor (142.8 on the card)
PATH_CROP = 1024              # the float64 check's crop of track 0's R (scipy convolves on the host)
MAX_PATH_FILTER_ERR = 1e-12   # filters.diagonal_filter against the hann lines built here
CTFFT_N = 110250              # 5 s at 22050 Hz: 315 x 350, not a power of two
MIN_CTFFT_SNR_DB = 115.0      # complex64 matrix products against float64 (125.1 on the card)
MIN_CTFFT_ROUNDTRIP_SNR_DB = 115.0   # ifft_arbitrary(fft_arbitrary(x)) against x (123.2)
MIN_RESAMPLE_BACKEND_SNR_DB = 115.0  # 'matmul' against 'auto' and against float64 (121.9, 122.7)
# the H100 SXM datasheet's rates that PERF.md's bounds use, beside calibrate()'s
DATASHEET = {"matmul_f32_flops": H100_F32_FLOP_S, "matmul_bf16_flops": 989e12,
             "hbm_bytes_per_s": H100_HBM_BYTES_S}


def path_filters64(n, *, n_filters=7, max_ratio=2.0):
    """The slopes and path_enhance's filters, built here in float64 from ``np.hanning`` as
    upstream librosa builds them: the symmetric hann of length ``n`` on the main diagonal, the
    plane rotated by ``45 - degrees(arctan(slope))`` with a quintic spline and no prefilter,
    negative ringing clipped, the taps summing to 1."""
    import scipy.ndimage

    slopes = np.logspace(np.log2(1 / max_ratio), np.log2(max_ratio), n_filters, base=2)
    filters = []
    for slope in slopes:
        line = np.diag(np.hanning(n))
        turn = 45.0 - np.degrees(np.arctan(slope))
        if not np.isclose(turn, 0.0):
            line = np.clip(scipy.ndimage.rotate(line, turn, order=5, prefilter=False), 0.0, None)
        filters.append(line / line.sum())
    return slopes, filters


def path_enhance64(R, filters):
    """``path_enhance`` in float64 numpy and scipy: ``scipy.ndimage.convolve(mode='reflect')``
    with each unflipped filter of ``path_filters64``, the maximum, clipped at 0."""
    import scipy.ndimage

    out = None
    for f in filters:
        conv = scipy.ndimage.convolve(R, f, mode="reflect")
        out = conv if out is None else np.maximum(out, conv)
    return np.maximum(out, 0.0)


def timelag_median64(R, size):
    """``timelag_filter(scipy.ndimage.median_filter)(R, size=size)`` from its definition: ``R``
    padded below by zeros to ``(2n, n)``, column ``j`` rolled up by ``j`` (the lag matrix),
    the median filter there, column ``j`` rolled back down by ``j``, the first ``n`` rows."""
    import scipy.ndimage

    n = R.shape[0]
    rows, cols = np.arange(2 * n)[:, None], np.arange(n)[None, :]
    lag = np.concatenate([R, np.zeros_like(R)], axis=0)[(rows + cols) % (2 * n), cols]
    return scipy.ndimage.median_filter(lag, size=size)[(rows - cols) % (2 * n), cols][:n]


def segment_infrastructure_phase(torch, L, device, y) -> dict:
    """Phase 4n: path_enhance at (2, 8193, 8193) on the chirp batch's affinity, timelag_filter,
    the two-stage FFTs and the 'matmul' backend's resample, then calibrate, dispatch_profile
    of configs 1 and 5 (its kernel counts against the wrappers') and roofline."""
    import scipy.ndimage
    import scipy.signal

    from librosa_tpu_torch import entry
    from librosa_tpu_torch.filters import diagonal_filter
    from librosa_tpu_torch.ops import ctfft, db_scale, fft, fused_stft, median, ola_norm
    from librosa_tpu_torch.util import profiling

    chirps = chirp_batch(torch, L, device)
    x = y[:, :CTFFT_N].contiguous()
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    fused_stft.launches = db_scale.launches = ola_norm.launches = median.launches = 0
    host = {}

    def host_s(label, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host[label] = time.perf_counter() - t0
        return out

    mfcc = L.feature.mfcc(y=chirps, sr=SR)
    R0, R1 = (host_s(f"recurrence_matrix affinity, track {i}",
                     lambda i=i: L.segment.recurrence_matrix(mfcc[i], mode="affinity"))
              for i in (0, 1))
    R = torch.stack([torch.from_numpy(r.astype(np.float32)) for r in (R0, R1)]).to(device)
    del R1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    P = L.segment.path_enhance(R, PATH_N)
    torch.cuda.synchronize()
    path_peak = torch.cuda.max_memory_allocated() - held
    X = ctfft.fft_arbitrary(x, CTFFT_N)
    back = ctfft.ifft_arbitrary(X, CTFFT_N)
    fft.set_stft_backend("matmul")
    try:
        r_matmul = L.resample(x, orig_sr=SR, target_sr=RECON_SR, res_type="fft")
    finally:
        fft.set_stft_backend("auto")
    r_auto = L.resample(x, orig_sr=SR, target_sr=RECON_SR, res_type="fft")
    torch.cuda.synchronize()
    counts = {"stft_mel": fused_stft.launches, "db_scale": db_scale.launches,
              "ola_norm": ola_norm.launches, "median_filter": median.launches}
    t = mfcc.shape[-1]
    print(f"segment and infrastructure: chirps {tuple(chirps.shape)} -> mfcc {tuple(mfcc.shape)}"
          f" -> R {tuple(R.shape)} {R.dtype} ({R.numel() * 4} bytes on the card) -> "
          f"path_enhance {tuple(P.shape)}; fft_arbitrary "
          f"{tuple(X.shape)} {X.dtype}; resample {tuple(r_matmul.shape)}; launches {counts}; "
          f"path_enhance's peak {path_peak} bytes above the {held} held ({base_bytes} before "
          "the phase)")
    if counts != {"stft_mel": 1, "db_scale": 1, "ola_norm": 0, "median_filter": 0}:
        raise AssertionError(f"phase 4n launched {counts}: mfcc takes the mel and dB kernels once")
    if (tuple(P.shape) != (2, t, t) or not bool(torch.isfinite(P).all())
            or float(P.min()) < 0):
        raise AssertionError("path_enhance: shape, sign or finiteness")

    # path_enhance against float64 on a crop, and the full run's interior of that crop; its
    # filters built here, and the package's host tables held against them
    crop64 = R0[:PATH_CROP, :PATH_CROP].astype(np.float64)
    slopes, filters = path_filters64(PATH_N)
    table_err = max(float(np.abs(diagonal_filter("hann", PATH_N, slope=r) - f).max())
                    for r, f in zip(slopes, filters))
    print(f"filters.diagonal_filter against the filters built from np.hanning: max abs "
          f"{table_err:.3e} (floor {MAX_PATH_FILTER_ERR:g})")
    if not table_err <= MAX_PATH_FILTER_ERR:
        raise AssertionError(f"filters.diagonal_filter is {table_err:.3e} off the hann lines")
    t0 = time.perf_counter()
    want = path_enhance64(crop64, filters)
    host["float64 path_enhance reference on the crop (scipy)"] = time.perf_counter() - t0
    got = L.segment.path_enhance(R[0, :PATH_CROP, :PATH_CROP], PATH_N).cpu().numpy()
    edge = 2 * PATH_N
    inner = (slice(edge, PATH_CROP - edge),) * 2
    snrs = {"path_enhance crop vs float64": snr_db(got, want),
            f"path_enhance {tuple(R.shape)}, the crop's interior vs float64": snr_db(
                P[0, :PATH_CROP, :PATH_CROP].cpu().numpy()[inner], want[inner])}
    del R0

    # timelag_filter on the same crop, equal to the median of the host's own shears
    lagged = host_s("timelag_filter(median_filter, size=(1, 7)), the crop", lambda: (
        L.segment.timelag_filter(scipy.ndimage.median_filter)(crop64, size=(1, 7))))
    if not np.array_equal(lagged, timelag_median64(crop64, (1, 7))):
        raise AssertionError("timelag_filter differs from the median of the lag matrix")

    taps = [(int(np.count_nonzero(f)), f.shape) for f in filters]
    pixels = R.numel()
    dense_flops = sum(2 * f.size for f in filters) * pixels
    ops_ms = 1e3 * dense_flops / H100_F32_FLOP_S
    bytes_ms = 1e3 * 2 * 4 * pixels / H100_HBM_BYTES_S
    path_ms = time_ms(torch, lambda: L.segment.path_enhance(R, PATH_N), 3)
    print("path_enhance filters (nonzero taps of the dense kh x kw): " + ", ".join(
        f"slope {r:.3f}: {nz} of {s[0]}x{s[1]}" for r, (nz, s) in zip(slopes, taps)))
    print(f"path_enhance {tuple(R.shape)}: {path_ms:.4f} ms (CUDA events); bound of its dense "
          f"work {max(ops_ms, bytes_ms):.4f} ms by {'operations' if ops_ms >= bytes_ms else 'bytes'}"
          f" (2 x {sum(f.size for f in filters)} taps x {pixels} pixels = {dense_flops:.4e} flop "
          f"at 33.5e12 FMA/s: {ops_ms:.4f} ms; R read and the output written once: "
          f"{bytes_ms:.4f} ms; H100 SXM datasheet)")

    # the two-stage FFTs against float64, and the 'matmul' backend's resample
    x0 = x[0].cpu().numpy().astype(np.float64)
    X0, X64 = X[0].cpu().numpy(), np.fft.fft(x0)
    snrs["fft_arbitrary track 0 vs float64"] = snr_db(np.stack([X0.real, X0.imag]),
                                                      np.stack([X64.real, X64.imag]))
    snrs["ifft_arbitrary(fft_arbitrary(x)) vs x"] = snr_db(back.real.cpu().numpy(),
                                                           x.cpu().numpy())
    snrs["resample 'matmul' vs 'auto'"] = snr_db(r_matmul.cpu().numpy(), r_auto.cpu().numpy())
    snrs["resample 'matmul' track 0 vs float64 scipy"] = snr_db(
        r_matmul[0].cpu().numpy(), scipy.signal.resample(x0, r_matmul.shape[-1]))
    floors = {k: MIN_PATH_SNR_DB for k in snrs if k.startswith("path_enhance")}
    floors.update({"fft_arbitrary track 0 vs float64": MIN_CTFFT_SNR_DB,
                   "ifft_arbitrary(fft_arbitrary(x)) vs x": MIN_CTFFT_ROUNDTRIP_SNR_DB,
                   "resample 'matmul' vs 'auto'": MIN_RESAMPLE_BACKEND_SNR_DB,
                   "resample 'matmul' track 0 vs float64 scipy": MIN_RESAMPLE_BACKEND_SNR_DB})
    print("segment and infrastructure checks: " + ", ".join(
        f"{k} {v:.1f} dB (floor {floors[k]})" for k, v in snrs.items()))
    for key, s in snrs.items():
        if not s >= floors[key]:
            raise AssertionError(f"{key}: {s:.1f} dB < {floors[key]}")
    device_ms = {
        f"fft_arbitrary {tuple(x.shape)}": time_ms(torch, lambda: ctfft.fft_arbitrary(x, CTFFT_N),
                                                   5),
        "torch.fft.fft, the same input": time_ms(torch, lambda: torch.fft.fft(x), 5),
        "ifft_arbitrary": time_ms(torch, lambda: ctfft.ifft_arbitrary(X, CTFFT_N), 5),
        "torch.fft.ifft, the same input": time_ms(torch, lambda: torch.fft.ifft(X), 5),
        "resample res_type='fft', 'auto'": time_ms(
            torch, lambda: L.resample(x, orig_sr=SR, target_sr=RECON_SR, res_type="fft"), 5),
    }
    fft.set_stft_backend("matmul")
    try:
        device_ms["resample res_type='fft', 'matmul'"] = time_ms(
            torch, lambda: L.resample(x, orig_sr=SR, target_sr=RECON_SR, res_type="fft"), 5)
    finally:
        fft.set_stft_backend("auto")
    device_ms[f"path_enhance {tuple(R.shape)}"] = path_ms
    del X, back, r_matmul, r_auto, P

    # the profiler: ceilings, launch counts against the wrappers', busy share, a roofline
    ceilings = profiling.calibrate()
    print("calibrate() (measured; datasheet in brackets): " + ", ".join(
        f"{k} {getattr(ceilings, k):.4e} ({v:.4e})" for k, v in DATASHEET.items()))
    forward1, _ = entry.entry()
    forward5, _ = entry.onset_beat_pyin()
    y5 = config5_signal(torch, MAIN_SHAPE, 5, device)
    profiles = {}
    for label, fn in (("config 1 entry", lambda: forward1(y)),
                      ("config 5 onset_beat_pyin", lambda: forward5(y5))):
        fn()
        torch.cuda.synchronize()
        fused_stft.launches = db_scale.launches = 0
        prof = profiling.dispatch_profile(fn, warmup=0)
        seen = {name: sum(c for k, c in prof["by_function"].items() if symbol in k)
                for name, symbol in (("stft_mel", "stft_mel_kernel"), ("db_scale", "db_apply"))}
        wrappers = {"stft_mel": fused_stft.launches, "db_scale": db_scale.launches}
        busy = prof["device_s"] / prof["wall_s"]
        top = list(prof["by_function"].items())[:8]
        print(f"dispatch_profile {label}: launches {prof['launches']}, transfers "
              f"{prof['transfers']}, eager ops {prof['eager']}, kernels by symbol {seen} against "
              f"the wrappers' {wrappers}; device busy {prof['device_s'] * 1e3:.4f} ms of "
              f"{prof['wall_s'] * 1e3:.4f} ms wall, share {busy:.4f}; top kernels "
              + "; ".join(f"{k[:70]} x{c}" for k, c in top))
        if seen != wrappers or wrappers["stft_mel"] < 1:
            raise AssertionError(f"{label}: the profiler saw {seen}, the wrappers counted "
                                 f"{wrappers}")
        profiles[label] = {"launches": prof["launches"], "transfers": prof["transfers"],
                           "eager": prof["eager"], "kernels_seen": seen, "busy_share": busy,
                           "device_ms": prof["device_s"] * 1e3, "wall_ms": prof["wall_s"] * 1e3}
    del y5
    report = profiling.roofline(lambda r: L.segment.path_enhance(r, PATH_N), R,
                                ceilings=ceilings)
    print(f"roofline path_enhance {tuple(R.shape)} (torch ops only): {report}; flops "
          f"{report.flops}, bytes {report.bytes_accessed}")
    print("segment and infrastructure times (ms, CUDA events): "
          + ", ".join(f"{k} {v:.4f}" for k, v in device_ms.items()))
    print("segment and infrastructure host times (s, host clock): "
          + ", ".join(f"{k} {v:.4f}" for k, v in host.items()))
    return {"launches": counts, "device_ms": device_ms, "host_s": host, "snr_db": snrs,
            "profiles": profiles, "path_peak_bytes": path_peak,
            "ceilings": {k: getattr(ceilings, k) for k in DATASHEET}}


# ---------------------------------------------------------------------------
# 4o: the sharded layer (parallel/) on eight positions of one card, and dryrun_multichip
# ---------------------------------------------------------------------------

SHARD_POSITIONS = 8           # an 8-way time mesh laid on cuda:0 (the machine has one card)
MEL_SHARDED_RTOL = 1e-6       # tests/test_parallel.py:51, where the sharded mel is not bit-equal
MIN_MFCC_SHARDED_SNR_DB = 120.0   # tests/test_parallel.py:245
ENV_SHARDED_ATOL = 2e-5       # tests/test_parallel.py:83
PCEN_SHARDED_TOL = 1e-4       # tests/test_parallel.py:106 (atol and rtol)
CQT_SHARDED_REL = 1e-5        # tests/test_parallel.py:124, max error over the peak
MIN_CHROMA_SHARDED_SNR_DB = 120.0  # tests/test_parallel.py:284
MIN_HPSS_SHARDED_SNR_DB = 120.0    # tests/test_parallel.py:222
F0_SHARDED_RTOL = 1e-5        # tests/test_parallel.py:180
VPROB_SHARDED_ATOL = 1e-6     # tests/test_parallel.py:181
TEMPO_SHARDED_RTOL = 1e-6     # tests/test_parallel.py:199
DRYRUN_GRAD_RTOL = 1e-5       # the first step's gradient against float64 autograd
SCALING_SECONDS = 10.0        # audio a position in scaling_report's runs
SHARDED_KERNELS = ("stft_mel", "db_scale", "ola_norm", "median_filter", "beat_dp", "viterbi",
                   "trough_priors")


def sharded_launches(name: str, d: int) -> dict:
    """Launches of each hand kernel in one call of the sharded chain ``name`` on ``d`` positions,
    by the design: the mel kernel once a position and once for the trailing frame, the median
    kernel twice a position, the trough priors kernel once a position's block and once for the
    one-frame tail, the dB, beat DP and Viterbi kernels once on the joined result."""
    k1 = {"stft_mel": d + 1}
    want = {"stft": {}, "stft_reflect": {}, "melspectrogram": k1,
            "mfcc": {**k1, "db_scale": 1}, "onset_strength": k1, "tempo": k1, "pcen": {},
            "cqt": {}, "chroma_cqt": {}, "hpss": {"median_filter": 2 * d},
            "pyin": {"viterbi": 1, "trough_priors": d + 1}, "beat_track": {**k1, "beat_dp": 1}}[name]
    return {k: want.get(k, 0) for k in SHARDED_KERNELS}


def dryrun_loss64(torch, L, *, dp, sp, n_fft=512, hop=128, n_mels=16, n_out=4):
    """``dryrun_multichip``'s first loss and gradients, unsharded, by float64 autograd on the
    host: the same seeded draws, centred frames (the ``n // hop`` the positions own),
    ``|rfft|**2``, the filterbank, ``log1p``, the time mean, the head, the mean squared error."""
    rng = np.random.RandomState(0)
    n = sp * hop * 16
    y = torch.from_numpy(rng.randn(2 * dp, n).astype(np.float32).astype(np.float64))
    fb = torch.from_numpy(L.filters.mel(sr=SR, n_fft=n_fft, n_mels=n_mels).astype(np.float32)
                          .astype(np.float64)).requires_grad_()
    head = torch.from_numpy((rng.randn(n_mels, n_out) * 0.1).astype(np.float32)
                            .astype(np.float64)).requires_grad_()
    target = torch.from_numpy(rng.randn(2 * dp, n_out).astype(np.float32).astype(np.float64))
    frames = torch.nn.functional.pad(y, (n_fft // 2, n_fft // 2)).unfold(-1, n_fft, hop)
    window = torch.from_numpy(L.filters.get_window("hann", n_fft).astype(np.float64))
    power = torch.fft.rfft(frames[..., :n // hop, :] * window, dim=-1).abs().square()
    feats = torch.log1p(torch.matmul(power, fb.T).clamp_min(0.0))
    loss = (torch.matmul(feats.mean(dim=1), head) - target).square().mean()
    loss.backward()
    return float(loss.detach()), fb.grad.numpy(), head.grad.numpy()


def sharded_phase(torch, L, device, y) -> dict:
    """Phase 4o: every sharded chain of ``parallel/`` at full width on an 8-position time mesh
    of one card and on ``time_mesh()`` (one position), each against the unsharded port with its
    launches counted, the float64 onset floor, the times beside the unsharded calls with peak
    memory, ``scaling_report`` over positions of the card, ``dispatch_profile`` of two chains
    and ``dryrun_multichip(8)`` against float64 autograd."""
    from librosa_tpu_torch import parallel as P
    from librosa_tpu_torch.entry import dryrun_multichip
    from librosa_tpu_torch.ops import (beat_dp, db_scale, fused_stft, median, ola_norm,
                                       trough_priors, viterbi)
    from librosa_tpu_torch.parallel import scaling
    from librosa_tpu_torch.util import profiling

    counters = dict(zip(SHARDED_KERNELS, (fused_stft, db_scale, ola_norm, median, beat_dp,
                                          viterbi, trough_priors)))

    def counted(fn):
        for mod in counters.values():
            mod.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: mod.launches for k, mod in counters.items()}

    meshes = {SHARD_POSITIONS: P.make_mesh((SHARD_POSITIONS,), ("time",),
                                           devices=[device] * SHARD_POSITIONS),
              1: P.time_mesh()}
    print(f"sharded layer: meshes {meshes[SHARD_POSITIONS]} and time_mesh() {meshes[1]}; "
          "positions share the card, so these runs show what sharding costs on one card and "
          "not how a chain scales across cards")
    y5 = config5_signal(torch, MAIN_SHAPE, 5, device)
    mel_kw = dict(sr=SR, **MAIN)
    M = L.feature.melspectrogram(y=y, **mel_kw)[..., :-1].contiguous()   # 8192 frames: 8 x 1024
    chains = {
        "stft": (lambda m: P.stft_sharded(y, mesh=m), lambda: L.stft(y, n_fft=2048,
                                                                     hop_length=512)),
        "stft_reflect": (lambda m: P.stft_sharded(y, mesh=m, pad_mode="reflect"),
                         lambda: L.stft(y, n_fft=2048, hop_length=512, pad_mode="reflect")),
        "melspectrogram": (lambda m: P.melspectrogram_sharded(y, mesh=m, **mel_kw),
                           lambda: L.feature.melspectrogram(y=y, **mel_kw)),
        "mfcc": (lambda m: P.mfcc_sharded(y, mesh=m, sr=SR),
                 lambda: L.feature.mfcc(y=y, sr=SR)),
        "onset_strength": (lambda m: P.onset_strength_sharded(y5, mesh=m, sr=SR),
                           lambda: L.onset.onset_strength(y=y5, sr=SR)),
        "tempo": (lambda m: P.tempo_sharded(y5, mesh=m, sr=SR),
                  lambda: L.feature.tempo(onset_envelope=L.onset.onset_strength(y=y5, sr=SR),
                                          sr=SR)),
        "pcen": (lambda m: P.pcen_sharded(M, mesh=m, sr=SR), lambda: L.pcen(M, sr=SR)),
        "cqt": (lambda m: P.cqt_sharded(y, mesh=m, sr=SR, hop_length=512, n_bins=84,
                                        bins_per_octave=12),
                lambda: L.cqt(y, sr=SR, hop_length=512, n_bins=84, bins_per_octave=12,
                              res_type="polyphase")),
        "chroma_cqt": (lambda m: P.chroma_cqt_sharded(y, mesh=m, sr=SR),
                       lambda: L.feature.chroma_cqt(C=L.cqt(
                           y, sr=SR, hop_length=512, fmin=L.note_to_hz("C1"), n_bins=7 * 36,
                           bins_per_octave=36, res_type="polyphase").abs(), sr=SR)),
        "hpss": (lambda m: P.hpss_sharded(y, mesh=m), lambda: L.effects.hpss(y)),
        "pyin": (lambda m: P.pyin_sharded(y5, mesh=m, sr=SR, **PYIN5),
                 lambda: L.pyin(y5, sr=SR, **PYIN5)),
        "beat_track": (lambda m: P.beat_track_sharded(y5, mesh=m, sr=SR, sparse=False),
                       lambda: L.beat.beat_track(y=y5, sr=SR, sparse=False)),
    }

    def agree(name, got, want) -> dict:
        """The table of ``tests/test_parallel.py``'s holds, per chain: what was measured."""
        if name in ("stft", "stft_reflect"):
            return {"bit_equal": bool(torch.equal(got, want))}
        if name in ("melspectrogram", "mfcc"):
            r = {"bit_equal": bool(torch.equal(got, want)),
                 "max_rel": float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())}
            if name == "mfcc":
                r["snr_db"] = snr_t(torch, got, want)
            return r
        if name == "onset_strength":
            return {"max_abs": float((got - want).abs().max())}
        if name in ("tempo", "beat_track"):
            t_got, t_want = (np.asarray(x[0] if name == "beat_track" else x, dtype=float)
                             for x in (got, want))
            r = {"tempo_max_rel": float(np.max(np.abs(t_got - t_want) / t_want))}
            if name == "beat_track":
                r["beats_equal"] = bool(np.array_equal(got[1], want[1]))
            return r
        if name == "pcen":
            return {"max_excess": float(((got - want).abs()
                                         - PCEN_SHARDED_TOL * (1 + want.abs())).max())}
        if name == "cqt":
            return {"max_rel": float((got - want).abs().max() / want.abs().max())}
        if name == "chroma_cqt":
            return {"snr_db": snr_t(torch, got, want)}
        if name == "hpss":
            return {"snr_db": min(snr_t(torch, g, w) for g, w in zip(got, want))}
        f0, vf, vp = got
        f0_w, vf_w, vp_w = want
        both = torch.isfinite(f0) & torch.isfinite(f0_w)
        return {"voicing_equal": bool(torch.equal(vf, vf_w)),
                "f0_max_rel": float(((f0 - f0_w).abs() / f0_w.abs())[both].max()),
                "vprob_max_abs": float((vp - vp_w).abs().max())}

    def held(name, r) -> bool:
        if name in ("stft", "stft_reflect"):
            return r["bit_equal"]
        if name == "melspectrogram":
            return r["bit_equal"] or r["max_rel"] <= MEL_SHARDED_RTOL
        if name == "mfcc":
            return r["bit_equal"] or r["snr_db"] >= MIN_MFCC_SHARDED_SNR_DB
        if name == "onset_strength":
            return r["max_abs"] <= ENV_SHARDED_ATOL
        if name == "tempo":
            return r["tempo_max_rel"] <= TEMPO_SHARDED_RTOL
        if name == "beat_track":
            return r["tempo_max_rel"] <= TEMPO_SHARDED_RTOL and r["beats_equal"]
        if name == "pcen":
            return r["max_excess"] <= 0
        if name == "cqt":
            return r["max_rel"] < CQT_SHARDED_REL
        if name == "chroma_cqt":
            return r["snr_db"] >= MIN_CHROMA_SHARDED_SNR_DB
        if name == "hpss":
            return r["snr_db"] >= MIN_HPSS_SHARDED_SNR_DB
        return (r["voicing_equal"] and r["f0_max_rel"] <= F0_SHARDED_RTOL
                and r["vprob_max_abs"] <= VPROB_SHARDED_ATOL)

    def peak_bytes(fn) -> int:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held_bytes = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - held_bytes

    launches = {k: 0 for k in SHARDED_KERNELS}
    results, failed, env8 = {}, [], None
    for name, (sharded, unsharded) in chains.items():
        want, unsharded_counts = counted(unsharded)
        entry = {"unsharded_launches": unsharded_counts}
        for d, mesh in meshes.items():
            got, counts = counted(lambda: sharded(mesh))
            for k, c in counts.items():
                launches[k] += c
            r = agree(name, got, want)
            ok = held(name, r) and counts == sharded_launches(name, d)
            entry[f"D{d}"] = {"launches": counts, "agreement": r, "held": ok}
            if not ok:
                failed.append(f"{name} D={d}: {r}, launches {counts} (design "
                              f"{sharded_launches(name, d)})")
            if name == "onset_strength" and d == SHARD_POSITIONS:
                env8 = got
            del got
        del want
        results[name] = entry
        print(f"sharded {name}: D={SHARD_POSITIONS} {entry[f'D{SHARD_POSITIONS}']}; D=1 "
              f"{entry['D1']}; unsharded launches {unsharded_counts}")

    # the sharded envelope of track 0 against the port's float64 run on the host
    env64 = L.onset.onset_strength(y=y5[0].cpu().double(), sr=SR)
    env_snr = snr_db(env8[0].cpu().numpy(), env64.numpy())
    print(f"sharded onset_strength track 0 vs the float64 CPU run: {env_snr:.1f} dB (floor "
          f"{MIN_ENV_SNR_DB})")
    if not env_snr >= MIN_ENV_SNR_DB:
        failed.append(f"onset_strength track 0 vs float64: {env_snr:.1f} dB")
    del env8
    if failed:
        raise AssertionError("phase 4o: " + "; ".join(failed))

    # times (CUDA events) and peak memory: each chain at D=8, D=1 and unsharded
    times = {}
    for name, (sharded, unsharded) in chains.items():
        heavy = name in ("pyin", "chroma_cqt")
        reps = 1 if heavy else 3
        row = {}
        for label, fn in ((f"D{SHARD_POSITIONS}", lambda: sharded(meshes[SHARD_POSITIONS])),
                          ("D1", lambda: sharded(meshes[1])), ("unsharded", unsharded)):
            row[label] = {"ms": time_ms(torch, fn, reps, groups=2), "peak_bytes": peak_bytes(fn)}
        times[name] = row
    print("sharded chains (ms by CUDA events, best of 2 groups; peak bytes above what was held):")
    for name, row in times.items():
        print(f"  {name}: " + ", ".join(f"{k} {v['ms']:.4f} ms peak {v['peak_bytes']}"
                                        for k, v in row.items()))

    # positions of one card: the cost of sharding there, not scaling
    points = scaling.scaling_report_all(device_counts=[1, 2, 4, SHARD_POSITIONS],
                                        seconds_per_device=SCALING_SECONDS, iters=2,
                                        devices=[device] * SHARD_POSITIONS)
    print(f"scaling_report over 1-{SHARD_POSITIONS} positions of ONE card "
          f"({SCALING_SECONDS} s a position; the cost of sharding on one card, not scaling):")
    for p in points:
        print(f"  {p.chain:>15s} {p.n_devices} positions: {p.seconds * 1e3:.4f} ms, "
              f"{p.samples_per_s:.6e} samples/s, efficiency {p.efficiency:.4f}")

    # what the profiler sees in two chains at D=8
    profiles = {}
    for label, fn, symbol, kernel in (
            ("melspectrogram_sharded", lambda: P.melspectrogram_sharded(
                y, mesh=meshes[SHARD_POSITIONS], **mel_kw), "stft_mel_kernel", "stft_mel"),
            ("hpss_sharded", lambda: P.hpss_sharded(y, mesh=meshes[SHARD_POSITIONS]),
             "median_kernel", "median_filter")):
        fn()
        torch.cuda.synchronize()
        counters[kernel].launches = 0
        prof = profiling.dispatch_profile(fn, warmup=0)
        seen = sum(c for k, c in prof["by_function"].items() if symbol in k)
        busy = prof["device_s"] / prof["wall_s"]
        print(f"dispatch_profile {label} at D={SHARD_POSITIONS}: runtime launches "
              f"{prof['launches']}, transfers {prof['transfers']}, eager ops {prof['eager']}, "
              f"{symbol} seen {seen} / counted {counters[kernel].launches}; device busy "
              f"{prof['device_s'] * 1e3:.4f} ms of {prof['wall_s'] * 1e3:.4f} ms wall, share "
              f"{busy:.4f}")
        if seen != counters[kernel].launches or seen < 1:
            raise AssertionError(f"{label}: the profiler saw {seen} {symbol}, the wrapper "
                                 f"counted {counters[kernel].launches}")
        profiles[label] = {"launches": prof["launches"], "transfers": prof["transfers"],
                           "eager": prof["eager"], "kernel_seen": seen, "busy_share": busy,
                           "device_ms": prof["device_s"] * 1e3, "wall_ms": prof["wall_s"] * 1e3}

    # the dry run: one training step and the chains on the eight positions of the card
    t0 = time.perf_counter()
    dry = dryrun_multichip(SHARD_POSITIONS, devices=[device] * SHARD_POSITIONS)
    dry_s = time.perf_counter() - t0
    l64, g_fb, g_head = dryrun_loss64(torch, L, dp=dry["mesh"][0], sp=dry["mesh"][1])
    grad_err = {name: float(np.max(np.abs(dry["grads"][name] - g)
                                   / (np.abs(g) + np.abs(g).max())))
                for name, g in (("fb", g_fb), ("head", g_head))}
    loss_rel = abs(dry["losses"][0] - l64) / l64
    print(f"dryrun_multichip({SHARD_POSITIONS}) on {device} x {SHARD_POSITIONS}: mesh "
          f"{dry['mesh']}, losses {dry['losses']}, first loss vs float64 {loss_rel:.3e}, "
          f"gradient vs float64 autograd (|err| / (|g| + max |g|)) {grad_err}, "
          f"{dry_s:.3f} s host clock")
    if not (dry["losses"][1] <= dry["losses"][0] and loss_rel <= DRYRUN_GRAD_RTOL
            and max(grad_err.values()) <= DRYRUN_GRAD_RTOL):
        raise AssertionError(f"dryrun_multichip: losses {dry['losses']}, {loss_rel}, {grad_err}")
    del y5, M
    return {"launches": launches, "chains": results, "times": times, "env_snr_db": env_snr,
            "scaling": [vars(p) for p in points], "profiles": profiles,
            "dryrun": {"losses": dry["losses"], "loss_rel": loss_rel, "grad_err": grad_err,
                       "host_s": dry_s}}


DIAL_SETTINGS = {"default": "default", "high": "high", "highest": "highest",
                 "(highest, highest, default)": ("highest", "highest", "default")}
# the kernel's projection at a setting against the plain projection at that setting of the
# kernel's own power spectrum (its identity-basis output, exact): the same rounded operands,
# products exact in float32, summed in another order
MIN_DIAL_SAME_SPECTRUM_SNR_DB = 125.0
# the kernel against its plain version end to end. The two power spectra differ in their last
# bits (K1's FFT against cuFFT), and the lower settings round each to bfloat16, so a value near
# a rounding boundary lands on the other side in one of them. On the CPU, float32 spectra 135.9
# dB apart gave 100.6 dB at 'default' and 126.6 at 'high' after the rounding; on an H100 the
# kernel against its plain version gave 96.2 and 124.8 dB (135.6 at 'highest')
MIN_DIAL_PLAIN_SNR_DB = {"highest": MIN_SNR_DB, "high": 110.0, "default": 85.0}
# against float64 (tests/test_torch_precision.py measured 138.9 / 110.6 / 56.3 dB on the CPU)
MIN_DIAL_F64_SNR_DB = {"highest": MIN_SNR_DB, "high": 100.0, "default": 50.0}
# the 'matmul' route's power spectrum against float64 (CPU: 128.9 / 108.3 / 53.4 dB), and its
# tensor-core products against the same rounded operands through exact float32 products: sums
# of 2048 exact products in two orders, the tensor cores' float32 accumulation against SGEMM's
# (on an H100: 120.5 dB on normal operands, 103.9 on the main frames at 'default'). A wrong
# route sits near the lower settings' own error: bf16 results or TF32 operands, 50-60 dB
MIN_MATMUL_F64_SNR_DB = {"highest": 115.0, "high": 100.0, "default": 45.0}
MIN_MATMUL_EMULATION_SNR_DB = 95.0
BACKEND_FLAGS = ("cuda.matmul.allow_tf32", "cuda.matmul.allow_bf16_reduced_precision_reduction",
                 "cudnn.allow_tf32")
SCAN_METHODS = ("greedy", "dp_count", "dp_value")
SCAN_WAITS = (0, 10, 300)
H100_BF16_FLOP_S = 989e12  # tensor cores, dense


def backend_flags(torch) -> dict:
    """The ``torch.backends`` flags a lower precision must leave as it found them."""
    out = {}
    for path in BACKEND_FLAGS:
        obj = torch.backends
        *parents, leaf = path.split(".")
        for part in parents:
            obj = getattr(obj, part)
        out[path] = getattr(obj, leaf)
    out["float32_matmul_precision"] = torch.get_float32_matmul_precision()
    return out


def track_snr_min(torch, got, want) -> float:
    """The smallest per-track SNR of ``got`` against ``want``, both ``(tracks, ...)`` on the card."""
    dims = tuple(range(1, got.ndim))
    err = (got.double() - want.double()).square().sum(dim=dims)
    sig = want.double().square().sum(dim=dims)
    return float((10 * torch.log10(sig / err.clamp(min=1e-300))).min())


def scan_cases(rng):
    """(label, cand (rows, T) bool, gain float32, wait): ragged rows and lengths, exact ties, waits
    at the ends of a ring of 16 and 64 and past the row; one row of 2**21 frames (65 greedy and
    1024 DP stages); and rows of 70000 frames at the largest ring and past it (the scratch route).
    """
    cases = []
    for rows, T in ((1, 1), (1, 7), (3, 31), (3, 32), (3, 33), (16, 1), (33, 1000), (70, 257),
                    (5, 8193)):
        for wait in (0, 1, 5, 6, 7, 14, 15, 62, 63, T + 3, 2**31 - 1):
            cand = rng.rand(rows, T) < 0.3
            gain = (np.floor(rng.rand(rows, T) * 8) / 8).astype(np.float32)  # ties by design
            cases.append((f"rows {rows} T {T} wait {wait}", cand, gain, wait))
    for rows, T, wait in ((1, 2**21, 10), (2, 70000, 32766), (2, 70000, 32767), (2, 70000, 40000)):
        cand = rng.rand(rows, T) < 0.3
        # eighths sum exactly in float32 up to 2**21, so no tie breaks by rounding
        gain = (np.floor(rng.rand(rows, T) * 8) / 8).astype(np.float32)
        cases.append((f"rows {rows} T {T} wait {wait}", cand, gain, wait))
    return cases


SCAN_TIME_WAITS = (0, 1, 10, 300)  # 1 is onset_detect's default at 22050 Hz, hop 512
SCAN_BATCH = 256                   # rows of the batch of shifted copies of the envelope


def precision_scan_phase(torch, L, device, y, win, mel_basis) -> dict:
    """Phase 4p: K1's precision dial and the 'matmul' route's, each setting against its plain
    version and float64 with times; the peak_scan kernels bit for bit against their plain loops
    behind ``onset_detect``, with times, launches and the chain bound."""
    from librosa_tpu_torch.core import spectrum
    from librosa_tpu_torch.ops import db_scale, fft, fused_stft, peaks, precision
    from librosa_tpu_torch.ops.framing import frame_signal
    from librosa_tpu_torch.util.utils import pad_last

    rows, n = MAIN_SHAPE
    n_fft, hop = MAIN["n_fft"], MAIN["hop_length"]
    kw = dict(n_fft=n_fft, hop_length=hop)
    win_d = torch.from_numpy(win.astype(np.float32)).to(device)
    basis_d = torch.from_numpy(mel_basis.astype(np.float32)).to(device)
    y0 = y[0].cpu().numpy()
    ref_mel = mel64(y0, win, mel_basis, n_fft=n_fft, hop=hop)

    # the path: K1 at each setting, onset_detect over the three methods and three waits
    env = L.onset.onset_strength(y=y, sr=SR)
    torch.cuda.synchronize()
    fused_stft.launches = db_scale.launches = peaks.launches = 0
    k_out = {label: fused_stft.stft_mel_fused(y, win_d, basis_d, precision=p, **kw)
             for label, p in DIAL_SETTINGS.items()}
    k_none = fused_stft.stft_mel_fused(y, win_d, basis_d, **kw)
    picks = {}
    with CallSpy(peaks, "greedy_scan", keep=100) as g_spy, \
            CallSpy(peaks, "dp_scan", keep=100) as d_spy:
        for method in SCAN_METHODS:
            for wait in SCAN_WAITS:
                picks[method, wait] = L.onset.onset_detect(
                    onset_envelope=env, sr=SR, sparse=False, method=method, wait=wait)
    torch.cuda.synchronize()
    counts = {"stft_mel": fused_stft.launches, "db_scale": db_scale.launches,
              "peak_scan_greedy": len(g_spy.calls), "peak_scan_dp": len(d_spy.calls)}
    print(f"precision and scans: K1 at {list(DIAL_SETTINGS)} and with no precision on "
          f"{tuple(y.shape)}; onset_detect(sparse=False) on the envelope {tuple(env.shape)} for "
          f"{SCAN_METHODS} at wait {SCAN_WAITS}; launches {counts}, peak_scan counter "
          f"{peaks.launches}")
    n_scans = len(SCAN_WAITS)
    # greedy: one a wait for 'greedy', and the walk of each DP run over its flags
    if counts != {"stft_mel": len(DIAL_SETTINGS) + 1, "db_scale": 0,
                  "peak_scan_greedy": 3 * n_scans, "peak_scan_dp": 2 * n_scans} \
            or peaks.launches != 5 * n_scans:
        raise AssertionError(f"phase 4p launched {counts} (peak_scan counter {peaks.launches})")
    if not torch.equal(k_out["highest"], k_none):
        raise AssertionError("K1 at 'highest' is not bit-equal to a call with no precision")

    # K1's dial: kernel against plain, against the plain projection of the kernel's own
    # spectrum, and against float64; times and bounds
    eye, eye_bands = spectrum._eye_device(n_fft, device)
    y2 = y[:2]
    spec_k = fused_stft._fused(y2, win_d, eye, eye_bands, power=2.0, center=True,
                               pad_mode="constant", **kw)
    n_frames = k_none.shape[-1]
    frames = rows * n_frames
    nnz = int(torch.count_nonzero(basis_d))
    fft_flops = fused_stft.flops_per_frame(n_fft, 0) * frames
    bytes_ms = 1e3 * (4 * rows * n + 4 * MAIN["n_mels"] * frames) / H100_HBM_BYTES_S
    dial = {}
    for label, p in DIAL_SETTINGS.items():
        setting = precision.normalize3(p)[2]
        plain = fused_stft.stft_mel_reference(y, win_d, basis_d, precision=p, **kw)
        same = precision.matmul(basis_d, spec_k, setting)
        kern2 = fused_stft.stft_mel_fused(y2, win_d, basis_d, precision=p, **kw)
        # a projection term is 2 operations: float32 at 'highest', bf16 products otherwise
        proj_terms = {"highest": 1, "default": 1, "high": 3}[setting] * 2 * nnz * frames
        ops_ms = 1e3 * (fft_flops / H100_F32_FLOP_S + proj_terms / (
            H100_F32_FLOP_S if setting == "highest" else H100_BF16_FLOP_S))
        row = {
            "basis_setting": setting,
            "snr_vs_plain_db": track_snr_min(torch, k_out[label], plain),
            "same_spectrum_snr_db": track_snr_min(torch, kern2, same),
            "snr_vs_f64_db": snr_db(k_out[label][0].cpu().numpy(), ref_mel),
            "plain_snr_vs_f64_db": snr_db(plain[0].cpu().numpy(), ref_mel),
            "max_abs_err": float((k_out[label] - plain).abs().max()),
            "launches": 1,
            "ms": time_ms(torch, lambda: fused_stft.stft_mel_fused(
                y, win_d, basis_d, precision=p, **kw), 20),
            "plain_ms": time_ms(torch, lambda: fused_stft.stft_mel_reference(
                y, win_d, basis_d, precision=p, **kw), 3),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
        del plain, same, kern2
        dial[label] = row
        print(f"K1 precision {label}: kernel vs plain {row['snr_vs_plain_db']:.1f} dB (floor "
              f"{MIN_DIAL_PLAIN_SNR_DB[setting]}), vs the plain projection of its own spectrum "
              f"{row['same_spectrum_snr_db']:.1f} dB (floor {MIN_DIAL_SAME_SPECTRUM_SNR_DB}), "
              f"track 0 vs float64 {row['snr_vs_f64_db']:.1f} dB (plain "
              f"{row['plain_snr_vs_f64_db']:.1f}; floor {MIN_DIAL_F64_SNR_DB[setting]}); "
              f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        if not (row["snr_vs_plain_db"] >= MIN_DIAL_PLAIN_SNR_DB[setting]
                and row["same_spectrum_snr_db"] >= MIN_DIAL_SAME_SPECTRUM_SNR_DB
                and row["snr_vs_f64_db"] >= MIN_DIAL_F64_SNR_DB[setting]):
            raise AssertionError(f"K1 precision {label}: {row}")
    del k_out, k_none, spec_k, eye

    # the 'matmul' route's dial on the main frames
    frames_d = frame_signal(pad_last(y, n_fft // 2, n_fft // 2, mode="constant"),
                            frame_length=n_fft, hop_length=hop) * win_d
    pw64 = spec64(y0, win, n_fft=n_fft, hop=hop).T ** 2
    Ct, St = fft.dft_mats_device(n_fft, torch.float32, device)
    route = {}
    try:
        for setting in ("default", "high", "highest"):
            before = backend_flags(torch)
            fft.set_stft_backend("matmul", precision=setting)
            pw = fft.frames_power_spectrum(frames_d)
            torch.cuda.synchronize()
            after = backend_flags(torch)
            if after != before:
                raise AssertionError(f"'matmul' at {setting!r} changed {before} to {after}")
            re, im = (precision.matmul(frames_d, M, setting) for M in (Ct, St))
            emulated = re * re + im * im
            del re, im
            row = {"snr_vs_f64_db": snr_db(pw[0].cpu().numpy(), pw64),
                   "snr_vs_emulation_db": track_snr_min(torch, pw, emulated),
                   "ms": time_ms(torch, lambda: fft.frames_power_spectrum(frames_d), 3),
                   "emulation_ms": time_ms(torch, lambda: [
                       precision.matmul(frames_d, M, setting) for M in (Ct, St)], 3),
                   "flags_unchanged": True}
            del pw, emulated
            route[setting] = row
            print(f"'matmul' route at {setting}: track 0 vs float64 {row['snr_vs_f64_db']:.1f} dB "
                  f"(floor {MIN_MATMUL_F64_SNR_DB[setting]}), card route vs the rounded operands "
                  f"through exact float32 products {row['snr_vs_emulation_db']:.1f} dB, "
                  f"{row['ms']:.4f} ms (exact-f32 products of the rounded operands "
                  f"{row['emulation_ms']:.4f} ms); torch.backends flags unchanged: {after}")
            if not (row["snr_vs_f64_db"] >= MIN_MATMUL_F64_SNR_DB[setting]
                    and row["snr_vs_emulation_db"] >= MIN_MATMUL_EMULATION_SNR_DB):
                raise AssertionError(f"'matmul' route at {setting}: {row}")
    finally:
        fft.set_stft_backend("auto", precision="highest")
    del frames_d, pw64

    # the scans: each launch of the path against its plain loop, bit for bit; the DP's walks
    # (greedy launches n_scans onwards) take exactly the DP's flags
    for args, _ in g_spy.calls:
        cand, wait = args
        got = peaks.greedy_scan(cand, wait).cpu().numpy()
        if not np.array_equal(got, peaks.greedy_select(cand.cpu().numpy(), wait)):
            raise AssertionError(f"greedy_scan at wait {wait}: not the plain loop's mask")
    for j, (args, _) in enumerate(d_spy.calls):
        cand, gain, wait = args
        want = peaks.dp_flags(cand.cpu().numpy(), gain.cpu().numpy(), wait)
        if not np.array_equal(peaks.dp_scan(cand, gain, wait).cpu().numpy(), want):
            raise AssertionError(f"dp_scan at wait {wait}: not the plain loop's flags")
        walked, walk_wait = g_spy.calls[n_scans + j][0]
        if walk_wait != wait or not np.array_equal(walked.cpu().numpy(), want):
            raise AssertionError(f"the DP's walk at wait {wait} did not take the DP's flags")
    for i, wait in enumerate(SCAN_WAITS):
        cand = g_spy.calls[i][0][0].cpu().numpy()
        if not np.array_equal(picks["greedy", wait], peaks.greedy_select(cand, wait)):
            raise AssertionError(f"onset_detect greedy at wait {wait}: not the plain loop's")
        for j, method in enumerate(("dp_count", "dp_value")):
            cand, gain, _ = d_spy.calls[j * n_scans + i][0]
            want = peaks.dp_select(cand.cpu().numpy(), gain.cpu().numpy(), wait)
            if not np.array_equal(picks[method, wait], want):
                raise AssertionError(f"onset_detect {method} at wait {wait}: not the plain loop's")
    rng = np.random.RandomState(16)
    small = scan_cases(rng)
    routes = {}
    t0 = time.perf_counter()
    for label, cand, gain, wait in small:
        c_d, g_d = torch.from_numpy(cand).to(device), torch.from_numpy(gain).to(device)
        dp_route = peaks.dp_route(cand.shape[1], wait)
        routes[dp_route] = routes.get(dp_route, 0) + 1
        if not (np.array_equal(peaks.greedy_scan(c_d, wait).cpu().numpy(),
                               peaks.greedy_select(cand, wait))
                and np.array_equal(peaks.dp_scan(c_d, g_d, wait).cpu().numpy(),
                                   peaks.dp_flags(cand, gain, wait))):
            raise AssertionError(f"peak_scan {label} ({dp_route} route): not the plain loops' "
                                 "bits")
    if routes.get("scratch", 0) != 2:
        raise AssertionError(f"the small cases took the DP's routes {routes}")
    print(f"peak_scan: every launch of the path ({len(g_spy.calls)} greedy, of them "
          f"{len(g_spy.calls) - n_scans} walks over the DP's flags; {len(d_spy.calls)} dp) and "
          f"{len(small)} small cases (rows 1-70, T 1-2**21, wait 0 to 2**31 - 1, tied gains; DP "
          f"routes {routes}) bit-equal to the plain loops, {time.perf_counter() - t0:.1f} s; "
          "peaks per method and wait: "
          + ", ".join(f"{m} {w}: {int(v.sum())}" for (m, w), v in picks.items()))

    # the batch: SCAN_BATCH rows of the envelope shifted, through onset_detect once per method
    env_b = torch.cat([torch.roll(env, 97 * k, dims=-1) for k in range(SCAN_BATCH // rows)])
    with CallSpy(peaks, "greedy_scan", keep=3) as gb_spy, \
            CallSpy(peaks, "dp_scan", keep=2) as db_spy:
        for method in SCAN_METHODS:
            L.onset.onset_detect(onset_envelope=env_b, sr=SR, sparse=False, method=method, wait=10)
    shapes = {f"{rows}x{env.shape[-1]}": (g_spy.calls[0][0][0], d_spy.calls[n_scans][0][1]),
              f"{SCAN_BATCH}x{env.shape[-1]}": (gb_spy.calls[0][0][0], db_spy.calls[-1][0][1])}

    # times: each kernel at each wait beside its plain loop (host clock), the DP's scratch route
    # (a thread a row, its values in device memory) on the same inputs, the probes and the
    # launch floor
    floor_ms = peaks.launch_floor_ms(device)
    by_shape = {}
    for label, (cand, gain) in shapes.items():
        n_rows, T = cand.shape
        host_c, host_g = cand.cpu().numpy(), gain.cpu().numpy()
        rows_out = {}
        for wait in SCAN_TIME_WAITS:
            walk = peaks.walk_floor_ms(cand, wait)
            row = {
                "greedy_ms": time_ms(torch, lambda: peaks.greedy_scan(cand, wait), 20),
                "dp_ms": time_ms(torch, lambda: peaks.dp_scan(cand, gain, wait), 20),
                "dp_route": peaks.dp_route(T, wait),
                "dp_scratch_route_ms": time_ms(
                    torch, lambda: peaks._dp_launch(cand, gain, wait, "scratch"), 5),
                "greedy_plain_ms": 1e3 * best_s(lambda: peaks.greedy_select(host_c, wait), 2),
                "dp_plain_ms": 1e3 * best_s(lambda: peaks.dp_flags(host_c, host_g, wait), 2),
                "walk_probe_ms": walk["ms"], "walk_steps": walk["steps"],
                "takes": walk["takes"],
                "countdown_probe_ms": peaks.chain_floor_ms(n_rows, T, wait, dp=False,
                                                           device=device),
                "dp_chain_probe_ms": peaks.chain_floor_ms(n_rows, T, wait, dp=True,
                                                          device=device),
            }
            rows_out[str(wait)] = row
            print(f"peak_scan on {label} at wait {wait}: greedy {row['greedy_ms']:.4f} ms (walk "
                  f"probe {row['walk_probe_ms']:.4f}, {row['walk_steps']} steps on the slowest "
                  f"row, {row['takes']} takes; countdown probe {row['countdown_probe_ms']:.4f}), "
                  f"dp {row['dp_ms']:.4f} ms by the {row['dp_route']} route (scratch route "
                  f"{row['dp_scratch_route_ms']:.4f}; chain probe "
                  f"{row['dp_chain_probe_ms']:.4f}); plain loops {row['greedy_plain_ms']:.4f} / "
                  f"{row['dp_plain_ms']:.4f} ms (host clock)")
        by_shape[label] = rows_out
    print(f"peak_scan: an empty launch {floor_ms:.4f} ms")

    at_main = by_shape[f"{rows}x{env.shape[-1]}"]
    T = env.shape[-1]
    scans = {}
    for name, dp in (("peak_scan_greedy", False), ("peak_scan_dp", True)):
        key = "dp" if dp else "greedy"
        moved = rows * T * (1 + 4 + 1 if dp else 1 + 1)  # flags (and gains) in, flags out
        b_ms = 1e3 * moved / H100_HBM_BYTES_S
        o_ms = 1e3 * rows * T * (2 if dp else 3) / H100_F32_FLOP_S
        scans[name] = {
            "name": name, "route": "cuda", "source": "librosa_tpu_torch/csrc/peak_scan.cu",
            "replaces": ("librosa_tpu/ops/peaks.py:158 dp_values (an XLA scan: no Pallas kernel "
                         "replaced)" if dp else "librosa_tpu/ops/peaks.py:99 greedy_mask (an XLA "
                         "scan: no Pallas kernel replaced)"),
            "launches": counts[name], "launches_by_path": {"precision_scans": counts[name]},
            "max_abs_err": 0.0, "ms": at_main["10"][f"{key}_ms"],
            "plain_ms": at_main["10"][f"{key}_plain_ms"],
            "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": None,
            "chain_bound_ms": at_main["10"]["dp_chain_probe_ms" if dp else "walk_probe_ms"],
            "launch_floor_ms": floor_ms,
            "by_shape_and_wait": {
                label: {w: {k: v for k, v in r.items()
                            if k.startswith(key) or k in (
                                ("dp_chain_probe_ms",) if dp else
                                ("walk_probe_ms", "walk_steps", "takes", "countdown_probe_ms"))}
                        for w, r in rows_out.items()}
                for label, rows_out in by_shape.items()},
            "shape": [rows, T],
        }
    detect_s = {}
    for label, e in ((f"{rows}x{T}", env), (f"{SCAN_BATCH}x{T}", env_b)):
        detect_s[label] = {m: best_s(lambda: L.onset.onset_detect(
            onset_envelope=e, sr=SR, sparse=False, method=m, wait=10), 3) for m in SCAN_METHODS}
        print(f"onset_detect(sparse=False, wait=10) on {label} end to end (s, host clock): "
              + ", ".join(f"{m} {v:.6f}" for m, v in detect_s[label].items()))
    return {"launches": counts, "dial": dial, "matmul_route": route, "scans": scans,
            "onset_detect_s": detect_s}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import librosa_tpu_torch as L
    from librosa_tpu_torch.entry import entry
    from librosa_tpu_torch.ops import _build, db_scale, fused_stft

    device = torch.device("cuda")
    L.set_device(device)
    name = torch.cuda.get_device_name(0)
    smi = smi_line()

    # 0. build, one nvcc per source, all at once
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(_build.SOURCES)} with nvcc and "
          f"{sorted(_build.HOST_SOURCES)} with g++")
    for kernel in sorted(_build.SOURCES):
        for line in _build.build_log(kernel).splitlines():
            if ("registers" in line or "spill" in line or "smem" in line
                    or "entry function" in line):
                print(f"ptxas {kernel}: {line.strip()}")

    # 1. environment
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
          f"count {torch.cuda.device_count()}")
    print(smi)

    # 2. kernel against its plain version on the card, and against float64
    rng = np.random.RandomState(0)
    cases = kernel_cases(L, rng, fused_stft._tile_frames)
    for label, y, win, basis, kw, floor in cases:
        yd = torch.from_numpy(y).to(device)
        got = checked_kernel(torch, fused_stft, yd, win, basis, **kw)
        want = fused_stft.stft_mel_reference(yd, win, basis, **kw)
        torch.cuda.synchronize()
        s = snr_db(got.cpu().numpy(), want.cpu().numpy())
        print(f"kernel vs plain  {label}: {s:.1f} dB (floor {floor})")
        if not s >= floor:
            raise AssertionError(f"kernel vs plain {label}: {s:.1f} dB < {floor}")
    print(f"kernel vs plain: {len(cases)} cases passed, each on NaN-filled memory")
    per_frame_and_track_checks(torch, L, fused_stft, rng, device)
    win = L.filters.get_window("hann", MAIN["n_fft"])
    mel_basis = L.filters.mel(sr=SR, n_fft=MAIN["n_fft"], n_mels=MAIN["n_mels"])
    y4 = (rng.randn(4 * SR) * 0.1).astype(np.float32)
    got = checked_kernel(torch, fused_stft, torch.from_numpy(y4).to(device), win, mel_basis,
                         n_fft=MAIN["n_fft"], hop_length=MAIN["hop_length"])
    snr64 = snr_db(got.cpu().numpy(), mel64(y4, win, mel_basis, n_fft=MAIN["n_fft"],
                                            hop=MAIN["hop_length"]))
    print(f"kernel vs float64 numpy, 4 s at n_fft 2048 / hop 512 / 128 mels: {snr64:.1f} dB")
    if not snr64 >= MIN_SNR_DB:
        raise AssertionError(f"kernel vs float64: {snr64:.1f} dB < {MIN_SNR_DB}")

    # 3. main path at full width, through the public functions
    gen = torch.Generator(device=device).manual_seed(0)
    y = 0.1 * torch.randn(MAIN_SHAPE, generator=gen, device=device, dtype=torch.float32)

    def main_path(y):
        M = L.feature.melspectrogram(y=y, sr=SR, **MAIN)
        return M, L.feature.mfcc(S=L.power_to_db(M), n_mfcc=20)

    fused_stft.launches = 0
    db_scale.launches = 0
    M, C = main_path(y)
    torch.cuda.synchronize()
    main_launches = fused_stft.launches
    main_db_launches = db_scale.launches
    n_frames = 1 + MAIN_SHAPE[1] // MAIN["hop_length"]
    print(f"main path: y {tuple(y.shape)} -> mel {tuple(M.shape)} -> mfcc {tuple(C.shape)}, "
          f"stft_mel launches {main_launches}, db_scale launches {main_db_launches}")
    if main_launches < 1:
        raise AssertionError("the main path did not launch the stft_mel kernel")
    if main_db_launches < 1:
        raise AssertionError("the main path did not launch the db_scale kernel")
    if tuple(M.shape) != (MAIN_SHAPE[0], MAIN["n_mels"], n_frames):
        raise AssertionError(f"mel shape {tuple(M.shape)}")
    if tuple(C.shape) != (MAIN_SHAPE[0], 20, n_frames):
        raise AssertionError(f"mfcc shape {tuple(C.shape)}")
    if not (torch.isfinite(M).all() and torch.isfinite(C).all()):
        raise AssertionError("non-finite values on the main path")
    y0 = y[0].cpu().numpy()
    ref_mel = mel64(y0, win, mel_basis, n_fft=MAIN["n_fft"], hop=MAIN["hop_length"])
    mel_snr = snr_db(M[0].cpu().numpy(), ref_mel)
    mfcc_snr = snr_db(C[0].cpu().numpy(), mfcc64(ref_mel))
    print(f"main path track 0 ({MAIN_SHAPE[1] / SR:.1f} s) vs float64 numpy: "
          f"mel {mel_snr:.1f} dB, mfcc {mfcc_snr:.1f} dB")
    if not mel_snr >= MIN_SNR_DB:
        raise AssertionError(f"main path mel {mel_snr:.1f} dB < {MIN_SNR_DB}")
    if not mfcc_snr >= MIN_MFCC_SNR_DB:
        raise AssertionError(f"main path mfcc {mfcc_snr:.1f} dB < {MIN_MFCC_SNR_DB}")

    forward, args = entry()
    out = forward(*args)
    y_e = (np.random.RandomState(1).randn(*args[0].shape) * 0.1).astype(np.float32)
    out_e = forward(y_e)
    e_snr = snr_db(out_e.cpu().numpy(),
                   mfcc64(mel64(y_e, win, mel_basis, n_fft=2048, hop=512)))
    print(f"entry(): zeros -> {tuple(out.shape)}, 4 s noise vs float64: {e_snr:.1f} dB")
    if tuple(out.shape) != (20, 173) or not torch.isfinite(out).all():
        raise AssertionError(f"entry() output {tuple(out.shape)}")
    if not e_snr >= MIN_MFCC_SNR_DB:
        raise AssertionError(f"entry() {e_snr:.1f} dB < {MIN_MFCC_SNR_DB}")

    # 4. times at the main-path shape
    win_d = torch.from_numpy(win.astype(np.float32)).to(device)
    # row-major with its band table beside it, as feature.melspectrogram keeps them
    basis_d = torch.from_numpy(mel_basis.astype(np.float32)).to(device)
    bands_d = torch.from_numpy(fused_stft.basis_bands(mel_basis)).to(device)
    kw = dict(n_fft=MAIN["n_fft"], hop_length=MAIN["hop_length"])
    full = dict(kw, power=2.0, center=True, pad_mode="constant")
    poison(torch, (MAIN_SHAPE[0], MAIN["n_mels"], n_frames), device)
    k_out = fused_stft._fused(y, win_d, basis_d, bands_d, **full)
    p_out = fused_stft.stft_mel_reference(y, win_d, basis_d, **kw)
    max_abs_err = float((k_out - p_out).abs().max())
    # per track, so that one wrong track cannot hide in the pooled SNR
    err = (k_out.double() - p_out.double()).square().sum(dim=(-2, -1))
    sig = p_out.double().square().sum(dim=(-2, -1))
    track_snr = (10 * torch.log10(sig / err.clamp(min=1e-300))).cpu().numpy()
    main_snr = float(track_snr.min())
    del k_out, p_out, err, sig
    print(f"kernel vs plain at the main-path shape, per track: min {main_snr:.1f} dB, "
          f"max {float(track_snr.max()):.1f} dB over {len(track_snr)} tracks, "
          f"max |err| {max_abs_err:.3e}")
    if not main_snr >= MIN_SNR_DB:
        raise AssertionError(f"kernel vs plain at the main-path shape: track "
                             f"{int(track_snr.argmin())} at {main_snr:.1f} dB < {MIN_SNR_DB}")
    # as the main path calls it, the band table given; then with the table derived per call
    kernel_ms = time_ms(torch, lambda: fused_stft._fused(y, win_d, basis_d, bands_d, **full), 20)
    derived_ms = time_ms(torch, lambda: fused_stft.stft_mel_fused(y, win_d, basis_d, **kw), 20)
    plain_ms = time_ms(torch, lambda: fused_stft.stft_mel_reference(y, win_d, basis_d, **kw), 5)

    def library():
        spec = torch.stft(y, MAIN["n_fft"], MAIN["hop_length"], window=win_d, center=True,
                          pad_mode="constant", return_complex=True)
        return torch.matmul(basis_d, spec.real.square() + spec.imag.square())

    torch.backends.cuda.matmul.allow_tf32 = False
    library_ms = time_ms(torch, library, 5)
    e2e_ms = time_ms(torch, lambda: main_path(y), 5)
    db_in = L.feature.melspectrogram(y=y, sr=SR, **MAIN)
    db_ms = time_ms(torch, lambda: L.power_to_db(db_in), 5)
    mfcc_in = L.power_to_db(db_in)
    mfcc_ms = time_ms(torch, lambda: L.feature.mfcc(S=mfcc_in, n_mfcc=20), 5)
    del mfcc_in
    samples = MAIN_SHAPE[0] * MAIN_SHAPE[1]
    frames = MAIN_SHAPE[0] * n_frames

    if "H100" not in name:
        raise AssertionError(f"the bound uses the H100 datasheet, not {name!r}")
    bytes_moved = 4 * samples + 4 * MAIN["n_mels"] * frames
    # the function's own work: a real FFT and the basis's nonzeros (mel is banded)
    basis_nnz = int(torch.count_nonzero(basis_d))
    flops_frame = fused_stft.flops_per_frame(MAIN["n_fft"], basis_nnz)
    flops = flops_frame * frames
    bytes_ms = 1e3 * bytes_moved / H100_HBM_BYTES_S
    ops_ms = 1e3 * flops / H100_F32_FLOP_S
    bound_ms = max(bytes_ms, ops_ms)
    # the kernel as written: window, a complex FFT of n_fft/2 points, 18 flops to unpack
    # each pair of bins, |X|^2, and the projection through every column of each row's band
    half, band_cells = MAIN["n_fft"] // 2, int((bands_d[:, 1] - bands_d[:, 0]).sum())
    done_frame = (MAIN["n_fft"] + 5 * half * (half.bit_length() - 1) + 18 * (half // 2 + 1)
                  + 3 * (half + 1) + 2 * band_cells)
    print(f"bound counts {flops_frame} flops per frame (basis nonzeros {basis_nnz} of "
          f"{basis_d.numel()}) and {bytes_moved} bytes, over {frames} frames; "
          f"the kernel as written does {done_frame} flops per frame")
    print(f"stft_mel kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.stft+matmul {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"(bytes {bytes_ms:.4f} ms, operations {ops_ms:.4f} ms; H100 SXM datasheet)")
    print(f"stft_mel with the band table derived on the card per call: {derived_ms:.4f} ms")
    print(f"end to end mel -> dB -> mfcc: {e2e_ms:.4f} ms, {samples / (e2e_ms / 1e3):.6e} samples/s "
          f"on {MAIN_SHAPE}, with the db_scale kernel in it; alone, power_to_db {db_ms:.4f} ms, "
          f"mfcc (DCT) {mfcc_ms:.4f} ms")
    db_entry = db_kernel_phase(torch, L, rng, device, db_in)
    del db_in
    stack = feature_stack_phase(torch, L, device, y, win, mel_basis, kernel_ms)
    ola_kernel_phase(torch, L, rng, device)
    recon = reconstruction_phase(torch, L, device, y, win)
    tuning_phase(torch, L, device, y, win)
    median_kernel_phase(torch, L, rng, device)
    config4 = cqt_hpss_phase(torch, L, device, y, win)
    from_files = files_phase(torch, L, device, smi)
    config5 = config5_phase(torch, L, device)
    structure = structure_phase(torch, L, device, win)
    effects = effects_phase(torch, L, device, y, win)
    features = features_inversion_phase(torch, L, device, y, win)
    pcen_ext = pcen_spectrum_ext_phase(torch, L, device, y, win)
    seg_infra = segment_infrastructure_phase(torch, L, device, y)
    sharded = sharded_phase(torch, L, device, y)
    dial_scans = precision_scan_phase(torch, L, device, y, win, mel_basis)
    stft_mel_entry = {
        "name": "stft_mel",
        "route": "cuda",
        "source": "librosa_tpu_torch/csrc/stft_mel.cu",
        "replaces": "librosa_tpu/ops/pallas_stft.py:487",
        "launches": (main_launches + stack["launches"]["stft_mel"]
                     + recon["launches"]["stft_mel"] + from_files["launches"]["stft_mel"]
                     + config5["launches"]["stft_mel"] + config5["bench_launches"]["stft_mel"]),
        "launches_by_path": {"mel_db_mfcc": main_launches,
                             "feature_stack": stack["launches"]["stft_mel"],
                             "reconstruction": recon["launches"]["stft_mel"],
                             "cqt_hpss": config4["launches"]["stft_mel"],
                             "config1_files": from_files["launches"]["stft_mel"],
                             "onset_beat_pyin": config5["launches"]["stft_mel"],
                             "config5_bench_1d": config5["bench_launches"]["stft_mel"]},
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "snr_db": main_snr,
        "other_bases": {**stack["bases"], "pseudo_cqt": config4["pseudo_cqt_basis"]},
        "precision": dial_scans["dial"],
        "reconstruction_shape": recon["stft_mel"],
    }
    db_entry["launches"] = (main_db_launches + stack["launches"]["db_scale"]
                            + from_files["launches"]["db_scale"]
                            + config5["launches"]["db_scale"]
                            + config5["bench_launches"]["db_scale"])
    db_entry["launches_by_path"] = {"mel_db_mfcc": main_db_launches,
                                    "feature_stack": stack["launches"]["db_scale"],
                                    "reconstruction": recon["launches"]["db_scale"],
                                    "cqt_hpss": config4["launches"]["db_scale"],
                                    "config1_files": from_files["launches"]["db_scale"],
                                    "onset_beat_pyin": config5["launches"]["db_scale"],
                                    "config5_bench_1d": config5["bench_launches"]["db_scale"]}
    diag_entries = staged_diagnostics(torch, device, y, kernel_ms)
    ola_entry = recon["ola_norm"]
    ola_entry["launches"] += config4["launches"]["ola_norm"]
    ola_entry["launches_by_path"]["cqt_hpss"] = config4["launches"]["ola_norm"]
    ola_entry["launches"] += from_files["launches"]["ola_norm"]
    ola_entry["launches_by_path"]["config1_files"] = from_files["launches"]["ola_norm"]
    median_entry = config4["median_filter"]
    median_entry["launches"] += from_files["launches"]["median_filter"]
    median_entry["launches_by_path"]["config1_files"] = from_files["launches"]["median_filter"]
    for entry, kernel in ((ola_entry, "ola_norm"), (median_entry, "median_filter")):
        entry["launches"] += config5["launches"][kernel] + config5["bench_launches"][kernel]
        entry["launches_by_path"]["onset_beat_pyin"] = config5["launches"][kernel]
        entry["launches_by_path"]["config5_bench_1d"] = config5["bench_launches"][kernel]
    for entry, kernel in ((stft_mel_entry, "stft_mel"), (db_entry, "db_scale"),
                          (ola_entry, "ola_norm"), (median_entry, "median_filter"),
                          (config5["beat_dp"], "beat_dp"), (config5["viterbi"], "viterbi"),
                          (config5["trough_priors"], "trough_priors")):
        for path, phase in (("alignment_structure", structure), ("effects", effects),
                            ("features_inversion", features), ("pcen_spectrum_ext", pcen_ext),
                            ("segment_infrastructure", seg_infra), ("sharded", sharded),
                            ("precision_scans", dial_scans)):
            entry["launches"] += phase["launches"].get(kernel, 0)
            entry["launches_by_path"][path] = phase["launches"].get(kernel, 0)
    print(json.dumps({"kernels": [stft_mel_entry, db_entry, ola_entry, median_entry,
                                  config5["beat_dp"], config5["viterbi"],
                                  config5["trough_priors"], *dial_scans["scans"].values(),
                                  *diag_entries]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
