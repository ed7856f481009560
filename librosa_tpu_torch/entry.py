"""Entry points: each main path as one forward function, with an example input, and the
multi-position dry run of the sharded layer."""

from __future__ import annotations

import numpy as np

from . import beat, effects, feature, onset
from .core.audio import resample
from .core.constantq import cqt
from .core.pitch import pyin
from .core.spectrum import _spectrogram, griffinlim, power_to_db

SR = 22050


def entry():
    """Return ``(forward, example_args)`` for y -> mel spectrogram -> dB -> MFCC.

    The same forward as the JAX package's entry: 4 s at 22050 Hz, n_fft
    2048, hop 512, 128 mels, 20 coefficients.
    """
    def forward(y):
        M = feature.melspectrogram(y=y, sr=SR, n_fft=2048, hop_length=512, n_mels=128)
        return feature.mfcc(S=power_to_db(M), n_mfcc=20)

    return forward, (np.zeros(SR * 4, dtype=np.float32),)


def feature_stack():
    """Return ``(forward, example_args)`` for the feature stack of a batch of tracks.

    ``forward(y)`` gives ``(mfcc, chroma, centroid, rolloff)`` of ``y``
    ``(..., n)``: 20 MFCCs over 128 mels, 12 chroma at A440, spectral
    centroid and 85 % roll-off, all at n_fft 2048 and hop 512. Each feature
    is computed from ``y`` on its own, as the four public functions do: on
    the card the stft_mel kernel runs four times (mel, chroma and twice the
    identity basis) and the db_scale kernel once.
    """
    kw = dict(sr=SR, n_fft=2048, hop_length=512)

    def forward(y):
        return (feature.mfcc(y=y, n_mfcc=20, n_mels=128, **kw),
                feature.chroma_stft(y=y, tuning=0.0, n_chroma=12, **kw),
                feature.spectral_centroid(y=y, **kw),
                feature.spectral_rolloff(y=y, **kw))

    return forward, (np.zeros((2, SR * 4), dtype=np.float32),)


def reconstruction(init="random"):
    """Return ``(forward, example_args)`` for resample -> |STFT| -> Griffin-Lim.

    ``forward(y)`` resamples ``y`` ``(..., n)`` from 22050 Hz to 16000 Hz
    (polyphase: up 320, down 441), takes the magnitude spectrogram at n_fft
    2048 and hop 512, and recovers a signal from the magnitudes alone with
    32 rounds of Griffin-Lim from seed 0. It returns ``(y16k, y_hat)``, both
    ``(..., ceil(n * 320 / 441))``. On the card the stft_mel kernel runs once
    (identity basis) and the ola_norm kernel 33 times. ``init=None`` starts
    from zero phase instead of random phases.
    """
    kw = dict(n_fft=2048, hop_length=512)

    def forward(y):
        y16k = resample(y, orig_sr=SR, target_sr=16000, res_type="polyphase")
        S, _ = _spectrogram(y=y16k, power=1, **kw)
        y_hat = griffinlim(S, n_iter=32, rng=0, init=init, length=y16k.shape[-1], **kw)
        return y16k, y_hat

    return forward, (np.zeros((2, SR * 4), dtype=np.float32),)


def cqt_hpss():
    """Return ``(forward, example_args)`` for the constant-Q transform and HPSS of a batch of tracks.

    ``forward(y)`` gives ``(C, y_harm, y_perc)`` of ``y`` ``(..., n)``: the
    constant-Q transform at 84 bins, 12 to the octave from C1, hop 512, with
    the octaves resampled by ``'polyphase'``, and the harmonic and percussive
    waveforms of :func:`effects.hpss` at its defaults (n_fft 2048, hop 512,
    median filters of 31, power 2, margin 1). On the card the median_filter
    kernel runs twice and the ola_norm kernel twice.
    """
    def forward(y):
        C = cqt(y, sr=SR, hop_length=512, n_bins=84, bins_per_octave=12, res_type="polyphase")
        y_harm, y_perc = effects.hpss(y)
        return C, y_harm, y_perc

    return forward, (np.zeros((2, SR * 4), dtype=np.float32),)


def onset_beat_pyin():
    """Return ``(forward, example_args)`` for onset strength, tempo, beats and pYIN of a batch of tracks.

    ``forward(y)`` gives ``(onset_envelope, tempo, beats, (f0, voiced_flag,
    voiced_prob))`` of ``y`` ``(..., n)``: the onset envelope (median over
    128 mels of the dB flux, n_fft 2048, hop 512, as ``beat.beat_track``
    computes it from ``y``), the tempo per track (numpy), the beat mask of
    ``beat.beat_track(..., sparse=False)`` (numpy) and ``pyin(y, fmin=65,
    fmax=800)``. On the card the stft_mel and db_scale kernels run once
    each, the beat DP kernel once and the Viterbi kernel once.
    """
    def forward(y):
        env = onset.onset_strength(y=y, sr=SR, hop_length=512, aggregate=np.median)
        tempo = feature.tempo(onset_envelope=env, sr=SR, hop_length=512)
        _, beats = beat.beat_track(onset_envelope=env, sr=SR, hop_length=512, bpm=tempo,
                                   sparse=False)
        return env, tempo, beats, pyin(y, fmin=65, fmax=800, sr=SR)

    return forward, (np.zeros((2, SR * 4), dtype=np.float32),)


def _dp_sp(n_devices: int):
    """``(dp, sp)``: ``sp`` the largest of 4 and 2 that divides ``n_devices`` (else 1)."""
    sp = next((c for c in (4, 2) if n_devices % c == 0), 1)
    return n_devices // sp, sp


def dryrun_multichip(n_devices: int, *, devices=None) -> dict:
    """One training step and the sharded chains over ``n_devices`` mesh positions.

    A ``(dp, sp)`` mesh (``sp`` 4 or 2 where it divides, the rest ``dp``)
    holds a batch of ``2 dp`` seeded signals, split by rows over ``dp`` and
    in time over ``sp`` with halo exchange. A learnable mel filterbank and a
    linear head, replicated on every position, take two steps of gradient
    descent on a mean squared error: the forward is ``rfft`` and
    ``torch.matmul`` on each position, the time mean a sum over positions
    (:func:`parallel.collectives.psum`), and the gradient of each parameter
    the sum of its copies' gradients (across processes an ``all_reduce``).
    Then the onset, constant-Q, pYIN, beat and HPSS chains run on a time
    mesh of the same positions. ``devices`` lays the positions (default:
    every visible one); ``[torch.device("cuda:0")] * 8`` puts eight on one
    card. Returns the losses, the first step's gradients and each chain's
    output shape; raises if the loss rises or a value is not finite.
    """
    import torch

    from . import filters
    from ._device import exact_f32
    from .core.spectrum import _win_device
    from .parallel import (beat_track_sharded, cqt_sharded, hpss_sharded, make_mesh,
                           onset_strength_sharded, pyin_sharded, time_mesh)
    from .parallel.collectives import Line, psum, split
    from .parallel.mesh import _visible
    from .parallel.sharded import _local_frames

    owners = None
    if devices is None:
        owners, devices = (list(t) for t in zip(*_visible()))
    devices = [torch.device(d) for d in devices]
    if len(devices) < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) but only {len(devices)} devices")
    dp, sp = _dp_sp(n_devices)
    mesh = make_mesh((dp, sp), ("dp", "sp"), devices=devices[:n_devices],
                     processes=None if owners is None else owners[:n_devices])
    n_fft, hop, n_mels, n_out = 512, 128, 16, 4
    batch, n = 2 * dp, sp * hop * 16
    rows = batch // dp
    rng = np.random.RandomState(0)
    y = rng.randn(batch, n).astype(np.float32)
    fb = filters.mel(sr=SR, n_fft=n_fft, n_mels=n_mels).astype(np.float32)
    head = (rng.randn(n_mels, n_out) * 0.1).astype(np.float32)
    target = rng.randn(batch, n_out).astype(np.float32)

    # each position's power spectra (rows of its dp block, frames of its sp block): inputs
    whole = Line.whole(mesh)
    power = {}
    for i in range(dp):
        line = Line.of(mesh, "sp", at={"dp": i})
        shards = split(torch.from_numpy(y[i * rows:(i + 1) * rows]), line)
        wins = [_win_device("hann", n_fft, n_fft, d, torch.float32) for d in line.local_devices]
        frames = _local_frames(shards, wins, line, n_fft=n_fft, hop_length=hop,
                               pad_mode="constant")
        for j, f in zip(line.local, frames):
            power[(i, j)] = torch.fft.rfft(f, dim=-1).abs().square()   # (rows, T_loc, bins)
    where = [np.unravel_index(p, (dp, sp)) for p in whole.local]
    n_frames = n // hop
    world = torch.distributed.get_world_size() if whole.spans else 1

    def step(fb_now: torch.Tensor, head_now: torch.Tensor):
        copies = [tuple(p.to(d, copy=True).requires_grad_() for p in (fb_now, head_now))
                  for d in whole.local_devices]
        with exact_f32():
            sums = []
            for (i, j), (f, _) in zip(where, copies):
                feats = torch.log1p(torch.matmul(power[(i, j)], f.T).clamp_min(0.0))
                part = feats.sum(dim=1)                                 # (rows, n_mels)
                sums.append(torch.stack([part if r == i else torch.zeros_like(part)
                                         for r in range(dp)]))
            pooled = psum(sums, whole)
            losses = []
            for (i, j), (_, h), pool in zip(where, copies, pooled):
                tgt = torch.from_numpy(target[i * rows:(i + 1) * rows]).to(h.device)
                pred = torch.matmul(pool[i] / n_frames, h)
                losses.append((pred - tgt).square().sum() / (batch * n_out * sp))
        loss = psum(losses, whole)[0]
        (loss / world).backward()
        grads = []
        for k in range(2):
            g = sum(c[k].grad.to(whole.home) for c in copies)
            if whole.spans:
                torch.distributed.all_reduce(g)
            grads.append(g)
        return float(loss.detach()), grads

    fb_t, head_t = torch.from_numpy(fb).to(whole.home), torch.from_numpy(head).to(whole.home)
    l0, (g_fb, g_head) = step(fb_t, head_t)
    l1, _ = step(fb_t - 1e-4 * g_fb, head_t - 1e-4 * g_head)
    if not (np.isfinite(l0) and np.isfinite(l1)):
        raise AssertionError(f"non-finite loss in dryrun: {l0} -> {l1}")
    if not l1 <= l0 + 1e-3:
        raise AssertionError(f"training step diverged: {l0} -> {l1}")
    print(f"dryrun_multichip OK: mesh=({dp}x{sp}) dp x sp on {sorted({str(d) for d in devices})}, "
          f"loss {l0:.5f} -> {l1:.5f}")

    tmesh = time_mesh(n_devices, devices=devices[:n_devices])
    hop_c = 64
    n_c = n_devices * hop_c * 64
    y_c = (0.4 * np.sin(2 * np.pi * 440 * np.arange(n_c) / SR)).astype(np.float32)
    env = onset_strength_sharded(y_c, mesh=tmesh, sr=SR, n_fft=512, hop_length=hop_c)
    C = cqt_sharded(y_c, mesh=tmesh, sr=SR, n_bins=24, bins_per_octave=12, hop_length=hop_c,
                    fmin=220.0)
    hop_p = 256
    n_p = n_devices * hop_p * 8
    y_p = (0.4 * np.sin(2 * np.pi * 220 * np.arange(n_p) / SR)).astype(np.float32)
    f0, _, voiced_prob = pyin_sharded(y_p, mesh=tmesh, fmin=110, fmax=440, sr=SR,
                                      frame_length=1024, hop_length=hop_p)
    tempo, _ = beat_track_sharded(y_p, mesh=tmesh, sr=SR, hop_length=hop_p)
    n_h = n_devices * 512 * 40
    y_h = np.sin(2 * np.pi * 220 * np.arange(n_h) / SR).astype(np.float32)
    harm, perc = hpss_sharded(y_h, mesh=tmesh)
    checks = {"onset": (env.shape[-1] == n_c // hop_c + 1) and bool(torch.isfinite(env).all()),
              "cqt": bool(torch.isfinite(C.abs()).all()),
              "pyin": f0.shape[-1] == n_p // hop_p + 1 and bool(torch.isfinite(voiced_prob).all()),
              "beat": bool(np.isfinite(np.asarray(tempo, dtype=float)).all()),
              "hpss": bool(torch.isfinite(harm).all() and torch.isfinite(perc).all())}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"dryrun sharded chains failed: {failed}")
    shapes = {"onset": tuple(env.shape), "cqt": tuple(C.shape), "pyin": tuple(f0.shape),
              "hpss": (tuple(harm.shape), tuple(perc.shape))}
    print(f"dryrun sharded chains OK on a {n_devices}-way time mesh: {shapes}, "
          f"tempo {np.asarray(tempo, dtype=float)}")
    return {"mesh": (dp, sp), "losses": (l0, l1),
            "grads": {"fb": g_fb.cpu().numpy(), "head": g_head.cpu().numpy()},
            "shapes": shapes}
