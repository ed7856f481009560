"""Plain float64 reference of the ``onset_beat_pyin`` configuration.

librosa's definitions at the configuration's settings:

- onset strength: the dB mel spectrogram (128 Slaney mels up to ``sr / 2``,
  80 dB below each track's peak), its positive one-frame difference, the
  median over bands (the mean of the two middle values), shifted onto
  centred frames;
- tempo: the autocorrelation tempogram of 8 s windows (Hann, the ends
  ramped to zero, each column over its maximum), averaged over frames, the
  lag that maximises ``log1p(1e6 tg)`` plus a log-normal prior around
  120 BPM, tempi from 320 BPM up excluded;
- beats (Ellis 2007): the envelope over its standard deviation smoothed by
  a Gaussian of one beat at the first track's tempo (librosa's rule for a
  batch), the dynamic program over predecessors at ``round(fpb / 2)`` to
  ``2 fpb`` frames with the penalty ``tightness (log d - log fpb)**2``
  (the smallest distance of equal scores; no link before the first frame
  that reaches a hundredth of the row's maximum), the last strong local
  maximum, backtracking, and the trimming of weak beats at both ends;
- pYIN (Mauch and Dixon 2014): YIN's cumulative mean normalised difference
  by FFT autocorrelation, parabolic refinement, troughs, the prior mass of
  100 beta-weighted thresholds by a Boltzmann law, pitch bins of 0.1
  semitone, and Viterbi decoding over 2 x 435 states with a triangular
  pitch transition of 101 bins, a voicing switch of 0.01, and transitions
  below 1e-4 removed.
"""

from __future__ import annotations

import numpy as np
import scipy.signal
import scipy.stats
import torch

from portbench.reference.common import (F64, exact, frames, mel_spectrogram, on_host, power_to_db,
                                        rel_err, row_blocks)

#: The numbers compared, each with its limit (PERF.md, "correct", gives the readings).
#: ``env_err`` is ``||program - reference|| / ||reference||`` of the onset envelope. The
#: others are shares that disagree: of tracks (tempo), of beats (a beat of either side with
#: none of the other within a frame), of frames (voicing), of frames voiced on both sides
#: (f0: another pitch bin), of frames (voiced probability off by more than VPROB_SAME). pYIN's
#: troughs and thresholds are comparisons, so float32 against float64 flips a few frames of a
#: batch by whole steps; a share counts such frames where a norm would be swayed by them.
LIMITS = {"env_err": 5e-5, "tempo_miss": 0.0, "beat_miss": 0.0, "voicing_miss": 3e-3,
          "f0_miss": 1e-2, "vprob_miss": 1e-2}
F0_SAME = 1e-6        # relative: a pitch bin's step is 2**(1/120) - 1 = 0.58 %
VPROB_SAME = 1e-5     # absolute: float32 sums of a few hundred masses stay within 1e-6

TINY64 = float(np.finfo(np.float64).tiny)


# ----------------------------------------------------------------------------- onset strength

def onset_strength(y: torch.Tensor, cfg: dict, q=exact) -> torch.Tensor:
    """``(rows, T)`` onset envelope of float64 ``y`` ``(rows, n)``."""
    S = power_to_db(mel_spectrogram(y, sr=cfg["sr"], n_fft=cfg["n_fft"], hop=cfg["hop_length"],
                                    n_mels=cfg["n_mels"], fmax=cfg["sr"] / 2, q=q), q=q)
    flux = (S[..., 1:] - S[..., :-1]).clamp_min(0.0)
    ordered = flux.sort(dim=-2).values
    m = flux.shape[-2]
    med = ordered[..., m // 2, :] if m % 2 else 0.5 * (ordered[..., m // 2 - 1, :]
                                                       + ordered[..., m // 2, :])
    lead = 1 + cfg["n_fft"] // (2 * cfg["hop_length"])
    env = torch.nn.functional.pad(med, (lead, 0))[..., :S.shape[-1]]
    return q(env)


# ----------------------------------------------------------------------------- tempo

def _ramp_pad(env: torch.Tensor, w: int) -> torch.Tensor:
    """``np.pad(env, w, mode='linear_ramp', end_values=0)`` along the last axis."""
    k = torch.arange(w, dtype=env.dtype, device=env.device)
    left = env[..., :1] * (k / w)
    right = env[..., -1:] * ((w - 1 - k) / w)
    return torch.cat([left, env, right], dim=-1)


def tempo(env: torch.Tensor, cfg: dict, q=exact) -> np.ndarray:
    """Tempo in BPM per row of ``env`` ``(rows, T)``."""
    sr, hop = cfg["sr"], cfg["hop_length"]
    win = int(np.floor(cfg["ac_size"] * sr / hop))
    n = env.shape[-1]
    k = torch.arange(win, dtype=F64, device=env.device)
    window = 0.5 - 0.5 * torch.cos(2 * np.pi * k / win)
    tg_mean = []
    for rows in row_blocks(env.shape[0], n * win):
        fr = _ramp_pad(env[rows], win // 2).unfold(-1, win, 1)[..., :n, :] * window
        n_pad = 1 << (2 * win - 1).bit_length()
        spec = torch.fft.rfft(fr, n=n_pad, dim=-1)
        ac = torch.fft.irfft(spec.real.square() + spec.imag.square(), n=n_pad, dim=-1)[..., :win]
        peak = ac.abs().amax(dim=-1, keepdim=True)
        ac = torch.where(peak < TINY64, ac, ac / torch.where(peak < TINY64, 1.0, peak))
        tg_mean.append(q(ac).mean(dim=-2))
    tg = torch.cat(tg_mean).cpu().numpy()
    lags = np.arange(win, dtype=np.float64)
    with np.errstate(divide="ignore"):
        bpms = 60.0 * sr / (hop * lags)
        logprior = -0.5 * ((np.log2(bpms) - np.log2(cfg["start_bpm"])) / cfg["std_bpm"]) ** 2
    logprior[:int(np.argmax(bpms < cfg["max_tempo"]))] = -np.inf
    return bpms[np.argmax(np.log1p(1e6 * tg) + logprior, axis=-1)]


# ----------------------------------------------------------------------------- beats

def _local_score(env: np.ndarray, fpb: np.ndarray) -> np.ndarray:
    oe = env / (env.std(ddof=1, axis=-1, keepdims=True) + TINY64)
    f = float(fpb[0])
    window = np.exp(-0.5 * (np.arange(-f, f + 1) * 32.0 / f) ** 2)
    return np.stack([np.convolve(row, window, mode="same") for row in oe])


def _beat_dp(ls: np.ndarray, fpb: np.ndarray, tightness: float):
    """``(backlink, cumscore)`` of each row, a loop over frames vectorised over rows."""
    R, T = ls.shape
    d_top = int(min(1024, 2 * fpb.max()))
    d = np.arange(1, d_top + 1, dtype=np.float64)
    penalty = tightness * (np.log(d)[None, :] - np.log(fpb)[:, None]) ** 2
    span = (d[None, :] >= np.round(0.5 * fpb)[:, None]) & (d[None, :] <= 2.0 * fpb[:, None])
    thresh = 0.01 * ls.max(axis=-1)
    cum = np.zeros((R, T))
    back = np.full((R, T), -1, dtype=np.int64)
    first = np.ones(R, dtype=bool)
    rows = np.arange(R)
    for i in range(T):
        valid = span & (d[None, :] <= i)
        prev = cum[:, np.clip(i - d.astype(np.int64), 0, None)]
        scores = np.where(valid, prev - penalty, -np.inf)
        k = np.argmax(scores, axis=-1)           # the smallest d of equal scores
        best = scores[rows, k]
        has = np.isfinite(best)
        cum[:, i] = np.where(has, ls[:, i] + best, ls[:, i])
        suppress = first & (ls[:, i] < thresh)
        back[:, i] = np.where(has & ~suppress, i - 1 - k, -1)
        first = suppress
    return back, cum


def _last_beat(c: np.ndarray) -> int:
    lmax = np.zeros(c.shape, dtype=bool)
    lmax[1:-1] = (c[1:-1] > c[:-2]) & (c[1:-1] >= c[2:])
    if len(c) > 1:
        lmax[-1] = c[-1] > c[-2]
    peaks = c[lmax]
    threshold = 0.5 * np.median(peaks) if len(peaks) else 0.0
    hits = np.flatnonzero(lmax & (c >= threshold))
    return int(hits[-1]) if len(hits) else len(c) - 1


def beats(env: np.ndarray, bpm: np.ndarray, cfg: dict, q=exact) -> np.ndarray:
    """The beat mask ``(rows, T)`` of float64 envelopes ``env`` at tempi ``bpm``."""
    fpb = np.round(cfg["sr"] / cfg["hop_length"] * 60.0 / bpm)
    ls = q(torch.as_tensor(_local_score(env, fpb))).numpy()
    back, cum = _beat_dp(ls, fpb, cfg["tightness"])
    cum = q(torch.as_tensor(cum)).numpy()
    mask = np.zeros(ls.shape, dtype=bool)
    w = np.hanning(5)
    for r in range(ls.shape[0]):
        n = _last_beat(cum[r])
        while n >= 0:
            mask[r, n] = True
            n = int(back[r, n])
        smooth = np.convolve(ls[r][mask[r]], w)[len(w) // 2:ls.shape[1] + len(w) // 2]
        threshold = 0.5 * ((smooth ** 2).mean() ** 0.5) if len(smooth) else 0.0
        n = 0
        while n < ls.shape[1] and ls[r, n] <= threshold:
            mask[r, n] = False
            n += 1
        n = ls.shape[1] - 1
        while n >= 0 and ls[r, n] <= threshold:
            mask[r, n] = False
            n -= 1
    return mask


# ----------------------------------------------------------------------------- pYIN

def pyin_tables(cfg: dict) -> dict:
    """pYIN's constants, float64: thresholds, beta masses, log transition, log initial."""
    sr, hop, res = cfg["sr"], cfg["hop_length"], cfg["resolution"]
    thresholds = np.linspace(0, 1, cfg["n_thresholds"] + 1)
    beta_probs = np.diff(scipy.stats.beta.cdf(thresholds, *cfg["beta_parameters"]))
    per_semitone = int(np.ceil(1.0 / res))
    n_bins = int(np.floor(12 * per_semitone * np.log2(cfg["fmax"] / cfg["fmin"]))) + 1
    width = round(cfg["max_transition_rate"] * 12 * hop / sr) * per_semitone + 1
    j = np.arange(width)
    taps = scipy.signal.get_window("triang", width, fftbins=False)
    local = np.zeros((n_bins, n_bins))
    for s in range(n_bins):
        cols = s - width // 2 + j
        keep = (cols >= 0) & (cols < n_bins)
        local[s, cols[keep]] = taps[keep]
    local /= local.sum(axis=1, keepdims=True)
    stay = 1.0 - cfg["switch_prob"]    # librosa's transition_loop(2, 1 - switch_prob)
    trans = np.kron(np.array([[stay, 1.0 - stay], [1.0 - stay, stay]]), local)
    log_trans = np.log(trans + TINY64)
    log_trans = np.where(log_trans >= np.log(cfg["transition_min_prob"] + TINY64), log_trans,
                         -np.inf)
    log_p_init = np.log(np.full(2 * n_bins, 1.0 / (2 * n_bins)) + TINY64)
    return {"thresholds": thresholds, "beta_probs": beta_probs, "log_trans": log_trans,
            "log_p_init": log_p_init, "n_bins": n_bins, "per_semitone": per_semitone}


def _observe(y: torch.Tensor, cfg: dict, tab: dict, q=exact):
    """Observation probabilities ``(rows, T, 2 n_bins)`` and voiced probability ``(rows, T)``."""
    sr, fmin, fmax, L = cfg["sr"], cfg["fmin"], cfg["fmax"], cfg["frame_length"]
    fr = q(frames(y, L, cfg["hop_length"]))                       # (rows, T, L)
    min_p = int(np.floor(sr / fmax))
    max_p = min(int(np.ceil(sr / fmin)), L - 1)
    n_pad = 1 << (2 * L - 1).bit_length()
    spec = torch.fft.rfft(fr, n=n_pad, dim=-1)
    power = spec.real.square() + spec.imag.square()
    ac = q(torch.fft.irfft(power, n=n_pad, dim=-1)[..., :max_p + 1])
    edge = fr.square().cumsum(dim=-1)
    edge[..., 0] = 0.0
    diff = 2.0 * (ac[..., :1] - ac[..., 1:max_p + 1]) - edge[..., :max_p]
    lags = torch.arange(1, max_p + 1, dtype=F64, device=y.device)
    mean = diff.cumsum(dim=-1) / lags
    yin = q(diff[..., min_p - 1:max_p] / (mean[..., min_p - 1:max_p] + TINY64))  # (rows, T, P)
    a = yin[..., 2:] + yin[..., :-2] - 2 * yin[..., 1:-1]
    b = 0.5 * (yin[..., 2:] - yin[..., :-2])
    inner = torch.where(b.abs() >= a.abs(), 0.0, -b / torch.where(a == 0, 1.0, a))
    zero = torch.zeros_like(yin[..., :1])
    shifts = torch.cat([zero, inner, zero], dim=-1)
    trough = torch.zeros_like(yin, dtype=torch.bool)
    trough[..., 1:-1] = (yin[..., 1:-1] < yin[..., :-2]) & (yin[..., 1:-1] <= yin[..., 2:])
    trough[..., -1] = yin[..., -1] < yin[..., -2]
    trough[..., 0] = yin[..., 0] < yin[..., 1]
    # the prior mass of each trough: per threshold a Boltzmann law over the troughs below it
    boltz = cfg["boltzmann_parameter"]
    probs = torch.zeros_like(yin)
    empty = torch.zeros_like(yin[..., :1])
    for k, beta in enumerate(tab["beta_probs"]):
        below = trough & (yin < float(tab["thresholds"][k + 1]))
        rank = below.to(F64).cumsum(dim=-1) - 1
        count = below.to(F64).sum(dim=-1, keepdim=True)
        pmf = (torch.exp(-boltz * rank) * (1 - np.exp(-boltz))
               / (1 - torch.exp(-boltz * count.clamp_min(1))))
        probs += torch.where(below, pmf, 0.0) * float(beta)
        empty += torch.where(count == 0, float(beta), 0.0)
    lowest = torch.where(trough, yin, float("inf")).argmin(dim=-1, keepdim=True)
    empty = torch.where(trough.any(dim=-1, keepdim=True), empty, 0.0)
    probs = q(probs.scatter_add(-1, lowest, cfg["no_trough_prob"] * empty))
    periods = torch.arange(min_p, min_p + yin.shape[-1], dtype=F64, device=y.device)
    f0 = sr / (periods + shifts)
    n_bins = tab["n_bins"]
    bins = torch.round(12 * tab["per_semitone"] * torch.log2(f0 / fmin)).clamp(0, n_bins)
    observed = torch.zeros((*probs.shape[:-1], n_bins + 1), dtype=F64, device=y.device)
    observed = observed.scatter_add(-1, bins.long(), probs)[..., :n_bins]
    voiced = observed.sum(dim=-1, keepdim=True).clamp(0, 1)
    obs = torch.cat([observed, ((1 - voiced) / n_bins).expand_as(observed)], dim=-1)
    return q(obs), q(voiced[..., 0])


def viterbi(log_prob: torch.Tensor, log_trans: torch.Tensor, log_p_init: torch.Tensor):
    """The most likely states ``(rows, T)`` under ``log_prob`` ``(rows, T, S)``: the first
    predecessor of equal scores, the first final state of equal scores."""
    R, T, S = log_prob.shape
    v = log_prob[:, 0] + log_p_init
    ptr = torch.zeros((R, T, S), dtype=torch.int16, device=log_prob.device)
    for t in range(1, T):
        best, p = (v[:, :, None] + log_trans).max(dim=1)
        ptr[:, t] = p.to(torch.int16)
        v = log_prob[:, t] + best
    states = torch.empty((R, T), dtype=torch.long, device=log_prob.device)
    states[:, T - 1] = v.argmax(dim=-1)
    for t in range(T - 1, 0, -1):
        states[:, t - 1] = ptr[:, t].gather(1, states[:, t:t + 1])[:, 0].long()
    return states


def pyin(y: torch.Tensor, cfg: dict, q=exact):
    """``(f0, voiced_flag, voiced_prob)``, each ``(rows, T)``, of float64 ``y``; an unvoiced
    frame's f0 is NaN."""
    tab = pyin_tables(cfg)
    obs, vprob = _observe(y, cfg, tab, q)
    lt = torch.as_tensor(tab["log_trans"], device=y.device)
    lpi = torch.as_tensor(tab["log_p_init"], device=y.device)
    states = viterbi(q(torch.log(obs + TINY64)), lt, lpi)
    n_bins = tab["n_bins"]
    freqs = cfg["fmin"] * 2.0 ** (torch.arange(n_bins, dtype=F64, device=y.device)
                                  / (12 * tab["per_semitone"]))
    voiced = states < n_bins
    f0 = torch.where(voiced, freqs[states % n_bins], float("nan"))
    return f0, voiced, vprob


# ----------------------------------------------------------------------------- the whole forward

def compute(y: torch.Tensor, cfg: dict, q=exact) -> dict:
    """Every output of the forward for ``y`` ``(rows, n)``, float64 on the host."""
    env, f0, voiced, vprob = [], [], [], []
    budget = cfg.get("reference_block_samples", 1 << 24)
    for rows in row_blocks(y.shape[0], y.shape[-1], budget):
        x = q(y[rows].to(F64))
        env.append(onset_strength(x, cfg, q).cpu())
        for k, part in enumerate(pyin(x, cfg, q)):
            (f0, voiced, vprob)[k].append(part.cpu())
    env = torch.cat(env)
    bpm = tempo(env.to(y.device), cfg, q)
    return {"env": env, "tempo": bpm, "beats": beats(env.numpy(), bpm, cfg, q),
            "f0": torch.cat(f0), "voiced_flag": torch.cat(voiced),
            "voiced_prob": torch.cat(vprob)}


def _dilate(mask: np.ndarray) -> np.ndarray:
    out = mask.copy()
    out[..., 1:] |= mask[..., :-1]
    out[..., :-1] |= mask[..., 1:]
    return out


def _f0_miss(got, want, both) -> float:
    """The share of frames voiced on both sides whose f0 lies in another pitch bin."""
    f0_w = on_host(want).double()
    off = ~((on_host(got).double() - f0_w).abs() <= F0_SAME * f0_w)
    return float(off[both].double().mean()) if bool(both.any()) else 0.0


def compare(got: dict, want: dict) -> dict:
    """The numbers compared, by name; ``got`` holds the program's outputs under the same keys."""
    out = {}
    if "env" in got:
        out["env_err"] = rel_err(got["env"], want["env"])
    if "tempo" in got:
        g = on_host(got["tempo"]).double().numpy().ravel()
        w = on_host(want["tempo"]).double().numpy().ravel()
        out["tempo_miss"] = float(np.mean(~(np.abs(g - w) <= 1e-6 * w))) if len(g) == len(w) \
            else 1.0
    if "beats" in got:
        g, w = on_host(got["beats"]).bool().numpy(), on_host(want["beats"]).bool().numpy()
        if g.shape != w.shape:
            out["beat_miss"] = 1.0
        else:
            missed = np.sum(w & ~_dilate(g)) + np.sum(g & ~_dilate(w))
            out["beat_miss"] = float(missed / max(1, w.sum()))
    if "voiced_flag" in got:
        g, w = on_host(got["voiced_flag"]).bool(), on_host(want["voiced_flag"]).bool()
        same = g.shape == w.shape
        out["voicing_miss"] = float((g != w).double().mean()) if same else 1.0
        if "f0" in got:
            out["f0_miss"] = _f0_miss(got["f0"], want["f0"], g & w) if same else 1.0
    if "voiced_prob" in got:
        g, w = on_host(got["voiced_prob"]).double(), on_host(want["voiced_prob"]).double()
        out["vprob_miss"] = (float((~((g - w).abs() <= VPROB_SAME)).double().mean())
                             if g.shape == w.shape else 1.0)
    return out
