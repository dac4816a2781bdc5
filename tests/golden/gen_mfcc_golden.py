#!/usr/bin/env python3
"""Generate externally-grounded golden MFCC/FBANK fixtures.

This script is deliberately INDEPENDENT of htk_jax: it imports nothing
from the package and shares no table-building code with it.  Every
formula below is transcribed from the published HTKBook (v3.4, chapter
5 "Speech Input/Output") and the HTK Definitions it documents:

  - pre-emphasis        s'[n] = s[n] - k*s[n-1]   (applied inside the
    frame, descending, with s'[0] = s[0]*(1-k))           [HTKBook 5.5]
  - Hamming window      w[n] = 0.54 - 0.46 cos(2*pi*n/(N-1))   [eq 5.2]
  - mel scale           Mel(f) = 2595 log10(1 + f/700)         [eq 5.4]
  - triangular filterbank: NUMCHANS channels with centres equally
    spaced on the mel scale between 0 and Mel(fs/2); DC and Nyquist
    FFT bins are not used                               [HTKBook 5.6]
  - MFCC                c_i = sqrt(2/N) sum_j m_j cos(pi*i/N (j-0.5))
                                                               [eq 5.8]
  - liftering           c'_i = (1 + L/2 sin(pi*i/L)) c_i       [eq 5.9]
  - energy              E = log sum s^2 (raw, pre-window)  [HTKBook 5.8]
  - ENORMALISE          e' = 1 - (Emax - e)*ESCALE, floored at
                        Emax - (SILFLOOR*ln10)/10         [HTKBook 5.8]
  - CMN (_Z)            subtract the per-file cepstral mean (energy
                        excluded)                         [HTKBook 5.9]
  - deltas              d_t = sum_th th (c_{t+th} - c_{t-th})
                              / (2 sum_th th^2), edge frames
                        replicated                            [eq 5.10]

The test waveform is realistic synthesized speech: a glottal pulse
train with a declining pitch contour driven through a cascade of
time-varying second-order formant resonators (Klatt-style difference
equation y[n] = A x[n] + B y[n-1] + C y[n-2]), with linear formant
transitions between phones and additive breath noise.  Formant targets
are the classic Peterson & Barney vowel measurements.

Run from the repo root:  python tests/golden/gen_mfcc_golden.py
Writes tests/golden/mfcc_golden.npz (waveform + features per kind).
tests/test_golden_frontend.py asserts htk_jax's device frontend against
this file; the fixture is committed so the grounding is frozen.
"""

import math
import os

import numpy as np

FS = 16000.0

# Peterson & Barney (1952) average adult-male formant frequencies (Hz)
# and typical bandwidths (Hz).
VOWELS = {
    "aa": ([730.0, 1090.0, 2440.0], [80.0, 90.0, 120.0]),
    "iy": ([270.0, 2290.0, 3010.0], [60.0, 100.0, 150.0]),
    "uw": ([300.0, 870.0, 2240.0], [60.0, 80.0, 120.0]),
    "eh": ([530.0, 1840.0, 2480.0], [70.0, 90.0, 130.0]),
}


def synth_speech(phones, dur_s=0.18, trans_s=0.03, f0_start=125.0,
                 f0_end=90.0, seed=12345):
    """Source-filter synthesis with formant transitions.

    phones: list of vowel names or 'sil'.  dur_s: seconds per phone —
    a scalar or a per-phone sequence (variable durations make forced
    alignment non-trivial).  Returns float64 samples in int16 range.
    """
    rng = np.random.default_rng(seed)
    n_ph = len(phones)
    durs = np.full(n_ph, dur_s, float) if np.isscalar(dur_s) \
        else np.asarray(dur_s, float)
    bounds = np.concatenate([[0.0], np.cumsum(durs)])  # seconds
    n = int(bounds[-1] * FS)
    t_all = np.arange(n) / FS

    # piecewise-linear formant tracks with knots at phone centres;
    # silence keeps the neighbouring vowel's target (no discontinuity).
    def track(fidx, kind):
        knots_t = [(bounds[i] + bounds[i + 1]) / 2.0 for i in range(n_ph)]
        knots_v = [None if p == "sil" else VOWELS[p][kind][fidx]
                   for p in phones]
        vals = [v for v in knots_v if v is not None]
        prev = vals[0] if vals else 500.0
        filled = []
        for v in knots_v:
            if v is not None:
                prev = v
            filled.append(prev)
        nxt = filled[-1]
        for i in range(n_ph - 1, -1, -1):
            if knots_v[i] is not None:
                nxt = knots_v[i]
            filled[i] = filled[i] if knots_v[i] is not None else nxt
        return np.interp(t_all, knots_t, filled)

    f_tracks = [track(i, 0) for i in range(3)]
    b_tracks = [track(i, 1) for i in range(3)]

    # voicing amplitude envelope: raised-cosine on/offsets per phone
    voiced = np.zeros(n)
    for i, p in enumerate(phones):
        if p == "sil":
            continue
        s, e = int(bounds[i] * FS), int(bounds[i + 1] * FS)
        ramp = min(int(trans_s * FS), max(1, (e - s) // 2))
        seg = np.ones(e - s)
        r = 0.5 - 0.5 * np.cos(np.pi * np.arange(ramp) / ramp)
        seg[:ramp] = np.minimum(seg[:ramp], r)
        seg[-ramp:] = np.minimum(seg[-ramp:], r[::-1])
        voiced[s:e] = np.maximum(voiced[s:e], seg)

    # glottal source: impulse train at declining f0 with jitter, plus
    # -12 dB/oct spectral tilt (two-sample smoothing), plus breath noise
    f0 = f0_start + (f0_end - f0_start) * t_all / t_all[-1]
    f0 = f0 * (1.0 + 0.01 * rng.standard_normal(n).cumsum() / np.sqrt(n))
    phase = np.cumsum(f0 / FS)
    pulses = np.zeros(n)
    pulses[1:] = (np.floor(phase[1:]) - np.floor(phase[:-1])) > 0
    src = pulses * voiced
    for _ in range(2):  # tilt
        src[1:] = 0.5 * (src[1:] + src[:-1])
    src = src + 0.002 * rng.standard_normal(n) * (0.3 + voiced)

    # cascade formant resonators, coefficients per sample
    y = src
    for fi in range(3):
        F, Bw = f_tracks[fi], b_tracks[fi]
        C = -np.exp(-2.0 * np.pi * Bw / FS)
        B = 2.0 * np.exp(-np.pi * Bw / FS) * np.cos(2.0 * np.pi * F / FS)
        A = 1.0 - B - C
        out = np.zeros(n)
        y1 = y2 = 0.0
        for k in range(n):
            v = A[k] * y[k] + B[k] * y1 + C[k] * y2
            out[k] = v
            y2, y1 = y1, v
        y = out

    y = y / (np.max(np.abs(y)) + 1e-12) * 9000.0
    return np.round(y).astype(np.int16).astype(np.float64)


# --------------------------------------------------------------------------
# HTKBook-formula MFCC, per-frame scalar float64 (independent of htk_jax)
# --------------------------------------------------------------------------


def mel(f_hz):
    # HTKBook eq 5.4 prints Mel(f) = 2595 log10(1 + f/700); the HTK
    # definition it documents is the natural-log form 1127 ln(1 + f/700)
    # (2595/ln 10 = 1127.01...).  The 5th-digit difference moves triangle
    # weights by ~2e-4, so the golden fixture uses the defining constant.
    return 1127.0 * math.log(1.0 + f_hz / 700.0)


def mel_filterbank(fft_n, num_chans, fs):
    """(num_bins, num_chans) triangular filters per HTKBook 5.6.

    Centres equally spaced on the mel scale between 0 and Mel(fs/2);
    FFT bin j (0-based) has frequency j*fs/fft_n; DC and the bins at or
    above Nyquist are unused.
    """
    nby2 = fft_n // 2
    mhi = mel((nby2 - 0) * fs / fft_n)  # Mel at the Nyquist bin
    centres = np.array(
        [c * mhi / (num_chans + 1) for c in range(0, num_chans + 2)])
    W = np.zeros((nby2 + 1, num_chans))
    for j in range(1, nby2):  # exclude DC (0) and Nyquist (nby2)
        mj = mel(j * fs / fft_n)
        for c in range(1, num_chans + 1):
            lo, mid, hi = centres[c - 1], centres[c], centres[c + 1]
            if lo <= mj <= mid:
                W[j, c - 1] += (mj - lo) / (mid - lo)
            elif mid < mj <= hi:
                W[j, c - 1] += (hi - mj) / (hi - mid)
    return W


def htkbook_features(samples, kind, num_chans=20, num_ceps=12, lifter=22,
                     frame_size=400, frame_shift=160, preem=0.97,
                     escale=0.1, sil_floor=50.0, delta_win=2, acc_win=2):
    """MFCC/FBANK per the HTKBook formulas; kind e.g. 'MFCC_E_D_A_Z'."""
    quals = set(kind.split("_")[1:])
    base = kind.split("_")[0]
    fft_n = 2
    while fft_n < frame_size:
        fft_n *= 2
    W = mel_filterbank(fft_n, num_chans, FS)
    ham = 0.54 - 0.46 * np.cos(
        2.0 * math.pi * np.arange(frame_size) / (frame_size - 1))
    n = (len(samples) - frame_size) // frame_shift + 1

    statics, energies = [], []
    for t in range(n):
        s = samples[t * frame_shift: t * frame_shift + frame_size].copy()
        e_raw = float(np.sum(s * s))
        for j in range(frame_size - 1, 0, -1):
            s[j] -= preem * s[j - 1]
        s[0] *= 1.0 - preem
        s *= ham
        spec = np.abs(np.fft.rfft(s, n=fft_n))
        fbank = spec @ W
        logfb = np.log(np.maximum(fbank, 1.0))
        if base == "FBANK":
            vec = logfb
        else:  # MFCC, eq 5.8 + 5.9
            vec = np.zeros(num_ceps)
            for i in range(1, num_ceps + 1):
                acc = 0.0
                for j in range(1, num_chans + 1):
                    acc += logfb[j - 1] * math.cos(
                        math.pi * i / num_chans * (j - 0.5))
                vec[i - 1] = math.sqrt(2.0 / num_chans) * acc
            if lifter > 0:
                for i in range(1, num_ceps + 1):
                    vec[i - 1] *= 1.0 + (lifter / 2.0) * math.sin(
                        math.pi * i / lifter)
        cols = [vec]
        if "0" in quals:
            cols.append([math.sqrt(2.0 / num_chans) * float(np.sum(logfb))])
        if "E" in quals:
            cols.append([math.log(max(e_raw, 1e-20))])
        statics.append(np.concatenate([np.atleast_1d(c) for c in cols]))
        energies.append(math.log(max(e_raw, 1e-20)))
    x = np.array(statics)

    if "Z" in quals:
        ncep = x.shape[1] - (1 if "E" in quals else 0)
        x[:, :ncep] -= x[:, :ncep].mean(axis=0)
    if "E" in quals:  # ENORMALISE default true
        e = x[:, -1]
        emax = e.max()
        emin = emax - (sil_floor * math.log(10.0)) / 10.0
        x[:, -1] = 1.0 - (emax - np.maximum(e, emin)) * escale

    def regress(block, win):
        sigma2 = 2.0 * sum(th * th for th in range(1, win + 1))
        out = np.zeros_like(block)
        for t in range(len(block)):
            for th in range(1, win + 1):
                hi = min(len(block) - 1, t + th)
                lo = max(0, t - th)
                out[t] += th * (block[hi] - block[lo])
        return out / sigma2

    blocks = [x]
    if "D" in quals:
        d = regress(blocks[-1], delta_win)
        blocks.append(d)
        if "A" in quals:
            blocks.append(regress(d, acc_win))
    return np.concatenate(blocks, axis=1)


def htkbook_plp(samples, num_chans=20, num_ceps=12, lifter=22,
                lpc_order=12, frame_size=400, frame_shift=160,
                preem=0.97, compress=0.33):
    """PLP cepstra per the published recipe (Hermansky 1990 as adopted
    by the HTKBook's PLP section): mel filterbank -> equal-loudness
    weighting E(f) = (f^2/(f^2+1.6e5))^2 (f^2+1.44e6)/(f^2+9.61e6) ->
    cube-root compression -> IDFT to autocorrelation -> Levinson-Durbin
    -> LPC-to-cepstra c_n = -(a_n + (1/n) sum (n-i) a_i c_{n-i}) ->
    liftering.  Scalar float64, independent of the package."""
    fft_n = 2
    while fft_n < frame_size:
        fft_n *= 2
    W = mel_filterbank(fft_n, num_chans, FS)
    ham = 0.54 - 0.46 * np.cos(
        2.0 * math.pi * np.arange(frame_size) / (frame_size - 1))
    # equal loudness at the channel centre frequencies
    nby2 = fft_n // 2
    mhi = mel(nby2 * FS / fft_n)
    eql = np.zeros(num_chans)
    for c in range(1, num_chans + 1):
        cf_mel = c * mhi / (num_chans + 1)
        f = 700.0 * (math.exp(cf_mel / 1127.0) - 1.0)
        fsq = f * f
        fsub = fsq / (fsq + 1.6e5)
        eql[c - 1] = fsub * fsub * ((fsq + 1.44e6) / (fsq + 9.61e6))

    n = (len(samples) - frame_size) // frame_shift + 1
    out = []
    for t in range(n):
        s = samples[t * frame_shift: t * frame_shift + frame_size].copy()
        for j in range(frame_size - 1, 0, -1):
            s[j] -= preem * s[j - 1]
        s[0] *= 1.0 - preem
        s *= ham
        spec = np.abs(np.fft.rfft(s, n=fft_n)) ** 2  # power spectrum
        aspec = np.maximum((spec @ W) * eql, 1e-10) ** compress
        # symmetric IDFT over duplicated-edge auditory spectrum
        pts = num_chans + 2
        padded = np.concatenate([[aspec[0]], aspec, [aspec[-1]]])
        autoc = np.zeros(lpc_order + 1)
        for i in range(lpc_order + 1):
            acc = 0.0
            for j in range(pts):
                w = 1.0 if j in (0, pts - 1) else 2.0
                acc += w * padded[j] * math.cos(
                    math.pi * i * j / (num_chans + 1))
            autoc[i] = acc / (2.0 * (num_chans + 1))
        # Levinson-Durbin
        E = autoc[0]
        a = np.zeros(lpc_order + 1)
        for i in range(1, lpc_order + 1):
            acc = autoc[i]
            for j in range(1, i):
                acc -= a[j] * autoc[i - j]
            k = acc / max(E, 1e-20)
            new_a = a.copy()
            new_a[i] = k
            for j in range(1, i):
                new_a[j] = a[j] - k * a[i - j]
            a = new_a
            E *= 1.0 - k * k
        # LPC -> cepstra
        c = np.zeros(num_ceps + 1)
        for m in range(1, num_ceps + 1):
            acc = a[m] if m <= lpc_order else 0.0
            for i in range(1, min(m, lpc_order + 1)):
                acc += ((m - i) / m) * a[i] * c[m - i]
            c[m] = -acc
        vec = c[1:]
        for i in range(1, num_ceps + 1):
            vec[i - 1] *= 1.0 + (lifter / 2.0) * math.sin(
                math.pi * i / lifter)
        out.append(vec)
    return np.array(out)


KINDS = ["MFCC_E_D_A_Z", "MFCC_0", "FBANK"]


def main():
    phones = ["sil", "aa", "iy", "uw", "eh", "aa", "sil"]
    wave = synth_speech(phones)
    out = {"waveform": wave.astype(np.int16)}
    for kind in KINDS:
        nch = 24 if kind == "FBANK" else 20
        out["feat_" + kind] = htkbook_features(wave, kind, num_chans=nch)
    out["feat_PLP"] = htkbook_plp(wave)
    path = os.path.join(os.path.dirname(__file__), "mfcc_golden.npz")
    np.savez_compressed(path, **out)
    for kind in KINDS:
        f = out["feat_" + kind]
        print(kind, f.shape, "mean", float(f.mean()), "std", float(f.std()))
    print("wrote", path)


if __name__ == "__main__":
    main()
