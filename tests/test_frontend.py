"""Frontend parity tests.

The JAX pipeline (whole-utterance, matmul-shaped) is checked against a
literal scalar transcription of HTK's per-frame algorithm (HParm.c
ConvertFrame + HSigP.c Wave2FBank/FBank2MFCC/WeightCepstrum) written here
in float64 numpy. Tolerances are well inside the 1e-4 end-to-end budget.
"""

import math

import numpy as np
import pytest

from htk_jax.io import parmkind as pk
from htk_jax.ops import dsp
from htk_jax.ops.dsp import FrontendConfig, compute_features
from htk_jax.utils.config import Config


def scalar_reference(samples, cfg: FrontendConfig):
    """Per-frame float64 transcription of the HTK algorithm."""
    fs = cfg.frame_size
    shift = cfg.frame_shift
    n = (len(samples) - fs) // shift + 1
    fft_n = cfg.fft_n
    W = dsp.mel_weight_matrix(cfg).astype(np.float64)
    D = dsp.dct_matrix(cfg.num_chans, cfg.num_ceps).astype(np.float64)
    L = dsp.lifter_vector(cfg.num_ceps, cfg.cep_lifter).astype(np.float64)
    ham = 0.54 - 0.46 * np.cos(2 * math.pi * np.arange(fs) / (fs - 1))

    statics = []
    for t in range(n):
        s = samples[t * shift : t * shift + fs].astype(np.float64).copy()
        if cfg.zmean_source:
            s -= s.mean()
        raw_e = float(np.sum(s * s))
        # preemphasis, descending in-place as HTK does it
        for j in range(fs - 1, 0, -1):
            s[j] -= cfg.preem_coef * s[j - 1]
        s[0] *= 1.0 - cfg.preem_coef
        if cfg.use_hamming:
            s = s * ham
        win_e = float(np.sum(s * s))
        log_e = math.log(max(raw_e if cfg.raw_energy else win_e, 1e-20))

        spec = np.fft.rfft(s, n=fft_n)
        mag = np.abs(spec)
        if cfg.use_power:
            mag = mag * mag
        fbank = mag @ W
        logfb = np.log(np.maximum(fbank, 1.0))
        row = []
        if cfg.base_str == "MFCC":
            ceps = (logfb @ D) * L
            row.extend(ceps.tolist())
        elif cfg.base_str == "FBANK":
            row.extend(logfb.tolist())
        elif cfg.base_str == "MELSPEC":
            row.extend(fbank.tolist())
        if pk.has_qual(cfg.target_kind, pk.HASZEROC):
            row.append(float(np.sum(logfb)) * math.sqrt(2.0 / cfg.num_chans))
        if pk.has_qual(cfg.target_kind, pk.HASENERGY):
            row.append(log_e)
        statics.append(row)
    x = np.array(statics)

    has_e = pk.has_qual(cfg.target_kind, pk.HASENERGY)
    if pk.has_qual(cfg.target_kind, pk.HASZEROM):
        ncep = x.shape[1] - (1 if has_e else 0)
        x[:, :ncep] -= x[:, :ncep].mean(axis=0)
    if has_e and cfg.enormalise:
        e = x[:, -1]
        emax = e.max()
        emin = emax - cfg.sil_floor * math.log(10.0) / 10.0
        e = np.maximum(e, emin)
        x[:, -1] = 1.0 - (emax - e) * cfg.escale

    def regress(y, win):
        sigma2 = 2.0 * sum(th * th for th in range(1, win + 1))
        out = np.zeros_like(y)
        T = len(y)
        for t in range(T):
            for th in range(1, win + 1):
                hi = min(T - 1, t + th)
                lo = max(0, t - th)
                out[t] += th * (y[hi] - y[lo])
        return out / sigma2

    blocks = [x]
    if pk.has_qual(cfg.target_kind, pk.HASDELTA):
        d = regress(blocks[-1], cfg.delta_window)
        blocks.append(d)
        if pk.has_qual(cfg.target_kind, pk.HASACCS):
            a = regress(d, cfg.acc_window)
            blocks.append(a)
            if pk.has_qual(cfg.target_kind, pk.HASTHIRD):
                blocks.append(regress(a, cfg.third_window))
    out = np.concatenate(blocks, axis=1)
    if pk.has_qual(cfg.target_kind, pk.HASNULLE):
        drop = cfg.n_static() - 1
        out = np.delete(out, drop, axis=1)
    return out


def synth_wave(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = (
        3000 * np.sin(2 * math.pi * 440 * t)
        + 1000 * np.sin(2 * math.pi * 1320 * t + 0.3)
        + 200 * rng.normal(size=n)
    )
    return x.astype(np.int16).astype(np.float32)


KINDS = [
    "MFCC_E_D_A",
    "MFCC_0_D_A_Z",
    "MFCC_E_D_A_Z",
    "FBANK_E_D",
    "MELSPEC",
    "MFCC_E_D_N",
    "MFCC_E_D_A_T",
]


class TestFrontendParity:
    @pytest.mark.parametrize("kind", KINDS)
    def test_matches_scalar_reference(self, kind):
        cfg = FrontendConfig(target_kind=pk.str2parmkind(kind))
        w = synth_wave()
        got = compute_features(w, cfg)
        want = scalar_reference(w, cfg)
        assert got.shape == want.shape
        assert got.shape[1] == cfg.width()
        scale = np.maximum(np.abs(want), 1.0)
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-4)

    def test_lofreq_hifreq(self):
        cfg = FrontendConfig(
            target_kind=pk.str2parmkind("MFCC_E"), lo_freq=80.0, hi_freq=7200.0
        )
        w = synth_wave()
        got = compute_features(w, cfg)
        want = scalar_reference(w, cfg)
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-4)

    def test_frame_count(self):
        cfg = FrontendConfig()
        # 25ms window (400 samples), 10ms shift (160) at 16kHz
        assert cfg.frame_size == 400
        assert cfg.frame_shift == 160
        assert cfg.fft_n == 512
        assert dsp.num_frames(4000, cfg) == (4000 - 400) // 160 + 1

    def test_width(self):
        assert FrontendConfig(target_kind=pk.str2parmkind("MFCC_E_D_A")).width() == 39
        assert FrontendConfig(target_kind=pk.str2parmkind("MFCC_0_D_A_Z")).width() == 39
        assert FrontendConfig(target_kind=pk.str2parmkind("MFCC_E_D_N")).width() == 25
        assert FrontendConfig(
            target_kind=pk.str2parmkind("FBANK"), num_chans=24
        ).width() == 24

    def test_from_config(self):
        c = Config()
        c.read_string(
            "TARGETKIND = MFCC_0_D_A\nNUMCEPS = 13\nHPARM: NUMCHANS = 26\n"
            "WINDOWSIZE = 200000\nENORMALISE = F\n"
        )
        fc = FrontendConfig.from_config(c, samp_period=625)
        assert fc.num_ceps == 13
        assert fc.num_chans == 26
        assert fc.frame_size == 320
        assert fc.enormalise is False
        assert fc.width() == 42

    def test_bucketing_consistency(self):
        """Same wave, different pad buckets -> identical features."""
        cfg = FrontendConfig(target_kind=pk.str2parmkind("MFCC_E_D_A_Z"))
        w = synth_wave(5000)
        a = compute_features(w, cfg)
        b = compute_features(np.concatenate([w, np.zeros(3000, np.float32)]), cfg)
        # first frames of the longer file include zero-padding only after
        # frame num_frames(5000); frames fully inside w must agree exactly
        n_common = (5000 - cfg.frame_size) // cfg.frame_shift + 1
        # CMN/ENORMALISE are per-file so only compare a CMN-free kind here
        cfg2 = FrontendConfig(target_kind=pk.str2parmkind("MFCC"))
        a2 = compute_features(w, cfg2)
        b2 = compute_features(np.concatenate([w, np.zeros(3000, np.float32)]), cfg2)
        np.testing.assert_allclose(a2, b2[:n_common], atol=1e-4)


class TestVTLN:
    """WARPFREQ piecewise-linear vocal-tract-length normalisation."""

    def _cfg(self, **kw):
        from htk_jax.ops.dsp import FrontendConfig
        from htk_jax.io.parmkind import str2parmkind

        return FrontendConfig(target_kind=str2parmkind("MFCC_E"),
                              samp_period=625, **kw)

    def test_warp_function_endpoints_and_slope(self):
        from htk_jax.ops.dsp import _warp_freq

        fl, fu, a, lo, hi = 300.0, 3000.0, 1.2, 0.0, 4000.0
        assert _warp_freq(lo, fl, fu, a, lo, hi) == pytest.approx(lo)
        assert _warp_freq(hi, fl, fu, a, lo, hi) == pytest.approx(hi)
        # central band: slope 1/alpha
        assert _warp_freq(1000.0, fl, fu, a, lo, hi) == pytest.approx(
            1000.0 / a)
        # monotone over the whole band
        xs = np.linspace(lo, hi, 200)
        ys = [_warp_freq(float(x), fl, fu, a, lo, hi) for x in xs]
        assert np.all(np.diff(ys) > 0)
        # identity at alpha = 1
        assert _warp_freq(1234.5, fl, fu, 1.0, lo, hi) == 1234.5

    def test_warped_filterbank_moves_channels(self):
        from htk_jax.ops.dsp import mel_weight_matrix

        W0 = mel_weight_matrix(self._cfg())
        W1 = mel_weight_matrix(self._cfg(warp_freq=1.1))
        assert W0.shape == W1.shape
        assert np.abs(W0 - W1).max() > 0.01  # genuinely different
        # every channel still collects some energy (no dead triangles)
        assert (W1.sum(axis=0) > 0).all()
        # a small warp change is a small matrix change (continuity)
        W2 = mel_weight_matrix(self._cfg(warp_freq=1.1001))
        assert np.abs(W2 - W1).max() < 0.05

    def test_hcopy_warp_config(self, tmp_path, monkeypatch):
        """WARPFREQ flows from config through HCopy (speaker-specific
        VTLN configs, the HTK recipe pattern)."""
        from htk_jax.io.htkfeat import read_htk_file
        from htk_jax.io.wavefile import Waveform, write_wave
        from htk_jax.tools import hcopy

        monkeypatch.chdir(tmp_path)
        rng = np.random.default_rng(0)
        s = (rng.normal(size=16000) * 500).astype(np.int16)
        write_wave("a.wav", Waveform(samples=s, samp_period=625), fmt="WAV")
        base = ("SOURCEFORMAT = WAV\nSOURCEKIND = WAVEFORM\n"
                "TARGETKIND = MFCC_E\n")
        open("c0", "w").write(base)
        open("c1", "w").write(base + "WARPFREQ = 1.15\n")
        assert hcopy.run(["-C", "c0", "a.wav", "f0.mfc"]) == 0
        assert hcopy.run(["-C", "c1", "a.wav", "f1.mfc"]) == 0
        f0 = read_htk_file("f0.mfc").data
        f1 = read_htk_file("f1.mfc").data
        assert f0.shape == f1.shape
        assert np.abs(f0 - f1).max() > 1e-3

    def test_adddither_breaks_digital_silence(self):
        """ADDDITHER keeps log-energy finite on all-zero input and is
        reproducible (fixed seed)."""
        from htk_jax.ops.dsp import compute_features

        z = np.zeros(16000, np.int16)
        f1 = compute_features(z, self._cfg(add_dither=1.0))
        f2 = compute_features(z, self._cfg(add_dither=1.0))
        assert np.isfinite(f1).all()
        np.testing.assert_array_equal(f1, f2)
        f0 = compute_features(z, self._cfg())
        assert not np.array_equal(f0, f1)


class TestBatchedFrontend:
    def test_batch_equals_single(self):
        """compute_features_batch == compute_features per job, across
        mixed lengths (different frame buckets) and sample rates
        (different FrontendConfigs in one call)."""
        from htk_jax.ops.dsp import (FrontendConfig, compute_features,
                                     compute_features_batch)

        rng = np.random.default_rng(5)
        kind = pk.str2parmkind("MFCC_E_D_A")
        cfg16 = FrontendConfig(target_kind=kind, samp_period=625)
        cfg8 = FrontendConfig(target_kind=kind, samp_period=1250)
        jobs = []
        for n in (4000, 4003, 17000, 66000):
            jobs.append(((rng.normal(size=n) * 2000).astype(np.float32),
                         cfg16))
        jobs.append(((rng.normal(size=9000) * 2000).astype(np.float32),
                     cfg8))
        outs = compute_features_batch(jobs)
        for (s, c), got in zip(jobs, outs):
            ref = compute_features(s, c)
            # XLA's batched FFT/matmul tiling reassociates: diffs are
            # ~2e-5 abs, an order below the frontend's own tolerance vs
            # the scalar reference (2e-3)
            np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)

    def test_hcopy_scp_batch_matches_individual(self, tmp_path,
                                                monkeypatch):
        """The batched scp path matches one-pair-at-a-time runs to the
        batched-FFT tolerance; with HPARM: BATCHFRONTEND = F the scp run
        is byte-identical to the single-file runs."""
        from htk_jax.io.htkfeat import read_htk_file
        from htk_jax.io.wavefile import Waveform, write_wave
        from htk_jax.tools import hcopy

        monkeypatch.chdir(tmp_path)
        rng = np.random.default_rng(6)
        lines = []
        for i, n in enumerate((8000, 12345, 8000, 30000)):
            x = (rng.normal(size=n) * 3000).astype(np.int16)
            write_wave(f"u{i}.wav", Waveform(samples=x, samp_period=625),
                       fmt="WAV")
            lines.append(f"u{i}.wav b{i}.mfc")
        open("all.scp", "w").write("\n".join(lines) + "\n")
        open("cfg", "w").write(
            "SOURCEFORMAT = WAV\nSOURCEKIND = WAVEFORM\n"
            "TARGETKIND = MFCC_E_D_A\nHPARM: BATCHFRONTEND = T\n")
        open("cfg_nb", "w").write(
            open("cfg").read().replace("BATCHFRONTEND = T",
                                       "BATCHFRONTEND = F"))
        assert hcopy.run(["-C", "cfg", "-S", "all.scp"]) == 0
        for i in range(4):
            assert hcopy.run(["-C", "cfg", f"u{i}.wav", f"s{i}.mfc"]) == 0
            got = read_htk_file(f"b{i}.mfc").data
            ref = read_htk_file(f"s{i}.mfc").data
            np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)
        # byte identity under BATCHFRONTEND = F
        assert hcopy.run(["-C", "cfg_nb", "-S", "all.scp"]) == 0
        for i in range(4):
            assert (open(f"b{i}.mfc", "rb").read()
                    == open(f"s{i}.mfc", "rb").read())

    def test_bucket_boundary_trailing_samples(self):
        """Waveforms whose frame count lands exactly on a padding bucket
        with trailing samples used to overflow the padded buffer
        (ValueError); trailing samples belong to no frame, so the result
        must equal the truncated waveform's."""
        from htk_jax.ops.dsp import (FrontendConfig, compute_features,
                                     compute_features_batch, num_frames)

        kind = pk.str2parmkind("MFCC_E_D_A")
        cfg = FrontendConfig(target_kind=kind, samp_period=625)
        # frame_size 400, shift 160: T=32 needs 5360 samples; 5400 gives
        # T=32 (bucket 32) with 40 trailing samples
        x = (np.random.default_rng(8).normal(size=5400) * 2000).astype(
            np.float32)
        assert num_frames(len(x), cfg) == 32
        got = compute_features(x, cfg)
        ref = compute_features(x[:5360], cfg)
        np.testing.assert_array_equal(got, ref)
        got_b = compute_features_batch([(x, cfg)])[0]
        np.testing.assert_allclose(got_b, ref, rtol=1e-3, atol=1e-4)

    def test_batch_bytes_independent_of_scp_composition(self, tmp_path,
                                                        monkeypatch):
        """The batched frontend writes the SAME bytes for a file no
        matter which other files share its chunk (fixed batch width +
        row-uniform kernels)."""
        from htk_jax.io.wavefile import Waveform, write_wave
        from htk_jax.tools import hcopy

        monkeypatch.chdir(tmp_path)
        rng = np.random.default_rng(9)
        for i, n in enumerate((8000, 8000, 12000, 16000)):
            x = (rng.normal(size=n) * 3000).astype(np.int16)
            write_wave(f"v{i}.wav", Waveform(samples=x, samp_period=625),
                       fmt="WAV")
        open("cfg", "w").write(
            "SOURCEFORMAT = WAV\nSOURCEKIND = WAVEFORM\n"
            "TARGETKIND = MFCC_E_D_A\nHPARM: BATCHFRONTEND = T\n")
        # v0 alone, v0 among many, v0 in a different order
        assert hcopy.run(["-C", "cfg", "v0.wav", "alone.mfc"]) == 0
        open("a.scp", "w").write(
            "v0.wav a0.mfc\nv1.wav a1.mfc\nv2.wav a2.mfc\nv3.wav a3.mfc\n")
        open("b.scp", "w").write(
            "v3.wav b3.mfc\nv2.wav b2.mfc\nv1.wav b1.mfc\nv0.wav b0.mfc\n")
        assert hcopy.run(["-C", "cfg", "-S", "a.scp"]) == 0
        assert hcopy.run(["-C", "cfg", "-S", "b.scp"]) == 0
        alone = open("alone.mfc", "rb").read()
        assert open("a0.mfc", "rb").read() == alone
        assert open("b0.mfc", "rb").read() == alone
