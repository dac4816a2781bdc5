"""Device feature-extraction frontend (HTK HParm/HSigP semantics).

Replaces the per-frame scalar pipeline of `HTKLib/HParm.c : ConvertFrame()`
and `HTKLib/HSigP.c` (PreEmphasise/Ham/Wave2FBank/FBank2MFCC/WeightCepstrum)
with one whole-utterance batched computation:

  frames(T, win) -> preemph -> window -> |rFFT| -> mel (matmul)
  -> log -> DCT (matmul) -> lifter -> [+c0/+E] -> deltas/accs (matmul)
  -> CMN/energy-norm (per-file reductions)

All stages are static-shaped jnp ops so the whole frontend jits into a
handful of XLA fusions around the two matmuls. The mel filterbank
and DCT matrices are precomputed on host exactly per HTK's InitFBank
formulas (bin edges, loChan/loWt rounding, mel floor), which is where
bit-parity with HTK lives (SURVEY.md §7 hard-part #1).

The filterbank/DCT precompute is float64 on host, cast to float32 — HTK
computes these tables in C float; differences are below the 1e-4 budget.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..io import parmkind as pk
from ..utils.config import Config
from ..utils.errors import HError


@dataclass(frozen=True)
class FrontendConfig:
    """Static frontend parameters (the HPARM config surface).

    Field names follow the HTK config keys they mirror.
    """

    target_kind: int = pk.str2parmkind("MFCC_E_D_A")  # TARGETKIND
    samp_period: int = 625  # SOURCERATE, 100ns units (625 = 16 kHz)
    window_size: float = 250000.0  # WINDOWSIZE, 100ns
    target_rate: float = 100000.0  # TARGETRATE (frame shift), 100ns
    preem_coef: float = 0.97  # PREEMCOEF
    use_hamming: bool = True  # USEHAMMING
    zmean_source: bool = False  # ZMEANSOURCE (per-frame DC removal)
    raw_energy: bool = True  # RAWENERGY
    num_chans: int = 20  # NUMCHANS
    num_ceps: int = 12  # NUMCEPS
    cep_lifter: int = 22  # CEPLIFTER
    enormalise: bool = True  # ENORMALISE
    escale: float = 0.1  # ESCALE
    sil_floor: float = 50.0  # SILFLOOR (dB)
    delta_window: int = 2  # DELTAWINDOW
    acc_window: int = 2  # ACCWINDOW
    third_window: int = 2  # THIRDWINDOW
    lo_freq: float = -1.0  # LOFREQ
    hi_freq: float = -1.0  # HIFREQ
    use_power: bool = False  # USEPOWER
    add_dither: float = 0.0  # ADDDITHER (uniform +-d, fixed seed)
    simple_diffs: bool = False  # SIMPLEDIFFS
    lpc_order: int = 12  # LPCORDER (PLP)
    comp_factor: float = 0.33  # COMPRESSFACT (PLP cube-root)
    warp_freq: float = 1.0  # WARPFREQ (VTLN warp factor; 1.0 = off)
    warp_lcut: float = 0.0  # WARPLCUTOFF (Hz)
    warp_ucut: float = 0.0  # WARPUCUTOFF (Hz; 0 -> 0.8 * top [LC])

    @classmethod
    def from_config(cls, cfg: Config, samp_period: int) -> "FrontendConfig":
        m = "HPARM"
        kind_s = cfg.str_("TARGETKIND", "MFCC_E_D_A", module=m)
        return cls(
            target_kind=pk.str2parmkind(kind_s),
            samp_period=samp_period,
            window_size=cfg.flt_("WINDOWSIZE", 250000.0, module=m),
            target_rate=cfg.flt_("TARGETRATE", 100000.0, module=m),
            preem_coef=cfg.flt_("PREEMCOEF", 0.97, module=m),
            use_hamming=cfg.bool_("USEHAMMING", True, module=m),
            zmean_source=cfg.bool_("ZMEANSOURCE", False, module=m),
            raw_energy=cfg.bool_("RAWENERGY", True, module=m),
            num_chans=cfg.int_("NUMCHANS", 20, module=m),
            num_ceps=cfg.int_("NUMCEPS", 12, module=m),
            cep_lifter=cfg.int_("CEPLIFTER", 22, module=m),
            enormalise=cfg.bool_("ENORMALISE", True, module=m),
            escale=cfg.flt_("ESCALE", 0.1, module=m),
            sil_floor=cfg.flt_("SILFLOOR", 50.0, module=m),
            delta_window=cfg.int_("DELTAWINDOW", 2, module=m),
            acc_window=cfg.int_("ACCWINDOW", 2, module=m),
            third_window=cfg.int_("THIRDWINDOW", 2, module=m),
            lo_freq=cfg.flt_("LOFREQ", -1.0, module=m),
            hi_freq=cfg.flt_("HIFREQ", -1.0, module=m),
            use_power=cfg.bool_("USEPOWER", False, module=m),
            simple_diffs=cfg.bool_("SIMPLEDIFFS", False, module=m),
            lpc_order=cfg.int_("LPCORDER", 12, module=m),
            comp_factor=cfg.flt_("COMPRESSFACT", 0.33, module=m),
            add_dither=cfg.flt_("ADDDITHER", 0.0, module=m),
            warp_freq=cfg.flt_("WARPFREQ", 1.0, module=m),
            warp_lcut=cfg.flt_("WARPLCUTOFF", 0.0, module=m),
            warp_ucut=cfg.flt_("WARPUCUTOFF", 0.0, module=m),
        )

    # -- derived static geometry ----------------------------------------

    @property
    def frame_size(self) -> int:
        return int(self.window_size / self.samp_period + 0.5)

    @property
    def frame_shift(self) -> int:
        return int(self.target_rate / self.samp_period + 0.5)

    @property
    def fft_n(self) -> int:
        n = 2
        while n < self.frame_size:
            n *= 2
        return n

    @property
    def base(self) -> int:
        return pk.base_kind(self.target_kind)

    @property
    def base_str(self) -> str:
        return pk.BASE_KINDS[self.base]

    def n_static(self) -> int:
        """Static coefficients per frame (before _N suppression)."""
        if self.base_str in ("FBANK", "MELSPEC"):
            n = self.num_chans
        elif self.base_str in ("MFCC", "PLP", "LPCEPSTRA"):
            n = self.num_ceps
        elif self.base_str == "LPC":
            n = self.lpc_order
        else:
            HError(6320, "Frontend: unsupported TARGETKIND base %s", self.base_str)
        if pk.has_qual(self.target_kind, pk.HASZEROC):
            n += 1
        if pk.has_qual(self.target_kind, pk.HASENERGY):
            n += 1
        return n

    def n_blocks(self) -> int:
        n = 1
        if pk.has_qual(self.target_kind, pk.HASDELTA):
            n += 1
        if pk.has_qual(self.target_kind, pk.HASACCS):
            n += 1
        if pk.has_qual(self.target_kind, pk.HASTHIRD):
            n += 1
        return n

    def width(self) -> int:
        w = self.n_static() * self.n_blocks()
        if pk.has_qual(self.target_kind, pk.HASNULLE):
            w -= 1
        return w


# ---------------------------------------------------------------------------
# Host-side precomputed tables (HSigP.c : InitFBank / FBank2MFCC tables)
# ---------------------------------------------------------------------------


def _mel(freq_hz: float) -> float:
    return 1127.0 * math.log(1.0 + freq_hz / 700.0)


def _warp_freq(f: float, fl: float, fu: float, alpha: float,
               min_f: float, max_f: float) -> float:
    """Piecewise-linear VTLN frequency warp (HTKBook 5.10 / HSigP.c
    WarpFreq [LC — boundary-piece coefficients follow the published
    endpoint-preserving form]): slope 1/alpha inside [cl, cu], linear
    boundary pieces pinning W(min_f) = min_f and W(max_f) = max_f."""
    if alpha == 1.0:
        return f
    scale = 1.0 / alpha
    cu = fu * 2.0 / (1.0 + scale)
    cl = fl * 2.0 / (1.0 + scale)
    if f > cu and max_f > cu:
        au = (max_f - cu * scale) / (max_f - cu)
        return au * (f - cu) + scale * cu
    if f < cl and cl > min_f:
        al = (cl * scale - min_f) / (cl - min_f)
        return al * (f - min_f) + min_f
    return scale * f


def mel_weight_matrix(cfg: FrontendConfig) -> np.ndarray:
    """Triangular mel filterbank as an (n_rfft_bins, num_chans) matrix.

    Reproduces HSigP.c : InitFBank()'s loChan/loWt tables and
    Wave2FBank()'s accumulation, recast as a single matrix so the binning
    runs as one matmul over all frames. Row j corresponds to rfft bin
    j (0-based; HTK's 1-based "bin k" = rfft bin k-1).
    """
    fft_n = cfg.fft_n
    nby2 = fft_n // 2
    fs = 1.0e7 / cfg.samp_period
    fres = 1.0e7 / (cfg.samp_period * fft_n * 700.0)
    max_chan = cfg.num_chans + 1

    klo, khi = 2, nby2
    mlo = 0.0
    mhi = 1127.0 * math.log(1.0 + (nby2 + 1 - 1) * fres)
    if cfg.lo_freq >= 0.0:
        mlo = _mel(cfg.lo_freq)
        klo = max(2, int(cfg.lo_freq * cfg.samp_period * 1.0e-7 * fft_n + 2.5))
    if cfg.hi_freq > 0.0:
        mhi = _mel(cfg.hi_freq)
        khi = min(nby2, int(cfg.hi_freq * cfg.samp_period * 1.0e-7 * fft_n + 0.5))

    # channel centres, uniformly spaced in mel between mlo and mhi
    cf = np.zeros(max_chan + 1)
    for chan in range(1, max_chan + 1):
        cf[chan] = (chan / max_chan) * (mhi - mlo) + mlo
    if cfg.warp_freq != 1.0:
        # VTLN (WARPFREQ): warp the channel centres' linear frequency,
        # endpoints pinned so the analysis band is unchanged
        min_f = max(cfg.lo_freq, 0.0)
        max_f = cfg.hi_freq if cfg.hi_freq > 0 else fs / 2.0
        fu = cfg.warp_ucut if cfg.warp_ucut > 0 else 0.8 * max_f
        fl = max(cfg.warp_lcut, min_f)
        for chan in range(1, max_chan + 1):
            f_hz = 700.0 * (math.exp(cf[chan] / 1127.0) - 1.0)
            cf[chan] = _mel(_warp_freq(f_hz, fl, fu, cfg.warp_freq,
                                       min_f, max_f))

    # loChan: highest centre at or below each bin's mel frequency
    lo_chan = np.full(nby2 + 1, -1, dtype=np.int64)
    chan = 1
    for k in range(1, nby2 + 1):
        melk = 1127.0 * math.log(1.0 + (k - 1) * fres)
        if klo <= k <= khi:
            while chan <= max_chan and cf[chan] < melk:
                chan += 1
            lo_chan[k] = chan - 1

    lo_wt = np.zeros(nby2 + 1)
    for k in range(1, nby2 + 1):
        c = lo_chan[k]
        if klo <= k <= khi:
            melk = 1127.0 * math.log(1.0 + (k - 1) * fres)
            if c > 0:
                lo_wt[k] = (cf[c + 1] - melk) / (cf[c + 1] - cf[c])
            else:
                lo_wt[k] = (cf[1] - melk) / (cf[1] - mlo)

    # scatter into matrix over rfft bins 0..nby2 (HTK never uses DC/Nyquist)
    W = np.zeros((nby2 + 1, cfg.num_chans))
    for k in range(klo, khi + 1):
        c = lo_chan[k]
        j = k - 1  # rfft bin index
        if c > 0:
            W[j, c - 1] += lo_wt[k]
        if c < cfg.num_chans:
            W[j, c] += 1.0 - lo_wt[k]
    return W.astype(np.float32)


def dct_matrix(num_chans: int, num_ceps: int) -> np.ndarray:
    """(num_chans, num_ceps) DCT per HSigP.c : FBank2MFCC()."""
    mfnorm = math.sqrt(2.0 / num_chans)
    M = np.zeros((num_chans, num_ceps))
    for j in range(1, num_ceps + 1):
        x = j * math.pi / num_chans
        for k in range(1, num_chans + 1):
            M[k - 1, j - 1] = mfnorm * math.cos(x * (k - 0.5))
    return M.astype(np.float32)


def lifter_vector(num_ceps: int, L: int) -> np.ndarray:
    """Cepstral liftering weights per HSigP.c : GenCepWin/WeightCepstrum."""
    if L <= 0:
        return np.ones(num_ceps, dtype=np.float32)
    j = np.arange(1, num_ceps + 1)
    return (1.0 + (L / 2.0) * np.sin(math.pi * j / L)).astype(np.float32)


def equal_loudness(cfg: FrontendConfig) -> np.ndarray:
    """Equal-loudness weights at the mel channel centres (HSigP InitPLP)."""
    fft_n = cfg.fft_n
    nby2 = fft_n // 2
    fres = 1.0e7 / (cfg.samp_period * fft_n * 700.0)
    max_chan = cfg.num_chans + 1
    mlo = _mel(cfg.lo_freq) if cfg.lo_freq >= 0 else 0.0
    mhi = (_mel(cfg.hi_freq) if cfg.hi_freq > 0
           else 1127.0 * math.log(1.0 + nby2 * fres))
    eql = np.zeros(cfg.num_chans)
    for chan in range(1, cfg.num_chans + 1):
        cf_mel = (chan / max_chan) * (mhi - mlo) + mlo
        f_hz = 700.0 * (math.exp(cf_mel / 1127.0) - 1.0)
        fsq = f_hz * f_hz
        fsub = fsq / (fsq + 1.6e5)
        eql[chan - 1] = fsub * fsub * ((fsq + 1.44e6) / (fsq + 9.61e6))
    return eql.astype(np.float32)


def plp_idft_matrix(num_chans: int, lpc_order: int) -> np.ndarray:
    """(num_chans+2, lpc_order+1) IDFT for auditory-spectrum -> autocorr.

    HSigP InitPLP's cosine table over the symmetrised 2*(numChans+1)-point
    spectrum (edge channels duplicated).
    """
    n_auto = lpc_order + 1
    pts = num_chans + 2  # with duplicated edges
    twoN = 2.0 * (num_chans + 1)
    M = np.zeros((pts, n_auto))
    for i in range(n_auto):
        for j in range(pts):
            w = 1.0 if j in (0, pts - 1) else 2.0
            M[j, i] = w * math.cos(math.pi * i * j / (num_chans + 1))
    return (M / twoN).astype(np.float32)


def _durbin(autoc: jnp.ndarray, order: int):
    """Levinson-Durbin over a batch: autoc (T, order+1) -> (lpc (T, order), E).

    HSigP.c Durbin(), vectorised over frames with a Python loop over the
    (small, static) order.
    """
    T = autoc.shape[0]
    E = autoc[:, 0]
    a = jnp.zeros((T, order + 1), autoc.dtype)  # a[:, 1..order]
    for i in range(1, order + 1):
        acc = autoc[:, i]
        for j in range(1, i):
            acc = acc - a[:, j] * autoc[:, i - j]
        k = acc / jnp.maximum(E, 1e-20)
        new_a = a.at[:, i].set(k)
        for j in range(1, i):
            new_a = new_a.at[:, j].set(a[:, j] - k * a[:, i - j])
        a = new_a
        E = E * (1.0 - k * k)
    return a[:, 1:], E


def _lpc_to_cepstra(lpc: jnp.ndarray, n_ceps: int, gain: jnp.ndarray):
    """LPC -> cepstra (HSigP.c LPC2Cepstrum):

      c[n] = -(a[n] + (1/n) sum_{i=1..n-1} (n-i) a[i] c[n-i]),  a[n>p] = 0
    """
    T, p = lpc.shape
    c = jnp.zeros((T, n_ceps + 1), lpc.dtype)
    for n in range(1, n_ceps + 1):
        acc = lpc[:, n - 1] if n <= p else jnp.zeros(T, lpc.dtype)
        for i in range(1, min(n, p + 1)):
            acc = acc + ((n - i) / n) * lpc[:, i - 1] * c[:, n - i]
        c = c.at[:, n].set(-acc)
    return c[:, 1:]


def regression_matrix(n_frames: int, win: int, simple_diffs: bool = False) -> np.ndarray:
    """(T, T) matrix R with deltas = R @ x (HParm.c : Regress()).

    d_t = sum_{th=1..win} th*(x_{t+th} - x_{t-th}) / (2*sum th^2), with
    boundary frames replicated (index clamping), matching HTK's file-mode
    behaviour. simple_diffs uses (x_{t+th}-x_{t-th})/(2*win) instead.
    """
    R = np.zeros((n_frames, n_frames))
    if simple_diffs:
        norm = 2.0 * win
        for t in range(n_frames):
            for th in range(1, win + 1):
                hi = min(n_frames - 1, t + th)
                lo = max(0, t - th)
                R[t, hi] += 1.0 / norm
                R[t, lo] -= 1.0 / norm
    else:
        sigma2 = 2.0 * sum(th * th for th in range(1, win + 1))
        for t in range(n_frames):
            for th in range(1, win + 1):
                hi = min(n_frames - 1, t + th)
                lo = max(0, t - th)
                R[t, hi] += th / sigma2
                R[t, lo] -= th / sigma2
    return R.astype(np.float32)


# ---------------------------------------------------------------------------
# Device pipeline
# ---------------------------------------------------------------------------


def num_frames(n_samples: int, cfg: FrontendConfig) -> int:
    """HParm frame count: ((nSamples - frameSize) / frameShift) + 1."""
    if n_samples < cfg.frame_size:
        return 0
    return (n_samples - cfg.frame_size) // cfg.frame_shift + 1


def _frame_signal(x: jnp.ndarray, frame_size: int, frame_shift: int, n_frames: int):
    idx = jnp.arange(n_frames)[:, None] * frame_shift + jnp.arange(frame_size)[None, :]
    return x[idx]


def _delta_block(x: jnp.ndarray, win: int, simple: bool) -> jnp.ndarray:
    """Apply HTK regression along time for a (T, D) block.

    Computed directly (gather + weighted sum) rather than via the (T, T)
    matrix so the cost is O(T*D*win) and shapes stay static.
    """
    T = x.shape[0]
    if simple:
        norm = 2.0 * win
        acc = jnp.zeros_like(x)
        for th in range(1, win + 1):
            hi = jnp.clip(jnp.arange(T) + th, 0, T - 1)
            lo = jnp.clip(jnp.arange(T) - th, 0, T - 1)
            acc = acc + (x[hi] - x[lo])
        return acc / norm
    sigma2 = 2.0 * sum(th * th for th in range(1, win + 1))
    acc = jnp.zeros_like(x)
    for th in range(1, win + 1):
        hi = jnp.clip(jnp.arange(T) + th, 0, T - 1)
        lo = jnp.clip(jnp.arange(T) - th, 0, T - 1)
        acc = acc + th * (x[hi] - x[lo])
    return acc / sigma2


@dataclass(frozen=True)
class _Tables:
    mel_w: np.ndarray
    dct: np.ndarray
    lifter: np.ndarray
    hamming: np.ndarray
    eql: np.ndarray
    plp_idft: np.ndarray


@functools.lru_cache(maxsize=64)
def _tables(cfg: FrontendConfig) -> _Tables:
    fs = cfg.frame_size
    a = 2.0 * math.pi / (fs - 1)
    ham = (0.54 - 0.46 * np.cos(a * np.arange(fs))).astype(np.float32)
    return _Tables(
        mel_w=mel_weight_matrix(cfg),
        dct=dct_matrix(cfg.num_chans, cfg.num_ceps),
        lifter=lifter_vector(cfg.num_ceps, cfg.cep_lifter),
        hamming=ham,
        eql=equal_loudness(cfg),
        plp_idft=plp_idft_matrix(cfg.num_chans, cfg.lpc_order),
    )


def _statics_from_frames(frames: jnp.ndarray, cfg: FrontendConfig, tbl: _Tables):
    """frames (T, frame_size) float32 -> statics (T, n_static) + raw logE.

    Follows HParm.c ConvertFrame order: zmean -> rawE -> preemph -> window
    -> spectrum -> mel -> log -> DCT -> lifter -> c0/E append.
    """
    x = frames
    if cfg.zmean_source:
        x = x - jnp.mean(x, axis=1, keepdims=True)

    raw_e = jnp.sum(x * x, axis=1)

    if cfg.preem_coef != 0.0:
        # PreEmphasise: s[j] -= k*s[j-1] (descending, so original values);
        # s[0] *= 1-k falls out of pairing s[0] with itself in the shift.
        shifted = jnp.concatenate([x[:, :1], x[:, :-1]], axis=1)
        x = x - cfg.preem_coef * shifted
    if cfg.use_hamming:
        x = x * jnp.asarray(tbl.hamming)

    win_e = jnp.sum(x * x, axis=1)
    log_e = jnp.log(jnp.maximum(raw_e if cfg.raw_energy else win_e, 1e-20))

    base = cfg.base_str
    fft_n = cfg.fft_n
    spec = jnp.fft.rfft(x, n=fft_n, axis=1)
    mag = jnp.abs(spec).astype(jnp.float32)  # (T, fft_n//2+1)
    # PLP always uses the power spectrum (HParm.c forces usePower for PLP)
    if cfg.use_power or base == "PLP":
        mag = mag * mag

    # precision="highest" keeps these parity-critical matmuls in true f32
    # (a GPU's default f32 matmul may run in TF32 — ~1e-3 rel error,
    # outside the 1e-4 parity budget); cost is negligible at these sizes.
    fbank = jnp.matmul(mag, jnp.asarray(tbl.mel_w), precision="highest")
    log_fbank = jnp.log(jnp.maximum(fbank, 1.0))  # melFloor = 1.0

    gain = None  # LPC/PLP model gain, used for _0
    cols = []
    if base == "MELSPEC":
        cols.append(fbank)
    elif base == "FBANK":
        cols.append(log_fbank)
    elif base == "MFCC":
        ceps = jnp.matmul(log_fbank, jnp.asarray(tbl.dct), precision="highest")
        ceps = ceps * jnp.asarray(tbl.lifter)
        cols.append(ceps)
    elif base == "PLP":
        # HSigP.c FBank2PLP: equal loudness -> cube-root compression ->
        # IDFT to autocorrelation -> Durbin -> LPC cepstra -> lifter
        aspec = fbank * jnp.asarray(tbl.eql)[None, :]
        aspec = jnp.power(jnp.maximum(aspec, 1e-10), cfg.comp_factor)
        padded = jnp.concatenate([aspec[:, :1], aspec, aspec[:, -1:]], axis=1)
        autoc = jnp.matmul(padded, jnp.asarray(tbl.plp_idft),
                           precision="highest")  # (T, p+1)
        lpc, E = _durbin(autoc, cfg.lpc_order)
        ceps = _lpc_to_cepstra(lpc, cfg.num_ceps, E)
        ceps = ceps * jnp.asarray(tbl.lifter)
        cols.append(ceps)
        gain = jnp.log(jnp.maximum(E, 1e-20))
    elif base in ("LPC", "LPCEPSTRA"):
        # time-domain autocorrelation of the windowed frame (Wave2LPC)
        p = cfg.lpc_order
        autoc = jnp.stack(
            [jnp.sum(x[:, : x.shape[1] - k] * x[:, k:], axis=1)
             for k in range(p + 1)], axis=1,
        )
        lpc, E = _durbin(autoc, p)
        if base == "LPC":
            cols.append(lpc)
        else:
            ceps = _lpc_to_cepstra(lpc, cfg.num_ceps, E)
            ceps = ceps * jnp.asarray(tbl.lifter)
            cols.append(ceps)
        gain = jnp.log(jnp.maximum(E, 1e-20))
    else:
        HError(6320, "Frontend: TARGETKIND base %s not yet device-supported", base)

    if pk.has_qual(cfg.target_kind, pk.HASZEROC):
        if gain is not None:
            c0 = gain[:, None]
        else:
            mfnorm = math.sqrt(2.0 / cfg.num_chans)
            c0 = jnp.sum(log_fbank, axis=1, keepdims=True) * mfnorm
        cols.append(c0)
    if pk.has_qual(cfg.target_kind, pk.HASENERGY):
        cols.append(log_e[:, None])
    return jnp.concatenate(cols, axis=1), log_e


def _qualify(statics: jnp.ndarray, cfg: FrontendConfig, valid: Optional[jnp.ndarray] = None):
    """Apply _E normalisation, _Z CMN, _D/_A/_T, _N to static features.

    `valid` is an optional (T,) bool mask marking real (non-padding) frames;
    per-file reductions (CMN mean, energy max) respect it.
    """
    T = statics.shape[0]
    if valid is None:
        valid = jnp.ones((T,), dtype=bool)
    vf = valid.astype(statics.dtype)[:, None]
    nvalid = jnp.maximum(jnp.sum(vf), 1.0)

    has_e = pk.has_qual(cfg.target_kind, pk.HASENERGY)
    has_0 = pk.has_qual(cfg.target_kind, pk.HASZEROC)
    x = statics

    # _Z: cepstral mean subtraction over the file, statics except energy
    # (energy is handled by ENORMALISE; HParm.c MeanNormalise behaviour).
    if pk.has_qual(cfg.target_kind, pk.HASZEROM):
        ncep = x.shape[1] - (1 if has_e else 0)
        mean = jnp.sum(x[:, :ncep] * vf, axis=0) / nvalid
        x = x.at[:, :ncep].add(-mean[None, :])

    # ENORMALISE: e' = 1.0 - (emax - e)*escale with silence floor (HParm.c)
    if has_e and cfg.enormalise:
        e = x[:, -1]
        emax = jnp.max(jnp.where(valid, e, -jnp.inf))
        emin = emax - (cfg.sil_floor * math.log(10.0)) / 10.0
        e = jnp.maximum(e, emin)
        e = 1.0 - (emax - e) * cfg.escale
        x = x.at[:, -1].set(e)

    # Padding rows must replicate the last *valid* row before every
    # regression stage, otherwise the next stage's boundary clamp reads
    # stale values through the padding (HTK clamps at the true last frame).
    n_real = jnp.sum(valid.astype(jnp.int32))
    last = jnp.clip(jnp.arange(T), 0, n_real - 1)

    blocks = [x]
    if pk.has_qual(cfg.target_kind, pk.HASDELTA):
        d = _delta_block(blocks[-1], cfg.delta_window, cfg.simple_diffs)[last]
        blocks.append(d)
        if pk.has_qual(cfg.target_kind, pk.HASACCS):
            a = _delta_block(d, cfg.acc_window, cfg.simple_diffs)[last]
            blocks.append(a)
            if pk.has_qual(cfg.target_kind, pk.HASTHIRD):
                t3 = _delta_block(a, cfg.third_window, cfg.simple_diffs)[last]
                blocks.append(t3)
    out = jnp.concatenate(blocks, axis=1)

    if pk.has_qual(cfg.target_kind, pk.HASNULLE):
        # _N: suppress absolute energy (or c0 if no _E) from the statics
        if not (has_e or has_0):
            HError(6321, "Frontend: _N requires _E or _0")
        drop = cfg.n_static() - 1  # energy (or c0) is the last static column
        keep = [i for i in range(out.shape[1]) if i != drop]
        out = out[:, jnp.asarray(keep)]
    return out


def _bucket_len(n: int) -> int:
    """Round frame counts up to limit jit retraces across utterance lengths."""
    b = 32
    while b < n:
        b = b * 2 if b < 512 else b + 256
    return b


def _extract_impl(samples: jnp.ndarray, n_frames_real: jnp.ndarray,
                  cfg: FrontendConfig, n_frames_pad: int) -> jnp.ndarray:
    tbl = _tables(cfg)
    frames = _frame_signal(samples, cfg.frame_size, cfg.frame_shift, n_frames_pad)
    frames = frames.astype(jnp.float32)
    statics, _ = _statics_from_frames(frames, cfg, tbl)
    valid = jnp.arange(n_frames_pad) < n_frames_real
    # Replicate the last real frame into the padding rows so the delta
    # regression's boundary clamp (HParm replicates edge frames) holds at
    # the real end of the utterance; per-file reductions use `valid`.
    last = jnp.clip(jnp.arange(n_frames_pad), 0, n_frames_real - 1)
    statics = statics[last]
    return _qualify(statics, cfg, valid=valid)


@functools.partial(jax.jit, static_argnames=("cfg", "n_frames_pad"))
def _extract_padded(samples: jnp.ndarray, n_frames_real: jnp.ndarray,
                    cfg: FrontendConfig, n_frames_pad: int) -> jnp.ndarray:
    return _extract_impl(samples, n_frames_real, cfg, n_frames_pad)


@functools.partial(jax.jit, static_argnames=("cfg", "n_frames_pad"))
def _extract_padded_batch(samples: jnp.ndarray, n_frames_real: jnp.ndarray,
                          cfg: FrontendConfig,
                          n_frames_pad: int) -> jnp.ndarray:
    return jax.vmap(lambda s, t: _extract_impl(s, t, cfg, n_frames_pad))(
        samples, n_frames_real)


def compute_features(samples: np.ndarray, cfg: FrontendConfig) -> np.ndarray:
    """Waveform (int16/float) -> HTK feature matrix (T, width) float32.

    The public single-utterance entry (HCopy's hot path). Pads the frame
    count to a bucket so repeated calls across utterance lengths reuse a
    small set of compiled programs.
    """
    # HParm ADDDITHER: +-d uniform noise so digital silence never hits
    # log(0). HTK draws from rand(); a fixed-seed generator keeps our
    # features reproducible run to run.
    samples = _dithered(samples, cfg)
    T = num_frames(len(samples), cfg)
    if T < 1:
        HError(6322, "Frontend: utterance too short (%d samples)", len(samples))
    Tp = _bucket_len(T)
    need = (Tp - 1) * cfg.frame_shift + cfg.frame_size
    padded = np.zeros(need, dtype=np.float32)
    # trailing samples past the last full frame belong to NO frame (T is
    # the frame count), so truncating to the padded buffer is exact —
    # len(samples) can exceed `need` when T lands exactly on a bucket
    n_copy = min(len(samples), need)
    padded[:n_copy] = samples[:n_copy]
    out = _extract_padded(jnp.asarray(padded), jnp.asarray(T), cfg, Tp)
    return np.asarray(out[:T])


def _dithered(samples: np.ndarray, cfg: FrontendConfig) -> np.ndarray:
    samples = np.asarray(samples, dtype=np.float32)
    if cfg.add_dither > 0.0 and len(samples):
        rng = np.random.default_rng(12345)
        samples = samples + cfg.add_dither * (
            2.0 * rng.random(len(samples), dtype=np.float32) - 1.0)
    return samples


def compute_features_batch(jobs) -> list:
    """Batched wave->features: `jobs` is [(samples, cfg), ...]; returns
    the per-job feature matrices in order, numerically identical to
    compute_features per job (tested).

    Files group by (cfg, frame bucket) and each group runs as ONE
    batched program (batch padded to a power of two, capped at 64, to
    bound recompiles) — corpus preparation at scale amortises the
    per-file dispatch cost that dominates tiny per-utterance kernels.
    """
    outs: list = [None] * len(jobs)
    groups: dict = {}
    for i, (samples, cfg) in enumerate(jobs):
        s = _dithered(samples, cfg)
        T = num_frames(len(s), cfg)
        if T < 1:
            HError(6322, "Frontend: utterance too short (%d samples)",
                   len(s))
        groups.setdefault((cfg, _bucket_len(T)), []).append((i, s, T))
    for (cfg, Tp), items in groups.items():
        need = (Tp - 1) * cfg.frame_shift + cfg.frame_size
        B = len(items)
        # FIXED batch width: one compiled program per (cfg, bucket) and,
        # more importantly, output values that do not depend on which
        # other files share the scp chunk (a varying batch dimension
        # changes XLA's FFT tiling and wobbles the last float bits)
        Bp = 64
        for i0 in range(0, B, Bp):
            chunk = items[i0 : i0 + Bp]
            buf = np.zeros((Bp, need), np.float32)
            ts = np.zeros(Bp, np.int32)
            for b, (_i, s, T) in enumerate(chunk):
                n_copy = min(len(s), need)  # see compute_features
                buf[b, :n_copy] = s[:n_copy]
                ts[b] = T
            ts[len(chunk):] = 1  # dummy rows: one valid frame
            out = np.asarray(_extract_padded_batch(
                jnp.asarray(buf), jnp.asarray(ts), cfg, Tp))
            for b, (i, _s, T) in enumerate(chunk):
                outs[i] = out[b, :T]
    return outs
