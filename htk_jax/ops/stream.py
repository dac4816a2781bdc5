"""Streaming (live-mode) feature extraction — HParm's ParmBuf role.

`HTKLib/HParm.c` runs one frontend for both files and live audio: in
live mode a ring buffer accumulates samples from HAudio and frames are
converted as soon as their window is full, with qualifier stages that
need future context (deltas/accs) delaying emission by their lookahead.
This module is that streaming path for the device frontend: it feeds
whole *chunks* of frames through the same jitted statics kernel as the
batch path (ops/dsp._statics_from_frames — identical per-frame math,
so streamed features match `compute_features` numerically; tested), and
applies the delta regressions incrementally on the host over a statics
FIFO.

Live-mode qualifier rules (HParm.c's own restrictions, kept as parity):
  - ENORMALISE needs the whole file's max energy — not available live.
    HParm refuses it in live mode; so do we (HError 6324). Configure
    ENORMALISE = F for live decoding.
  - _Z needs the file cepstral mean. Live HTK (3.5) substitutes a
    precomputed mean (CMEANVECTOR-style); pass `cepmean=` for that, else
    _Z is refused (HError 6324).
  - _C/_K/_V are file-storage qualifiers — meaningless on a live stream.

Emission timing: a frame's deltas need +DELTAWINDOW future frames, accs
+ACCWINDOW more, etc. — `lookahead` frames of delay before a frame's
full feature vector can be emitted. flush() emits the delayed tail with
HTK's end-of-data clamping, after which the stream equals the batch
computation frame-for-frame.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..io import parmkind as pk
from ..utils.errors import HError
from .dsp import FrontendConfig, _statics_from_frames, _tables


@functools.partial(jax.jit, static_argnames=("cfg",))
def _statics_chunk(frames: jnp.ndarray, cfg: FrontendConfig) -> jnp.ndarray:
    statics, _ = _statics_from_frames(frames.astype(jnp.float32), cfg,
                                      _tables(cfg))
    return statics


class StreamingFrontend:
    """Incremental waveform -> feature frames, matching the batch path."""

    def __init__(self, cfg: FrontendConfig, cepmean: Optional[np.ndarray] = None,
                 chunk_frames: int = 32):
        kind = cfg.target_kind
        if pk.has_qual(kind, pk.HASENERGY) and cfg.enormalise:
            HError(6324, "StreamingFrontend: ENORMALISE cannot be used in "
                         "live mode (set HPARM: ENORMALISE = F)")
        if pk.has_qual(kind, pk.HASZEROM) and cepmean is None:
            HError(6324, "StreamingFrontend: _Z in live mode needs a "
                         "precomputed cepstral mean (cepmean=)")
        for bit, name in ((pk.HASCOMPX, "_C"), (pk.HASCRCC, "_K"),
                          (pk.HASVQ, "_V")):
            if pk.has_qual(kind, bit):
                HError(6324, "StreamingFrontend: %s is a file-storage "
                             "qualifier; not meaningful live", name)
        self.cfg = cfg
        self.chunk_frames = int(chunk_frames)
        self._cepmean = (None if cepmean is None
                         else np.asarray(cepmean, np.float32))

        la = 0
        if pk.has_qual(kind, pk.HASDELTA):
            la += cfg.delta_window
            if pk.has_qual(kind, pk.HASACCS):
                la += cfg.acc_window
                if pk.has_qual(kind, pk.HASTHIRD):
                    la += cfg.third_window
        self.lookahead = la

        self._samples = np.zeros(0, np.float32)  # not-yet-framed tail
        # geometric-growth statics buffer: a live session appends for
        # hours, so per-chunk reallocation must be amortised O(1)
        self._stat_buf = np.empty((256, cfg.n_static()), np.float32)
        self._n_statics = 0
        self._emitted = 0  # frames whose full vector has been returned
        self._flushed = False

    # -- internals -------------------------------------------------------

    def _compute_statics(self, final: bool) -> None:
        """Convert every fully-buffered frame (all of them at flush)."""
        cfg = self.cfg
        fs, shift = cfg.frame_size, cfg.frame_shift
        n_avail = 0 if len(self._samples) < fs else \
            (len(self._samples) - fs) // shift + 1
        # in chunks so jit sees at most a few shapes
        while n_avail > 0:
            n = min(n_avail, self.chunk_frames) if not final else n_avail
            if not final and n < self.chunk_frames:
                break  # wait for a full chunk (flush converts the rest)
            n_pad = ((n + self.chunk_frames - 1)
                     // self.chunk_frames) * self.chunk_frames
            need = (n_pad - 1) * shift + fs
            buf = np.zeros(need, np.float32)
            m = min(len(self._samples), need)
            buf[:m] = self._samples[:m]
            idx = (np.arange(n_pad)[:, None] * shift + np.arange(fs)[None, :])
            st = np.asarray(_statics_chunk(jnp.asarray(buf[idx]), cfg))[:n]
            if self._cepmean is not None:
                ncep = st.shape[1] - (
                    1 if pk.has_qual(cfg.target_kind, pk.HASENERGY) else 0)
                st = st.copy()
                st[:, :ncep] -= self._cepmean[None, :ncep]
            need = self._n_statics + n
            if need > len(self._stat_buf):
                grown = np.empty((max(2 * len(self._stat_buf), need),
                                  self._stat_buf.shape[1]), np.float32)
                grown[: self._n_statics] = self._stat_buf[: self._n_statics]
                self._stat_buf = grown
            self._stat_buf[self._n_statics: need] = st
            self._n_statics = need
            self._samples = self._samples[n * shift:]
            n_avail -= n

    def _qualified(self, lo: int, hi: int, t_end: Optional[int]) -> np.ndarray:
        """Full feature vectors for frames [lo, hi) given statics so far.

        t_end: index of the last *real* frame (for end clamping), or None
        while the stream is still open (callers only ask for frames whose
        whole regression window is already buffered, so no end clamp can
        bind).

        Only the statics window [lo - lookahead, hi + lookahead) is
        touched, so per-frame work stays O(1) over arbitrarily long
        live sessions; regression index clamps stay GLOBAL (utterance
        start / t_end), never at the window edge — window rows whose
        own neighbours fall outside are never read for [lo, hi).
        """
        cfg = self.cfg
        kind = cfg.target_kind
        T = self._n_statics
        w0 = max(0, lo - self.lookahead)
        w1 = min(T, hi + self.lookahead)
        x = self._stat_buf[w0:w1]
        t_max = (T - 1) if t_end is None else t_end

        def regress(block: np.ndarray, win: int) -> np.ndarray:
            tg = np.arange(w0, w0 + block.shape[0])  # global frame index
            n = block.shape[0]
            if cfg.simple_diffs:
                acc = np.zeros_like(block)
                for th in range(1, win + 1):
                    hi_i = np.clip(np.minimum(t_max, tg + th) - w0, 0, n - 1)
                    lo_i = np.clip(np.maximum(0, tg - th) - w0, 0, n - 1)
                    acc = acc + (block[hi_i] - block[lo_i])
                return acc / np.float32(2.0 * win)
            sigma2 = np.float32(2.0 * sum(th * th for th in range(1, win + 1)))
            acc = np.zeros_like(block)
            for th in range(1, win + 1):
                hi_i = np.clip(np.minimum(t_max, tg + th) - w0, 0, n - 1)
                lo_i = np.clip(np.maximum(0, tg - th) - w0, 0, n - 1)
                acc = acc + np.float32(th) * (block[hi_i] - block[lo_i])
            return acc / sigma2

        blocks = [x]
        if pk.has_qual(kind, pk.HASDELTA):
            d = regress(blocks[-1], cfg.delta_window)
            blocks.append(d)
            if pk.has_qual(kind, pk.HASACCS):
                a = regress(d, cfg.acc_window)
                blocks.append(a)
                if pk.has_qual(kind, pk.HASTHIRD):
                    blocks.append(regress(a, cfg.third_window))
        out = np.concatenate(blocks, axis=1)[lo - w0: hi - w0]
        if pk.has_qual(kind, pk.HASNULLE):
            has_e = pk.has_qual(kind, pk.HASENERGY)
            has_0 = pk.has_qual(kind, pk.HASZEROC)
            if not (has_e or has_0):
                HError(6321, "StreamingFrontend: _N requires _E or _0")
            drop = cfg.n_static() - 1
            keep = [i for i in range(out.shape[1]) if i != drop]
            out = out[:, keep]
        return out

    # -- public API ------------------------------------------------------

    def feed(self, samples: np.ndarray) -> np.ndarray:
        """Push samples; returns the feature frames that became final."""
        if self._flushed:
            HError(6325, "StreamingFrontend: feed() after flush()")
        self._samples = np.concatenate(
            [self._samples, np.asarray(samples, np.float32)])
        self._compute_statics(final=False)
        ready = self._n_statics - self.lookahead
        if ready <= self._emitted:
            return np.zeros((0, self.cfg.width()), np.float32)
        out = self._qualified(self._emitted, ready, None)
        self._emitted = ready
        return out

    def flush(self) -> np.ndarray:
        """End of stream: emit the delayed tail with end clamping."""
        if self._flushed:
            return np.zeros((0, self.cfg.width()), np.float32)
        self._flushed = True
        self._compute_statics(final=True)
        if self._n_statics == 0 or self._emitted >= self._n_statics:
            return np.zeros((0, self.cfg.width()), np.float32)
        out = self._qualified(self._emitted, self._n_statics,
                              self._n_statics - 1)
        self._emitted = self._n_statics
        return out

    @property
    def n_frames(self) -> int:
        return self._emitted
