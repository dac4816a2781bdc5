"""Shared tool plumbing: matmul precision, data-file opening."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..io import parmkind as pk
from ..io.htkfeat import HTKFeatureFile, read_htk_file
from ..io.scp import ScpEntry, parse_scp_entry
from ..io.wavefile import read_wave
from ..ops.dsp import FrontendConfig, compute_features, num_frames
from ..utils.config import Config
from ..utils.errors import HError


def outp_precision(cfg: Config) -> str:
    """Matmul precision for the OutP / accumulator paths.

    `HTKTPU: PRECISION = highest|high|default` maps onto jax matmul
    precision. highest is true f32, the parity default. On an H100,
    high and default both run f32 matmuls in TF32: measured against a
    float64 reference at the config-#4 OutP shapes, state
    log-likelihoods move by up to 0.29 (relative 3.0e-4), against 3.5e-4
    for highest (chip_smoke.py prints the table).
    """
    p = (cfg.str_("PRECISION", "highest", module="HTKTPU")
         or "highest").lower()
    if p not in ("highest", "high", "default"):
        HError(1019, "HTKTPU: PRECISION must be highest|high|default "
               "(got %s)", p)
    return p


def source_kind(cfg: Config) -> int:
    return pk.str2parmkind(cfg.str_("SOURCEKIND", "ANON", module="HPARM")
                           if cfg.str_("SOURCEKIND", None, module="HPARM")
                           else "WAVEFORM")


def channel_config(cfg: Config, n: int) -> Config:
    """Single-pass-retraining channel view (HERest -r).

    HParm.c's dual-channel configuration: entries qualified HPARM1:/
    HWAVE1: apply to the alignment channel, HPARM2:/HWAVE2: to the
    update channel. This returns a Config where channel-n entries are
    promoted into HPARM/HWAVE, so the ordinary open_speech_file path
    reads that channel.
    """
    out = Config(entries=dict(cfg.entries), sources=list(cfg.sources))
    for (mod, name), val in cfg.entries.items():
        if mod in (f"HPARM{n}", f"HWAVE{n}"):
            out.entries[(mod[:-1], name)] = val
    return out


class DeferredWave:
    """A waveform read whose frontend run is deferred for batching.

    open_speech_file(defer_frontend=True) returns this instead of
    features when the source resolves to a waveform; the caller collects
    a chunk of these and runs ops/dsp.compute_features_batch over them
    (HCopy's corpus-preparation fast path)."""

    __slots__ = ("samples", "fcfg", "entry", "feats")

    def __init__(self, samples, fcfg, entry):
        self.samples = samples
        self.fcfg = fcfg
        self.entry = entry
        self.feats = None  # filled by the batch extraction pass


def open_speech_file(
    entry: str, cfg: Config, defer_frontend: bool = False
):
    """Open a data file as (features, samp_period, parm_kind, scp entry).

    The HParm OpenBuffer role: if SOURCEKIND is WAVEFORM the file is read
    as audio and converted per TARGETKIND; otherwise it is read as an HTK
    feature file (with optional segment selection from the scp entry).
    With defer_frontend=True a waveform source returns a DeferredWave
    (samples + frontend config) instead — see compute_features_batch.
    """
    e = parse_scp_entry(entry)
    src_kind = cfg.str_("SOURCEKIND", "ANON", module="HPARM").upper()
    if src_kind == "HAUDIO":
        # live capture (HParm live buffer): pull the audio source dry,
        # then convert like a waveform file. The scp entry (if any)
        # overrides HAUDIO:AUDIOSOURCE as the replay file — HCopy's
        # "record then convert" live mode.
        from ..io.audio import open_audio_input

        src = open_audio_input(
            cfg, fname=(e.physical if e.physical else None))
        src.start()
        parts = []
        while (c := src.read(16000)) is not None:
            parts.append(c)
        src.stop()
        samples = np.concatenate(parts) if parts else np.zeros(0, np.int16)
        fcfg = FrontendConfig.from_config(cfg, src.samp_period)
        feats = compute_features(samples.astype(np.float32), fcfg)
        period = int(fcfg.target_rate)
        return (feats, period,
                fcfg.target_kind & ~(pk.HASCOMPX | pk.HASCRCC), e)
    src_fmt_c = (cfg.str_("SOURCEFORMAT", "HTK", module="HWAVE") or "HTK").upper()
    # HShell xxFILTER channels: feature reads go through HPARMFILTER,
    # waveform reads through HWAVEFILTER — only the channel actually
    # opened runs its filter (HShell.c FOpen channel table), so a
    # configured parm filter never touches (or breaks on) raw audio
    from ..utils.filters import cleanup, maybe_filter

    ppath = ptmp = None
    wtmp = None

    def parm_path():
        nonlocal ppath, ptmp
        if ppath is None:
            ppath, ptmp = maybe_filter(e.physical, "HPARMFILTER", cfg)
        return ppath

    try:
        if src_kind == "ANON":
            # HTK's ANON: take the kind from the file itself. For
            # HTK-format files peek at the 12-byte header; non-HTK audio
            # formats imply WAVEFORM. Peek the raw bytes first; if they
            # don't parse as an HTK header, retry through HPARMFILTER
            # (the file may be stored compressed).
            src_kind = "WAVEFORM"
            if src_fmt_c == "HTK":
                for path_fn in (lambda: e.physical, parm_path):
                    try:
                        with open(path_fn(), "rb") as f:
                            hdr = f.read(12)
                        kind_code = int(
                            np.frombuffer(hdr[10:12], dtype=">i2")[0])
                        src_kind = pk.BASE_KINDS[pk.base_kind(kind_code)]
                        break
                    except Exception:
                        continue
        if pk.base_kind(pk.str2parmkind(src_kind)) == pk.BASE_KINDS.index("WAVEFORM"):
            src_fmt = cfg.str_("SOURCEFORMAT", "HTK", module="HWAVE") or "HTK"
            src_rate = cfg.int_("SOURCERATE", 0, module="HWAVE") or cfg.int_(
                "SOURCERATE", 0, module="HPARM"
            )
            wpath, wtmp = maybe_filter(e.physical, "HWAVEFILTER", cfg)
            wv = read_wave(wpath, fmt=src_fmt, source_rate=src_rate or None)
            samples = wv.samples
            if e.start is not None:
                samples = samples[e.start : e.end + 1]
            fcfg = FrontendConfig.from_config(cfg, wv.samp_period)
            if defer_frontend:
                return DeferredWave(samples, fcfg, e)
            feats = compute_features(samples, fcfg)
            period = int(fcfg.target_rate)
            return feats, period, fcfg.target_kind & ~(pk.HASCOMPX | pk.HASCRCC), e
        if src_fmt_c in ("ESIG", "ESIGNAL"):
            # ESIG feature file: no HTK parm kind in the container, so the
            # kind comes from SOURCEKIND (USER when unspecified), as HParm
            # requires for Entropic inputs
            from ..io.esignal import read_esig

            ef = read_esig(parm_path())
            data = ef.data.astype(np.float32)
            if e.start is not None:
                data = data[e.start : e.end + 1]
            kind = pk.str2parmkind(
                src_kind if src_kind not in ("ANON", "WAVEFORM") else "USER")
            return data, ef.samp_period or 100000, kind, e
        ff = read_htk_file(parm_path())
        data = ff.data
        if e.start is not None:
            data = data[e.start : e.end + 1]
        return data, ff.samp_period, ff.parm_kind & ~(pk.HASCOMPX | pk.HASCRCC), e
    finally:
        cleanup(ptmp)
        cleanup(wtmp)


def preload_corpus(entries: List[str], cfg: Config) -> dict:
    """Batch-load `_C`-compressed HTK feature corpora natively.

    Returns {entry: (data, period, kind, scp_entry)} for the files it
    covered; callers fall through to open_speech_file for the rest
    (waves, uncompressed floats — where numpy's SIMD byteswap already
    wins — segment-sliced entries, filters, ESIG). The
    `HTKLib/HParm.c : OpenBuffer` role at corpus scale: one C call
    decompresses a whole chunk (native/htkio.cpp, ~2x on compressed
    corpora).
    """
    out: dict = {}
    if cfg is None or cfg.str_("HPARMFILTER", None):
        return out
    if cfg.str_("SOURCEKIND", "ANON", module="HPARM").upper() != "ANON":
        return out
    if (cfg.str_("SOURCEFORMAT", "HTK", module="HWAVE") or
            "HTK").upper() != "HTK":
        return out
    from ..native import load_corpus_batch

    groups: dict = {}
    seen: set = set()
    budget = 2 << 30  # cap resident decompressed features at ~2 GB;
    # everything past the cap streams through open_speech_file as before
    for ent in entries:
        if ent in seen or not isinstance(ent, str):
            continue
        seen.add(ent)
        if budget <= 0:
            continue
        e = parse_scp_entry(ent)
        if e.start is not None:
            continue
        try:
            with open(e.physical, "rb") as f:
                hdr = f.read(12)
        except OSError:
            continue
        if len(hdr) < 12:
            continue
        n = int(np.frombuffer(hdr[:4], dtype=">i4")[0])
        samp_size = int(np.frombuffer(hdr[8:10], dtype=">i2")[0])
        kind = int(np.frombuffer(hdr[10:12], dtype=">i2")[0])
        try:
            base = pk.base_kind(kind)
        except Exception:
            continue
        if base in (pk.BASE_KINDS.index("WAVEFORM"),
                    pk.BASE_KINDS.index("IREFC"),
                    pk.BASE_KINDS.index("DISCRETE")):
            continue
        if not pk.has_qual(kind, pk.HASCOMPX) or samp_size <= 0 or n <= 4:
            continue
        width = samp_size // 2
        budget -= n * width * 4
        groups.setdefault(width, []).append((ent, e, n))

    CHUNK = 512
    for width, items in groups.items():
        for i0 in range(0, len(items), CHUNK):
            chunk = items[i0 : i0 + CHUNK]
            max_frames = max(n for _ent, _e, n in chunk)
            got = load_corpus_batch([c[1].physical for c in chunk],
                                    max_frames, width)
            if got is None:
                return out  # no native library: caller's slow path
            arena, frames, periods, kinds = got
            for k, (ent, e, _n) in enumerate(chunk):
                if frames[k] < 0:
                    continue  # damaged file: open_speech_file reports it
                out[ent] = (
                    np.ascontiguousarray(arena[k, : int(frames[k])]),
                    int(periods[k]),
                    int(kinds[k]) & ~(pk.HASCOMPX | pk.HASCRCC),
                    e,
                )
    return out
