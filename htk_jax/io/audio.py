"""Audio input sources (the HAudio role).

`HTKLib/HAudio.c` wraps the OS audio devices (OSS/ALSA/Win32) behind
OpenAudioInput / StartAudioInput / GetAIStatus / GetAudio so HParm's
streaming buffer and HVite's live mode can pull samples as they arrive.
Without a capture device, the rebuild keeps the same
source abstraction with two concrete sources:

  - FileReplayAudio — replays any HWave-readable file in chunks,
    optionally paced to real time (HAudio's replay path; also how live
    decoding is exercised headlessly and in tests);
  - ArrayAudio — an in-memory source for tests and embedding.

A real microphone backend would slot in as a third AudioSource without
touching the streaming frontend or decoder (they only see `read()`).

Config surface (module HAUDIO):
  SOURCERATE    sample period, 100 ns units (default 625 = 16 kHz)
  AUDIOSOURCE   file to replay when a tool runs in live mode with no
                capture device (this rebuild's documented stand-in for
                LINEIN/MICIN)
  REALTIME      T = pace `read()` to the audio clock (default F)
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..utils.config import Config
from ..utils.errors import HError
from .wavefile import read_wave


class AudioSource:
    """Abstract chunked audio input (HAudio's AudioIn role).

    Protocol: start() -> repeated read(n) -> None when exhausted.
    """

    samp_period: int = 625  # 100 ns units

    def start(self) -> None:  # StartAudioInput
        pass

    def stop(self) -> None:  # StopAudioInput
        pass

    def read(self, n: int) -> Optional[np.ndarray]:
        """Up to n int16 samples, or None once the source is exhausted."""
        raise NotImplementedError


class ArrayAudio(AudioSource):
    def __init__(self, samples: np.ndarray, samp_period: int = 625):
        self._x = np.asarray(samples, np.int16)
        self._pos = 0
        self.samp_period = int(samp_period)

    def read(self, n: int) -> Optional[np.ndarray]:
        if self._pos >= len(self._x):
            return None
        out = self._x[self._pos : self._pos + n]
        self._pos += len(out)
        return out


def _sniff_format(path: str) -> str:
    """Magic-number format detection for replay convenience.

    HWave proper is config-driven (SOURCEFORMAT) with no sniffing; the
    replay device sniffs the common self-describing containers so tests
    and live demos don't need a config file, and falls back to HTK.
    """
    with open(path, "rb") as f:
        head = f.read(12)
    if head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        return "WAV"
    if head[:4] == b"NIST":
        return "NIST"
    if head[:4] == b"FORM":
        return "AIFF"
    if head[:4] == b".snd":
        return "SUNAU8"
    return "HTK"


class FileReplayAudio(AudioSource):
    """Replay a waveform file as a live source (HAudio replay path)."""

    def __init__(self, path: str, fmt: Optional[str] = None,
                 realtime: bool = False):
        w = read_wave(path, fmt=fmt or _sniff_format(path))
        self._x = w.samples
        self._pos = 0
        self.samp_period = int(w.samp_period)
        self._realtime = realtime
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.monotonic()

    def read(self, n: int) -> Optional[np.ndarray]:
        if self._pos >= len(self._x):
            return None
        if self._realtime and self._t0 is not None:
            # don't hand out samples ahead of the audio clock
            due = self._pos * self.samp_period * 1e-7
            lag = due - (time.monotonic() - self._t0)
            if lag > 0:
                time.sleep(lag)
        out = self._x[self._pos : self._pos + n]
        self._pos += len(out)
        return out


def open_audio_input(cfg: Config, fname: Optional[str] = None) -> AudioSource:
    """OpenAudioInput: build the configured audio source.

    `fname` overrides HAUDIO:AUDIOSOURCE (e.g. a tool's replay argument).
    With neither set there is no capture hardware to open — HError 6106,
    matching HAudio.c's "cannot open audio" failure mode.
    """
    m = "HAUDIO"
    src = fname or cfg.str_("AUDIOSOURCE", "", module=m)
    if not src:
        HError(6106, "open_audio_input: no audio device on this host; "
                     "set HAUDIO:AUDIOSOURCE = <file> to replay a file")
    realtime = cfg.bool_("REALTIME", False, module=m)
    fmt = cfg.str_("SOURCEFORMAT", "", module=m) or None
    return FileReplayAudio(src, fmt=fmt, realtime=realtime)
