"""HList — list the contents of speech files.

Mirrors `HTKTools/HList.c`: prints the source header, the target (post-
conversion) header with -t, and observation values. Options:

  -h      print header(s) only
  -t      also print the target header (after HParm conversion)
  -z      suppress observation printing (headers only, alias of -h)
  -i N    items per line (default 10)
  -s f    start frame   -e f  end frame
  Standard: -A -C -D -S -T -V
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..io import parmkind as pk
from ..utils.cli import Option, parse_args, tool_main
from ._common import open_speech_file

USAGE = "Usage: HList [options] file ..."

OPTS = {
    "h": Option("h", 0, "print header only"),
    "t": Option("t", 0, "print target header"),
    "z": Option("z", 0, "suppress observation printing"),
    "i": Option("i", 1, "items per line", typ=int),
    "s": Option("s", 1, "start frame", typ=int),
    "e": Option("e", 1, "end frame", typ=int),
}


def _source_header(path: str) -> Optional[Tuple[int, int, int, int]]:
    """Best-effort raw HTK header peek: (nSamples, period, sampBytes, kind).

    Returns None when the file is not a plausible HTK feature/wave file
    (e.g. RIFF/NIST audio), in which case the caller reports the format
    from config instead."""
    try:
        with open(path, "rb") as f:
            hdr = f.read(12)
        if len(hdr) != 12 or hdr[:4] in (b"RIFF", b"NIST", b"FORM", b".snd"):
            return None
        ns = int(np.frombuffer(hdr[0:4], dtype=">i4")[0])
        period = int(np.frombuffer(hdr[4:8], dtype=">i4")[0])
        sbytes = int(np.frombuffer(hdr[8:10], dtype=">i2")[0])
        kind = int(np.frombuffer(hdr[10:12], dtype=">i2")[0])
        if ns <= 0 or period <= 0 or sbytes <= 0:
            return None
        pk.parmkind2str(kind)  # raises on nonsense -> not an HTK header
        return ns, period, sbytes, kind
    except Exception:
        return None


def _print_block(title: str, n: int, sbytes: int, period: int, kind: str,
                 fmt: str) -> None:
    print(
        f"{title}\n"
        f"  Num Samples: {n:>10}   File Format: {fmt}\n"
        f"  Sample Bytes: {sbytes:>9}   Sample Kind: {kind}\n"
        f"  Sample Period: {period / 10.0:>8.1f} us"
    )


def run(argv: List[str]) -> int:
    ta = parse_args("HList", argv, OPTS, usage=USAGE)
    files = ta.script + ta.args
    per_line = int(ta.get("i", 10) or 10)
    for fn in files:
        data, period, kind, e = open_speech_file(fn, ta.config)
        n, w = data.shape
        print("-" * 72)
        # the Source header block reads the file directly, so the HParm
        # input filter applies here too (gzipped corpora etc.)
        from ..utils.filters import filtered

        with filtered(e.physical, "HPARMFILTER", ta.config) as phys:
            try:
                with open(phys, "rb") as fh:
                    is_esig = fh.read(7) == b"Esignal"
            except OSError:
                is_esig = False
            src = None if is_esig else _source_header(phys)
            if is_esig:
                from ..io.esignal import read_esig

                ef = read_esig(phys)
        if is_esig:
            width = 2 if ef.dtype_name == "SHORT" else 4
            _print_block(f"Source: {e.logical}", ef.data.shape[0],
                         ef.data.shape[1] * width, ef.samp_period or period,
                         ef.dtype_name, "ESIG")
        elif src is not None:
            sn, sp, sb, sk = src
            _print_block(f"Source: {e.logical}", sn, sb, sp,
                         pk.parmkind2str(sk), "HTK")
        else:
            fmt = (ta.config.str_("SOURCEFORMAT", "HTK", module="HWAVE")
                   or "HTK").upper()
            _print_block(f"Source: {e.logical}", n, 2, period,
                         "WAVEFORM", fmt)
        converted = src is None or pk.base_kind(src[3]) != pk.base_kind(kind)
        if ta.has("t") or (converted and not ta.has("h")):
            _print_block("Target", n, w * 4, period, pk.parmkind2str(kind),
                         "HTK")
        if not (ta.has("h") or ta.has("z")):
            s = int(ta.get("s", 0) or 0)
            last = int(ta.get("e", n - 1) if ta.has("e") else n - 1)
            for t in range(s, min(last + 1, n)):
                row = data[t]
                print(f"{t:5d}: ", end="")
                for j in range(0, w, per_line):
                    if j:
                        print(" " * 8, end="")
                    print(" ".join(f"{v:8.3f}" for v in row[j : j + per_line]))
    print("-" * 72)
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
