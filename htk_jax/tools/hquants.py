"""HQuants — VQ codebook construction.

Mirrors `HTKTools/HQuants.c`: clusters training frames into a VQ codebook
(k-means / LBG-style) and writes a VQ table file for DISCRETE/_V systems.

Usage: HQuants [options] vqFile trainFiles...

  -n s N   codebook size N for stream s (default 256 for stream 1)
  -s S     number of streams (default 1; streams split the vector evenly)
  -t       tree codebook (accepted; linear built — see io/vq.py)
  Standard: -A -C -D -S -T -V
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..algo.kmeans import kmeans
from ..io.vq import VQTable, save_vq
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError
from ._common import open_speech_file

USAGE = "Usage: HQuants [options] vqFile trainFiles..."

OPTS = {
    "n": Option("n", 2, "stream codebook size", typ=int, repeatable=True),
    "s": Option("s", 1, "number of streams", typ=int),
    "t": Option("t", 0, "tree codebook (accepted)"),
}


def run(argv: List[str]) -> int:
    ta = parse_args("HQuants", argv, OPTS, min_args=1, usage=USAGE)
    cfg = ta.config
    vq_file = ta.args[0]
    files = ta.script + ta.args[1:]
    if not files:
        HError(1030, "HQuants: no training files\n%s", USAGE)

    n_streams = int(ta.get("s", 1) or 1)
    sizes = {1: 256}
    for s, n in ta.get_all("n"):
        sizes[int(s)] = int(n)

    data = []
    for fn in files:
        feats, _p, _k, e = open_speech_file(fn, cfg)
        data.append(feats)
    x = np.concatenate(data).astype(np.float64)
    D = x.shape[1]
    if D % n_streams:
        HError(5820, "HQuants: width %d not divisible into %d streams",
               D, n_streams)
    sw = D // n_streams

    codebooks = []
    for s in range(n_streams):
        k = sizes.get(s + 1, 256)
        xs = x[:, s * sw : (s + 1) * sw]
        _assign, means = kmeans(xs, min(k, len(xs)), iters=15)
        codebooks.append(means.astype(np.float32))
        if ta.trace:
            print(f"HQuants: stream {s + 1}: {means.shape[0]} codewords")
    save_vq(VQTable(codebooks=codebooks), vq_file)
    if ta.trace:
        print(f"HQuants: wrote {vq_file}")
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
