"""HRest — isolated-unit Baum-Welch reestimation.

Mirrors `HTKTools/HRest.c`: repeated full Baum-Welch over one model's
training segments (the single-model form of HERest's embedded pass),
iterating until the total log-likelihood converges. Reuses the same
device FB scans via a one-model composite.

Usage: HRest [options] hmmFile trainFiles...

  -l label  use only segments with this label    -o name  output name
  -i N      max iterations (default 20)          -v f     min variance
  -e f      convergence epsilon (default 1e-4)   -M dir   output dir
  -u tmvw   update flags
  -I mlf / -L dir / -X ext   transcription sources
  Standard: -A -C -D -S -T -V
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ..algo.reestimate import UpdateFlags, reestimate
from ..algo.trainer import Trainer, prepare_utterance
from ..io.mlf import MLF
from ..io.mmf import load_mmf, save_mmf
from ..models.hmmset import compile_hmmset, write_back
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError
from .hinit import collect_segments

USAGE = "Usage: HRest [options] hmmFile trainFiles..."

OPTS = {
    "l": Option("l", 1, "segment label"),
    "o": Option("o", 1, "output hmm name"),
    "i": Option("i", 1, "max iterations", typ=int),
    "v": Option("v", 1, "minimum variance", typ=float),
    "e": Option("e", 1, "convergence epsilon", typ=float),
    "M": Option("M", 1, "output directory"),
    "I": Option("I", 1, "input MLF", repeatable=True),
    "L": Option("L", 1, "label directory"),
    "X": Option("X", 1, "label extension"),
    "u": Option("u", 1, "update flags"),
    "m": Option("m", 1, "min examples", typ=int),
}


def run(argv: List[str]) -> int:
    ta = parse_args("HRest", argv, OPTS, min_args=1, usage=USAGE)
    cfg = ta.config
    hmm_file = ta.args[0]
    files = ta.script + ta.args[1:]
    if not files:
        HError(1030, "HRest: no training files\n%s", USAGE)

    hset = load_mmf(hmm_file, cfg=ta.config)
    name = next(iter(hset.hmms))
    flags = UpdateFlags.parse(ta.get("u", "tmvw"))
    min_var = float(ta.get("v", 1e-6) or 1e-6)
    max_iter = int(ta.get("i", 20) or 20)
    eps = float(ta.get("e", 1e-4) or 1e-4)

    mlfs = [MLF.load(p, ta.config) for p in ta.get_all("I")]
    segs = collect_segments(files, cfg, ta.get("l"), mlfs, ta.get("L"),
                            ta.get("X", "lab"), None)
    n_emit = hset.hmms[name].nstates - 2
    segs = [s for s in segs if s.shape[0] >= n_emit]
    if not segs:
        HError(2221, "HRest: no usable training segments")

    var_floor = hset.macros["v"].get("varFloor1")
    prev = None
    for it in range(max_iter):
        comp = compile_hmmset(hset)
        trainer = Trainer(comp)
        utts = [
            prepare_utterance(comp, f"seg{i}", seg, [name])
            for i, seg in enumerate(segs)
        ]
        accs = trainer.accumulate(utts, batch_size=8)
        total = float(np.asarray(accs.total_logp))
        if ta.trace:
            print(f"HRest: iter {it + 1} total logP {total:.3f}")
        m, v, w, t = reestimate(comp, accs, flags, var_floor=var_floor,
                                min_var=min_var)
        write_back(comp, means=m, variances=v, weights=w, transps=t)
        if prev is not None and abs(total - prev) <= eps * abs(prev):
            break
        prev = total

    out_name = ta.get("o", name)
    h = hset.hmms[name]
    if out_name != name:
        h.name = out_name
        hset.hmms = {out_name: h}
        hset.macros["h"] = {out_name: h}
    out_dir = ta.get("M", ".")
    os.makedirs(out_dir, exist_ok=True)
    save_mmf(hset, os.path.join(out_dir, out_name), binary=ta.binary)
    if ta.trace:
        print(f"HRest: saved {os.path.join(out_dir, out_name)}")
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
