"""HNTrainSGD — DNN training by stochastic gradient descent.

Mirrors `HTKTools/HNTrainSGD.c` (v3.5): trains a feed-forward net to
predict tied-state posteriors with frame cross-entropy. Targets come from
forced alignment of the transcriptions against the GMM-HMM set (state
level), computed internally (HTK feeds pre-aligned MLFs; both flows give
frame-state targets).

Usage: HNTrainSGD [options] hmmList trainFiles...

  -H mmf    GMM-HMM set (state inventory + alignment)   (repeatable)
  -N ann    input ANN file (continue training); else a net is initialised
  -M dir    output dir (writes 'ann')
  -I mlf    phone transcriptions for alignment  -L/-X  label dir/ext
  Config (HNTRAINSGD module): LEARNRATE, MOMENTUM, MINIBATCHSIZE,
  MAXEPOCHNUM, LRSCHEDULER (NEWBOB/EXPDECAY/LIST/ADAGRAD/FIXED),
  LRVALUES (per-epoch rates for LIST), ADAGRADK, HIDDENSIZE (e.g.
  "512 512"), CONTEXT, ACTIVATION, WEIGHTDECAY (L2 added to the
  gradients), GRADCLIP (elementwise clamp), CRITERION (CE | MMI — MMI runs
  phone-loop-denominator sequence-discriminative fine-tuning after the
  CE pass; SEQITERS / SEQLEARNRATE control it)
  Standard: -A -C -D -S -T -V
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ..algo.composite import build_composite
from ..algo.nnet import SGDConfig, make_cache, train_ann
from ..algo.viterbi import align
from ..io.mlf import MLF, find_labels
from ..io.mmf import load_hmm_list, load_mmf
from ..models.ann import init_ann, load_ann, save_ann
from ..models.hmmset import compile_hmmset
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError, HRError
from ._common import (open_speech_file,
                      preload_corpus)

USAGE = "Usage: HNTrainSGD [options] hmmList trainFiles..."

OPTS = {
    "H": Option("H", 1, "GMM-HMM MMF", repeatable=True),
    "N": Option("N", 1, "input ANN file"),
    "M": Option("M", 1, "output directory"),
    "I": Option("I", 1, "input MLF", repeatable=True),
    "L": Option("L", 1, "label dir"),
    "X": Option("X", 1, "label ext"),
    "e": Option("e", 1, "epochs", typ=int),
}


def state_targets(comp, utt_feats, names_list, trace=0):
    """Forced-align each utterance -> per-frame physical-state targets."""
    targets = []
    for feats, names in zip(utt_feats, names_list):
        hmm = build_composite(comp, [comp.model_id(n) for n in names])
        res = align(comp, hmm, feats)
        targets.append(hmm.comp_state[res.states].astype(np.int32))
    return targets


def run(argv: List[str]) -> int:
    ta = parse_args("HNTrainSGD", argv, OPTS, min_args=1, usage=USAGE)
    cfg = ta.config
    files = ta.script + ta.args[1:]
    if not files:
        HError(1030, "HNTrainSGD: no training files\n%s", USAGE)
    mmfs = ta.get_all("H")
    if not mmfs:
        HError(1030, "HNTrainSGD: -H mmf required (state inventory)")
    hset = load_mmf(mmfs, cfg=ta.config)
    load_hmm_list(ta.args[0], ta.config)
    comp = compile_hmmset(hset)

    mlfs = [MLF.load(p, ta.config) for p in ta.get_all("I")]
    utt_feats = []
    names_list = []
    pre = preload_corpus(files, cfg)
    for fn in files:
        data, _p, _k, e = pre.get(fn) or open_speech_file(fn, cfg)
        tr = find_labels(e.logical, mlfs, ta.get("L"), ta.get("X", "lab"))
        names = [l.name for l in tr.labels]
        if not names:
            HRError(7325, "HNTrainSGD: empty transcription for %s", e.logical)
            continue
        utt_feats.append(data)
        names_list.append(names)
    if not utt_feats:
        HError(7326, "HNTrainSGD: no trainable utterances")

    m = "HNTRAINSGD"
    context = cfg.int_("CONTEXT", 4, module=m)
    if ta.has("N"):
        ann = load_ann(ta.get("N"))
        context = ann.context
    else:
        hidden = [int(h) for h in
                  (cfg.str_("HIDDENSIZE", "512", module=m) or "512").split()]
        ann = init_ann(
            "dnn1", in_dim=utt_feats[0].shape[1], hidden=hidden,
            out_dim=comp.n_states, context=context,
            activation=cfg.str_("ACTIVATION", "SIGMOID", module=m),
        )
    ann.target_names = [f"S{i}" for i in range(comp.n_states)]

    if ta.trace:
        print(f"HNTrainSGD: aligning {len(utt_feats)} utterances "
              f"for state targets")
    targets = state_targets(comp, utt_feats, names_list, ta.trace)
    x, y = make_cache(utt_feats, targets, context)
    if ta.trace:
        print(f"HNTrainSGD: {x.shape[0]} frames, input dim {x.shape[1]}, "
              f"{comp.n_states} targets")

    lr_values = cfg.str_("LRVALUES", None, module=m)
    scfg = SGDConfig(
        lr=cfg.flt_("LEARNRATE", 0.002, module=m),
        momentum=cfg.flt_("MOMENTUM", 0.5, module=m),
        batch_size=cfg.int_("MINIBATCHSIZE", 256, module=m),
        n_epochs=int(ta.get("e", cfg.int_("MAXEPOCHNUM", 10, module=m))
                     or 10),
        scheduler=(cfg.str_("LRSCHEDULER", "NEWBOB", module=m) or "NEWBOB").upper(),
        lr_list=([float(v) for v in lr_values.split()] if lr_values else None),
        adagrad_k=cfg.flt_("ADAGRADK", 1.0, module=m),
        frame_rand=cfg.bool_("FRAMERAND", True, module=m),
        weight_decay=cfg.flt_("WEIGHTDECAY", 0.0, module=m) or 0.0,
        grad_clip=cfg.flt_("GRADCLIP", 0.0, module=m) or 0.0,
    )
    train_ann(ann, x, y, scfg, trace=ta.trace)

    crit = (cfg.str_("CRITERION", "CE", module=m) or "CE").upper()
    if crit in ("MMI", "SEQUENCE"):
        # sequence-discriminative fine-tuning on top of the CE net:
        # phone-loop denominator MMI (HNTrainSGD.c sequence criterion)
        from ..algo.nnet import train_ann_sequence

        n_seq = cfg.int_("SEQITERS", 4, module=m)
        seq_lr = cfg.flt_("SEQLEARNRATE", scfg.lr * 0.1, module=m)
        scfg_seq = SGDConfig(lr=seq_lr, momentum=scfg.momentum,
                             batch_size=scfg.batch_size,
                             weight_decay=scfg.weight_decay,
                             grad_clip=scfg.grad_clip)
        if ta.trace:
            print(f"HNTrainSGD: MMI sequence training, {n_seq} iterations")
        _ann, objs = train_ann_sequence(ann, comp, utt_feats, names_list,
                                        scfg_seq, n_iters=n_seq,
                                        trace=ta.trace)
        if ta.trace:
            print(f"HNTrainSGD: MMI objective {objs[0]:.2f} -> {objs[-1]:.2f}")

    out_dir = ta.get("M", ".")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "ann")
    save_ann(ann, out)
    if ta.trace:
        print(f"HNTrainSGD: saved {out}")
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
