"""HVite — Viterbi word recognition and forced alignment.

Mirrors `HTKTools/HVite.c` (SURVEY.md §3.3): recognition mode expands a
word network (-w SLF) with the dictionary and HMM set and decodes each
utterance with the token-passing scan (algo/decode); alignment mode (-a)
builds a composite HMM from each utterance's word transcription (expanded
through the dictionary) and runs the max-plus alignment scan
(algo/viterbi), emitting phone- or word-level label files.

Usage: HVite [options] dictFile hmmList testFiles...

  -w netfile  recognition from word network (SLF)
  -a          align from word transcriptions (-I mlf)
  -m          output model (phone) alignment with times
  -s f        grammar/LM scale factor          -p f  word insertion penalty
  -r f        pronunciation scale (accepted)
  -i mlf      output recognised/aligned labels to MLF
  -l dir / -y ext   output label dir / extension
  -H mmf      load HMM macro file (repeatable)
  -I mlf      input word-level MLF (alignment)  -L/-X  input label dir/ext
  -t f        genBeam: recognition tokens below (best - f) die each frame
              (HRec semantics; traced operand, no recompiles). Alignment
              mode stays exact (beams can only lose the forced path).
  -u i        max active models (histogram/top-A pruning analogue)
  -b word     boundary word inserted around alignment (e.g. silence)
  -z ext      write word lattices (one recursion shared with the 1-best)
  -n N M      N-best output from the lattice
  -J dir      input transform dir (repeatable; per-speaker chains compose,
              a "global" TMF acts as the parent transform)
  -h mask     speaker mask for -J selection     -k  use input transforms
  -N annfile  hybrid decoding with ANN state posteriors
  -T n        trace

Config: HNET: FORCECXTEXP/ALLOWXWRDEXP (cross-word triphone expansion),
HREC: LATTICEBEAM, DECODEBATCH (recognition batch size, default 8).
Plain recognition batches utterances through one decode kernel launch
per length bucket; adaptation with model-space transforms, lattices,
n-best, hybrid and discrete modes run per utterance.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..algo.composite import build_composite
from ..algo.decode import decode
from ..algo.net import compile_network
from ..algo.viterbi import align
from ..io.dictionary import read_dict
from ..io.mlf import MLF, Label, Transcription, find_labels, save_label_file
from ..io.mmf import load_hmm_list, load_mmf
from ..io.slf import read_slf
from ..models.hmmset import compile_hmmset
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError, HRError
from ._common import (open_speech_file, preload_corpus,
                      outp_precision)

USAGE = "Usage: HVite [options] dictFile hmmList testFiles..."

OPTS = {
    "w": Option("w", 1, "recognise from network"),
    "a": Option("a", 0, "align from label files"),
    "m": Option("m", 0, "output model alignment"),
    "s": Option("s", 1, "LM scale", typ=float),
    "p": Option("p", 1, "word penalty", typ=float),
    "r": Option("r", 1, "pron scale", typ=float),
    "i": Option("i", 1, "output MLF"),
    "l": Option("l", 1, "output label dir"),
    "y": Option("y", 1, "output label ext"),
    "H": Option("H", 1, "load MMF", repeatable=True),
    "I": Option("I", 1, "input MLF", repeatable=True),
    "L": Option("L", 1, "input label dir"),
    "X": Option("X", 1, "input label ext"),
    "t": Option("t", 1, "genBeam pruning threshold", typ=float),
    "u": Option("u", 1, "max active models", typ=int),
    "b": Option("b", 1, "boundary word"),
    "o": Option("o", 1, "output format flags: N normalise scores, "
                "S no scores, T no times, W no words (-m), M no models"),
    "n": Option("n", 2, "n-best (accepted)", typ=int),
    "z": Option("z", 1, "output lattices with this extension"),
    "q": Option("q", 1, "lattice output format flags (accepted)"),
    "J": Option("J", 1, "input transform dir", repeatable=True),
    "k": Option("k", 0, "use input transforms"),
    "h": Option("h", 1, "speaker mask (accepted; global transform)"),
    "N": Option("N", 1, "ANN file for hybrid decoding"),
}

FRAME_100NS = 100000  # 10ms frames in 100ns units (from TARGETRATE)


def _out_label_path(logical: str, out_dir: Optional[str], ext: str) -> str:
    stem = os.path.splitext(os.path.basename(logical))[0]
    name = f"{stem}.{ext}"
    return os.path.join(out_dir, name) if out_dir else name


def run(argv: List[str]) -> int:
    ta = parse_args("HVite", argv, OPTS, min_args=2, usage=USAGE)
    gen_beam = float(ta.get("t")) if ta.has("t") else None
    max_act = int(ta.get("u")) if ta.has("u") else None
    if ta.trace and (gen_beam is not None or max_act is not None):
        print(f"HVite: pruning genBeam={gen_beam} maxActive={max_act} "
              "(recognition scans; alignment stays exact)")
    cfg = ta.config
    prec = outp_precision(cfg)
    dict_file, hmm_list_file = ta.args[0], ta.args[1]
    files = ta.script + ta.args[2:]
    # HVite live mode (HVite.c with SOURCEKIND = HAUDIO and no files):
    # samples stream from the audio source through the incremental
    # frontend and decoder instead of per-file batch processing.
    src_kind = (cfg.str_("SOURCEKIND", "", module="HPARM") or "").upper()
    live = not files and src_kind == "HAUDIO"
    if not files and not live:
        HError(1030, "HVite: no test files\n%s", USAGE)

    mmfs = ta.get_all("H")
    if not mmfs:
        HError(1030, "HVite: at least one -H mmf required")
    hset = load_mmf(mmfs, cfg=ta.config)
    comp = compile_hmmset(hset)

    # input adaptation transforms (-J dir): per-speaker TMFs selected by
    # the -h mask, or one global transform. MLLRMEAN transforms the model
    # means; CMLLR transforms incoming features. There is
    # one transform CHAIN per speaker: -J dirs are searched in order and
    # a speaker's transforms compose left-to-right (HAdapt parent/input
    # transform chaining: CMLLR chains on features, MLLR on the model)
    from ._xfcli import load_input_transforms, resolve_chain

    xforms = load_input_transforms(ta.get_all("J"), ta.trace, "HVite")
    spk_mask = ta.get("h")
    # -k: the model set's own ~a input transform (HHEd XF) becomes the
    # base of every utterance's chain
    base_xf = None
    if ta.has("k") and hset.input_xform:
        from ..algo.adapt import load_tmf_text

        _bnm, base_xf = load_tmf_text(hset.input_xform)
        if ta.trace:
            print(f"HVite: using MMF input transform ({base_xf.kind})")
        if not xforms:
            xforms = {"global": [base_xf]}
            base_xf = None
    base_means = comp.means.copy() if xforms else None
    base_vars = comp.variances.copy() if xforms else None
    base_gconsts = comp.gconsts.copy() if xforms else None
    # a set that loaded full-covariance (as opposed to one a transform
    # promotes to the FULLC scorer below) adapts means only: MLLRMEAN
    # moves fc_mu, CMLLR stays in feature space, and anything that would
    # re-Cholesky against the placeholder diagonal variances is refused
    native_fc = bool(comp.full_cov) and bool(xforms)
    if native_fc:
        for chain in xforms.values():
            for x in chain:
                bad = ((x[1] and x[1][0].kind == "CMLLR")
                       or any(y.var_scale is not None for y in x[1])
                       ) if isinstance(x, tuple) else (
                           x.kind == "MLLRCOV" or x.var_scale is not None)
                if bad:
                    HError(7450, "HVite: full-covariance sets adapt with "
                                 "MLLRMEAN (model) and plain CMLLR "
                                 "(feature) transforms only")

    def _has_model_xf(chain):
        return any(isinstance(x, tuple)
                   or x.kind in ("MLLRMEAN", "MLLRCOV") for x in chain)

    def _has_var_xf(chain):
        return any((any(y.var_scale is not None for y in x[1])
                    if isinstance(x, tuple) else x.var_scale is not None)
                   for x in chain)

    any_model_xf = any(_has_model_xf(c) for c in xforms.values())
    # if any speaker scales variances, every speaker must write them back
    # (else the next speaker would inherit the previous one's scaling)
    any_var_xf = any(_has_var_xf(c) for c in xforms.values())

    def adapt_for(logical, data):
        """Apply this utterance's transform chain; returns the data."""
        if not xforms:
            return data
        from ..algo.adapt import (apply_mllr_classes,
                                  apply_mllr_classes_vars)
        from ..models.hmmset import write_back

        # -h given: always resolve the speaker, even with one TMF loaded —
        # a single speaker-specific TMF must not silently apply to other
        # speakers' utterances (_xfcli.resolve_chain)
        chain = resolve_chain(xforms, spk_mask, logical, "HVite")
        if base_xf is not None:
            chain = [base_xf] + list(chain)
        cur_m, cur_v = base_means, base_vars
        vars_touched = False
        cov_xf = None
        cmllr_cls = None
        for xf in chain:
            if isinstance(xf, tuple):  # regression-class MLLR/CMLLR set
                _nm, xfs, c2x, classes = xf
                if xfs and xfs[0].kind == "CMLLR":
                    cmllr_cls = xf  # model-space constrained, applied last
                    continue
                if any(x.var_scale is not None for x in xfs):
                    cur_v = apply_mllr_classes_vars(
                        comp, cur_v, xfs, c2x, classes)
                    vars_touched = True
                cur_m = apply_mllr_classes(comp, cur_m, xfs, c2x, classes)
            elif xf.kind == "MLLRMEAN":
                cur_m = xf.apply_to_means(cur_m)
                if xf.var_scale is not None:
                    cur_v = xf.apply_to_vars(cur_v)
                    vars_touched = True
            elif xf.kind == "MLLRCOV":
                cov_xf = xf  # full variance transform, applied last
            else:  # CMLLR: feature space
                data = xf.apply_to_features(data).astype(data.dtype)
        if native_fc:
            # full-covariance set: MLLRMEAN means project through the
            # compiled precision Cholesky (covariances untouched, so
            # fc_proj/gConsts stay); cur_m falls back to base_means for
            # a speaker with a feature-only chain, restoring the set
            if any_model_xf:
                from ..algo.adapt import fc_mu_from_means

                comp.means = cur_m.astype(np.float32)
                comp.fc_mu = fc_mu_from_means(comp, cur_m)
            return data
        # drop any previous speaker's full-cov override first so
        # write_back's diagonal guard and gconsts stay consistent
        if comp.full_cov and base_gconsts is not None:
            comp.full_cov = False
            comp.fc_proj = comp.fc_mu = None
            comp.gconsts = base_gconsts.copy()
        if any_model_xf:
            # also restores canonical params after a previous speaker
            write_back(comp, means=cur_m,
                       variances=(cur_v if (vars_touched or any_var_xf)
                                  else None))
        if cov_xf is not None:
            from ..algo.adapt import apply_mllrcov

            fc_proj, fc_mu, gc = apply_mllrcov(
                comp, cov_xf, means=cur_m,
                variances=(cur_v if vars_touched else None))
            comp.fc_proj, comp.fc_mu, comp.gconsts = fc_proj, fc_mu, gc
            comp.full_cov = True
        elif cmllr_cls is not None:
            from ..algo.adapt import apply_cmllr_classes_fc

            _nm, xfs, c2x, classes = cmllr_cls
            fc_proj, fc_mu, gc = apply_cmllr_classes_fc(
                comp, xfs, c2x, classes, means=cur_m)
            comp.fc_proj, comp.fc_mu, comp.gconsts = fc_proj, fc_mu, gc
            comp.full_cov = True
        return data
    vocab = read_dict(dict_file, ta.config)
    load_hmm_list(hmm_list_file, ta.config)  # validated for parity; comp holds models

    lm_scale = float(ta.get("s", 1.0) or 1.0)
    word_pen = float(ta.get("p", 0.0) or 0.0)
    out_mlf_path = ta.get("i")
    out_dir = ta.get("l")
    out_ext = ta.get("y", "rec")
    period = int(cfg.flt_("TARGETRATE", 100000.0, module="HPARM"))

    out_mlf = MLF() if out_mlf_path else None
    # -o output-format flags (HVite.c -o): N normalise acoustic scores
    # by duration, S suppress scores, T suppress times, W suppress the
    # word tags in model alignment, M suppress model (phone) labels
    ofmt = (ta.get("o") or "").upper()
    sup_scores = "S" in ofmt
    sup_times = "T" in ofmt
    sup_words = "W" in ofmt
    sup_models = "M" in ofmt
    norm_scores = "N" in ofmt

    if ta.has("w"):
        from ..algo.net import word_internal_phone_map

        lat = read_slf(ta.get("w"), ta.config)
        # HNet.c config: FORCECXTEXP forces full cross-word context
        # expansion; ALLOWXWRDEXP permits it when the set is context-
        # dependent. CFPHONES (own key [LC]) lists transparent phones.
        force_x = cfg.bool_("FORCECXTEXP", False, module="HNET") or False
        allow_x = cfg.bool_("ALLOWXWRDEXP", False, module="HNET") or False
        has_cd = any("-" in n or "+" in n for n in comp.names)
        if force_x or (allow_x and has_cd):
            cfp = (cfg.str_("CFPHONES", "sp", module="HNET") or "sp").split()
            # HNet.c shares word interiors structurally; here sharing is
            # on whenever the outputs allow it (lattices/n-best need
            # whole-word nodes). HNET: SHAREINTERIORS = F disables.
            share = cfg.bool_("SHAREINTERIORS", True, module="HNET")
            share = (bool(share) and not ta.get("z")
                     and not ta.has("n"))
            net = compile_network(lat, vocab, comp, cross_word=True,
                                  cf_phones=cfp, share_interiors=share)
            if ta.trace and share:
                print("HVite: cross-word interiors shared "
                      f"({net.n_states} states)")
        else:
            pmap = word_internal_phone_map(comp.names)
            net = compile_network(lat, vocab, comp, phone_map=pmap)
        if ta.trace:
            print(
                f"HVite: network {net.n_nodes} nodes, {net.n_chains} chains, "
                f"{net.n_states} states"
            )
        if live:
            return _run_live(ta, cfg, net, comp, lm_scale, word_pen,
                             out_mlf, out_mlf_path, out_dir, out_ext,
                             period)
        lat_ext = ta.get("z")
        lat_beam = cfg.flt_("LATTICEBEAM", 200.0, module="HREC") or 200.0
        ann = None
        if ta.has("N"):
            from ..models.ann import load_ann

            ann = load_ann(ta.get("N"))
            if ta.trace:
                print(f"HVite: hybrid decoding with ANN {ta.get('N')}")
        # plain GMM recognition batches utterances through one kernel
        # launch per (length-sorted) bucket — identical results to the
        # per-utterance path (algo/decode.decode_batch, tested); paths
        # with per-utterance model state (adaptation, lattices, n-best,
        # hybrid, discrete) stay sequential
        feature_only_xf = bool(xforms) and not any_model_xf
        # -z lattices batch too: one scan per bucket yields the lattice
        # records AND the 1-best (generate_lattice_batch want_results;
        # uniform nets ride the compacted-record pipeline, general nets
        # the padded generic batch)
        batch_z = bool(lat_ext) and not ta.has("n")
        use_batch = ((not xforms or feature_only_xf)
                     and (not lat_ext or batch_z)
                     and not ta.has("n") and ann is None
                     and not comp.discrete and len(files) > 1)
        if use_batch:
            from ..algo.decode import decode_batch, generate_lattice_batch
            from ..io.slf import write_slf
            from ..utils.metrics import maybe_profile

            entries, featl = [], []
            pre = preload_corpus(files, cfg)
            for fn in files:
                data, _p, _k, e = (pre.get(fn)
                                   or open_speech_file(fn, cfg))
                entries.append(e)
                # feature-space (CMLLR) chains touch no model state, so
                # they batch fine — applied per utterance up front
                featl.append(np.asarray(adapt_for(e.logical, data)
                                        if xforms else data))
            order = sorted(range(len(featl)),
                           key=lambda i: featl[i].shape[0])
            results: List = [None] * len(featl)
            bsz = int(cfg.int_("DECODEBATCH", 8, module="HREC") or 8)
            with maybe_profile(cfg, "HVite"):
                for i0 in range(0, len(order), bsz):
                    idx = order[i0 : i0 + bsz]
                    if lat_ext:
                        prs = generate_lattice_batch(
                            net, comp, [featl[j] for j in idx],
                            lm_scale, word_pen, lattice_beam=lat_beam,
                            frame_period_s=period / 1e7, precision=prec,
                            beam=gen_beam, max_active=max_act,
                            want_results=True)
                        for j, (lt, r) in zip(idx, prs):
                            results[j] = r
                            if lt is not None:
                                stem = os.path.splitext(os.path.basename(
                                    entries[j].logical))[0]
                                lt.utterance = stem
                                write_slf(lt, os.path.join(
                                    out_dir or ".", f"{stem}.{lat_ext}"))
                    else:
                        rs = decode_batch(net, comp,
                                          [featl[j] for j in idx],
                                          lm_scale, word_pen,
                                          precision=prec,
                                          beam=gen_beam,
                                          max_active=max_act)
                        for j, r in zip(idx, rs):
                            results[j] = r
            # retry escalation (HFB.c ladder, decoder-side): a pruned-out
            # utterance re-decodes with the beam widened twice, then
            # unpruned, before "no tokens survived" is final
            if gen_beam is not None or max_act is not None:
                inc = cfg.flt_("PRUNERETRYINC", 200.0, module="HREC")
                for j, r in enumerate(results):
                    if r is not None:
                        continue
                    ladder = ([(gen_beam + inc, max_act),
                               (gen_beam + 2 * inc, max_act)]
                              if gen_beam is not None and inc > 0 else [])
                    ladder.append((None, None))
                    for b, ma in ladder:
                        HRError(8525, "HVite: no tokens for %s under "
                                      "pruning; retrying at %s",
                                entries[j].logical,
                                "unpruned" if b is None else f"beam {b:.0f}")
                        if lat_ext:
                            # -z: the widened-beam retry must also yield
                            # the lattice — a recovered 1-best with no
                            # .lat file breaks downstream HMMIRest -r
                            from ..algo.decode import generate_lattice

                            lt, r = generate_lattice(
                                net, comp, featl[j], lm_scale, word_pen,
                                lattice_beam=lat_beam,
                                frame_period_s=period / 1e7,
                                want_result=True, precision=prec,
                                beam=b, max_active=ma)
                            if r is not None and lt is not None:
                                stem = os.path.splitext(os.path.basename(
                                    entries[j].logical))[0]
                                lt.utterance = stem
                                write_slf(lt, os.path.join(
                                    out_dir or ".", f"{stem}.{lat_ext}"))
                        else:
                            r = decode(net, comp, featl[j], lm_scale,
                                       word_pen, precision=prec, beam=b,
                                       max_active=ma)
                        if r is not None:
                            results[j] = r
                            break
            for e, res in zip(entries, results):
                tr = Transcription(alternatives=[[]])
                if res is None:
                    HRError(8522, "HVite: no tokens survived for %s",
                            e.logical)
                else:
                    for w, (t0, t1) in zip(res.words, res.times):
                        tr.alternatives[0].append(Label(
                            name=w, start=t0 * period,
                            end=(t1 + 1) * period))
                    if ta.trace:
                        print(f"{e.logical}: {' '.join(res.words)}  "
                              f"[{res.score:.2f}]")
                _emit(tr, e.logical, out_mlf, out_dir, out_ext)
            files = []

        pre = preload_corpus(files, cfg)
        for fn in files:
            data, _p, _k, e = pre.get(fn) or open_speech_file(fn, cfg)
            data = adapt_for(e.logical, data)
            state_scores = None
            if ann is not None:
                from ..algo.nnet import hybrid_outp

                state_scores = np.asarray(hybrid_outp(ann, data))
            elif comp.discrete:
                from ..algo.fb_discrete import discrete_state_scores

                state_scores = discrete_state_scores(
                    comp, np.asarray(data, np.int64)
                )
            nbest = 0
            if ta.has("n"):
                v = ta.get("n")
                nbest = int(v[1] if isinstance(v, tuple) else v)
            lat = None
            if lat_ext or nbest > 1:
                # one recursion serves the lattice, the n-best list AND
                # the 1-best result (want_result)
                from ..algo.decode import generate_lattice
                from ..io.slf import write_slf

                lat, res = generate_lattice(
                    net, comp, data, lm_scale, word_pen,
                    lattice_beam=lat_beam, frame_period_s=period / 1e7,
                    state_scores=state_scores, want_result=True,
                    precision=prec, beam=gen_beam, max_active=max_act,
                )
                if lat_ext and lat is not None:
                    stem = os.path.splitext(os.path.basename(e.logical))[0]
                    lat.utterance = stem
                    lat_path = os.path.join(out_dir or ".", f"{stem}.{lat_ext}")
                    write_slf(lat, lat_path)
            else:
                res = decode(net, comp, data, lm_scale, word_pen,
                             state_scores=state_scores, precision=prec,
                             beam=gen_beam, max_active=max_act)
            if res is None and (gen_beam is not None or max_act is not None):
                # retry escalation, as on the batched path
                inc = cfg.flt_("PRUNERETRYINC", 200.0, module="HREC")
                ladder = ([(gen_beam + inc, max_act),
                           (gen_beam + 2 * inc, max_act)]
                          if gen_beam is not None and inc > 0 else [])
                ladder.append((None, None))
                for b, ma in ladder:
                    HRError(8525, "HVite: no tokens for %s under pruning; "
                                  "retrying at %s", e.logical,
                            "unpruned" if b is None else f"beam {b:.0f}")
                    if lat_ext or nbest > 1:
                        # a recovered utterance must also recover its
                        # lattice (and n-best source) — otherwise
                        # downstream HMMIRest -r fails on a missing .lat
                        from ..algo.decode import generate_lattice
                        from ..io.slf import write_slf

                        lat, res = generate_lattice(
                            net, comp, data, lm_scale, word_pen,
                            lattice_beam=lat_beam,
                            frame_period_s=period / 1e7,
                            state_scores=state_scores, want_result=True,
                            precision=prec, beam=b, max_active=ma)
                        if lat_ext and lat is not None and res is not None:
                            stem = os.path.splitext(
                                os.path.basename(e.logical))[0]
                            lat.utterance = stem
                            write_slf(lat, os.path.join(
                                out_dir or ".", f"{stem}.{lat_ext}"))
                    else:
                        res = decode(net, comp, data, lm_scale, word_pen,
                                     state_scores=state_scores,
                                     precision=prec, beam=b, max_active=ma)
                    if res is not None:
                        break
            tr = Transcription(alternatives=[[]])
            if res is None:
                HRError(8522, "HVite: no tokens survived for %s", e.logical)
            elif nbest > 1:
                # N-best sentences from the same lattice (HVite -n)
                from ..algo.latops import nbest_paths

                alts = nbest_paths(lat, nbest, lmscale=1.0,
                                   wdpenalty=0.0) if lat else []
                # map through dictionary output symbols ('' = suppressed)
                def outsym(w):
                    wd = vocab.get(w)
                    if wd is None or wd.prons[0].out_sym is None:
                        return w
                    return wd.prons[0].out_sym

                tr = Transcription(alternatives=[])
                for s, path in alts:
                    labs = [
                        Label(name=outsym(w), end=int(t * 1e7))
                        for w, t in path if outsym(w)
                    ]
                    tr.alternatives.append(labs)
                if not tr.alternatives:
                    tr.alternatives = [[]]
                if ta.trace:
                    for k, (s, path) in enumerate(alts):
                        print(f"{e.logical} [{k + 1}]: "
                              f"{' '.join(w for w, _t in path)} [{s:.2f}]")
            else:
                for w, (t0, t1) in zip(res.words, res.times):
                    tr.alternatives[0].append(
                        Label(name=w, start=t0 * period, end=(t1 + 1) * period)
                    )
                if ta.trace:
                    print(f"{e.logical}: {' '.join(res.words)}  "
                          f"[{res.score:.2f}]")
            _emit(tr, e.logical, out_mlf, out_dir, out_ext)
    elif ta.has("a"):
        mlfs = [MLF.load(p, ta.config) for p in ta.get_all("I")]
        label_dir = ta.get("L")
        label_ext = ta.get("X", "lab")
        bound = ta.get("b")
        lat_ext = ta.get("z")  # -a -z: aligned numerator lattices
        # word-internal context expansion, as the recognition network
        # compiler applies (HNet.c FindModel): on a triphone set a raw
        # monophone pron would align against stale monophone models
        from ..algo.net import word_internal_phone_map

        pron_map = word_internal_phone_map(comp.names)
        pre = preload_corpus(files, cfg)
        for fn in files:
            data, _p, _k, e = pre.get(fn) or open_speech_file(fn, cfg)
            data = adapt_for(e.logical, data)
            wtr = find_labels(e.logical, mlfs, label_dir, label_ext)
            words = [l.name for l in wtr.labels]
            if bound:
                words = [bound] + words + [bound]
            phones: List[str] = []
            word_of_phone: List[str] = []
            occ_of_phone: List[int] = []  # word-occurrence index per phone
            for oi, w in enumerate(words):
                wd = vocab.get(w)
                if wd is None:
                    HError(8621, "HVite: word %s not in dictionary", w)
                # first pronunciation, word-internally context-expanded
                phs = pron_map(wd.prons[0].phones)
                phones.extend(phs)
                word_of_phone.extend([w] * len(phs))
                occ_of_phone.extend([oi] * len(phs))
            hmm = build_composite(comp, [comp.model_id(p) for p in phones])
            res = align(comp, hmm, data, precision=prec)
            tr = Transcription(alternatives=[[]])
            if ta.has("m") and not sup_models:
                cur_occ = None
                for inst, t0, t1, seg_score in res.model_seq:
                    sc = seg_score
                    if norm_scores and t1 > t0:
                        sc = seg_score / (t1 - t0)
                    lab = Label(
                        name=phones[inst], start=t0 * period,
                        end=t1 * period, score=sc,
                    )
                    # HVite tags the first phone of each word with the
                    # word label (the model-alignment MLF convention)
                    occ = occ_of_phone[inst]
                    if occ != cur_occ:
                        if not sup_words:
                            lab.aux = [words[occ]]
                        cur_occ = occ
                    tr.alternatives[0].append(lab)
            else:
                # merge aligned phone segments into word segments
                cur_occ, w0, w1 = None, 0, 0
                for inst, t0, t1, _sc in res.model_seq:
                    occ = occ_of_phone[inst]
                    if occ != cur_occ:
                        if cur_occ is not None:
                            tr.alternatives[0].append(Label(
                                name=words[cur_occ], start=w0 * period,
                                end=w1 * period,
                            ))
                        cur_occ, w0 = occ, t0
                    w1 = t1
                if cur_occ is not None:
                    tr.alternatives[0].append(Label(
                        name=words[cur_occ], start=w0 * period, end=w1 * period,
                    ))
            if lat_ext:
                # -a -z: the aligned 1-best as a LINEAR word lattice —
                # the NUMERATOR lattice HTK MMI recipes feed HMMIRest -q.
                # Crucially this puts the numerator through the same
                # arc-FB machinery as the denominator, so the word-
                # boundary bias of fixed arc spans cancels between the
                # two sides instead of leaking into the EBW update.
                from ..io.slf import Lattice, LArc, LNode, write_slf
                from ..io.slf import NULL_WORD as _NULL

                segs = []  # (word occ, first frame, end frame, score)
                for inst, t0, t1, sc in res.model_seq:
                    occ = occ_of_phone[inst]
                    if segs and segs[-1][0] == occ:
                        segs[-1][2] = t1
                        segs[-1][3] += sc
                    else:
                        segs.append([occ, t0, t1, sc])
                lt = Lattice(lmscale=1.0, wdpenalty=0.0)
                lt.nodes.append(LNode(id=0, time=0.0, word=_NULL))
                prev = 0
                for k, (occ, w0, w1, sc) in enumerate(segs):
                    lt.nodes.append(LNode(
                        id=k + 1, time=w1 * period / 1e7,
                        word=words[occ]))
                    lt.arcs.append(LArc(id=k, start=prev, end=k + 1,
                                        aclike=float(sc), lmlike=0.0))
                    prev = k + 1
                stem = os.path.splitext(os.path.basename(e.logical))[0]
                lt.utterance = stem
                write_slf(lt, os.path.join(out_dir or ".",
                                           f"{stem}.{lat_ext}"))
            if ta.trace:
                print(f"{e.logical}: aligned {len(phones)} phones, "
                      f"score {res.score:.2f}")
            _emit(tr, e.logical, out_mlf, out_dir, out_ext)
    else:
        HError(1030, "HVite: either -w netfile or -a required\n%s", USAGE)

    if out_mlf is not None:
        out_mlf.save(out_mlf_path, with_times=not sup_times,
                     with_scores=(ta.has("m") and not sup_scores),
                     cfg=ta.config)
        if ta.trace:
            print(f"HVite: wrote {out_mlf_path}")
    return 0


def _run_live(ta, cfg, net, comp, lm_scale, word_pen, out_mlf,
              out_mlf_path, out_dir, out_ext, period) -> int:
    """Live recognition: audio source -> streaming frontend -> streaming
    decoder, with partial traceback under -T (HVite.c live loop).

    The audio 'device' on this host is a file-replay source
    (HAUDIO: AUDIOSOURCE = <file>; io/audio.py) — a microphone backend
    would slot into open_audio_input without changing this loop.
    """
    from ..algo.stream_decode import StreamingDecoder
    from ..io.audio import open_audio_input
    from ..ops.dsp import FrontendConfig
    from ..ops.stream import StreamingFrontend

    src = open_audio_input(cfg)
    fcfg = FrontendConfig.from_config(cfg, samp_period=src.samp_period)
    sf = StreamingFrontend(fcfg)
    sd = StreamingDecoder(net, comp, lm_scale=lm_scale, word_pen=word_pen)

    src.start()
    read_n = max(1, int(2500000 / src.samp_period))  # 0.25 s per read
    while (chunk := src.read(read_n)) is not None:
        feats = sf.feed(chunk.astype(np.float32))
        if feats.size:
            sd.feed(feats)
        if ta.trace > 1:
            part = sd.partial_result()
            if part is not None:
                print(f"live [{sd.frames_processed:5d}]: "
                      f"{' '.join(part.words)}")
    tail = sf.flush()
    if tail.size:
        sd.feed(tail)
    res = sd.flush()
    src.stop()

    logical = cfg.str_("AUDIOSOURCE", "liveaudio", module="HAUDIO") \
        or "liveaudio"
    tr = Transcription(alternatives=[[]])
    if res is None:
        HRError(8522, "HVite: no tokens survived (live)")
    else:
        for w, (t0, t1) in zip(res.words, res.times):
            tr.alternatives[0].append(
                Label(name=w, start=t0 * period, end=(t1 + 1) * period))
        if ta.trace:
            print(f"live: {' '.join(res.words)}  [{res.score:.2f}]")
    _emit(tr, logical, out_mlf, out_dir, out_ext)
    if out_mlf is not None:
        out_mlf.save(out_mlf_path, with_times=True, with_scores=False, cfg=ta.config)
        if ta.trace:
            print(f"HVite: wrote {out_mlf_path}")
    return 0


def _emit(tr, logical, out_mlf, out_dir, out_ext):
    if out_mlf is not None:
        stem = os.path.splitext(os.path.basename(logical))[0]
        out_mlf.add(f"*/{stem}.{out_ext}", tr)
    else:
        save_label_file(_out_label_path(logical, out_dir, out_ext), tr)


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
