"""HERest — embedded Baum-Welch reestimation.

Mirrors `HTKTools/HERest.c` (SURVEY.md §3.2): one invocation performs one
reestimation iteration over the corpus — load HMMs, forward-backward every
utterance against its transcription, accumulate, update, save. Parallel
modes:

  -p N (N>0)   accumulate this shard only, dump HERN.acc, don't update
  -p 0         load accumulator files given after the HMM list, update
  (default)    accumulate + update in one process; utterance batches are
               additionally sharded over all visible devices via
               shard_map+psum (the one-program -p)

Usage: HERest [options] hmmList [accFiles... with -p 0]

  -H mmf   load HMM macro file (repeatable)     -M dir  output directory
  -I mlf   load master label file (repeatable)  -L dir  label dir
  -X ext   label extension (default lab)        -u tmvw update flags
  -t f [i l]  forward-backward pruning beam: beta values below the
           frame's best by more than f die, and the alpha pass is
           confined to the surviving band (HFB.c semantics). An
           utterance with no surviving path re-runs with the beam
           widened by i up to l, then is skipped with a warning. The
           beam is a traced operand — escalation never recompiles.
           Continuous-density sets only (DISCRETE/TIEDHS and FULLC
           training accumulate exactly; a notice prints under -T)
  -p N     parallel mode (above)                -v f    minimum variance
  -w f     mixture weight floor (accepted)      -s file write stats file
  -B       binary MMF output
  -K dir   estimate adaptation transforms (HADAPT: TRANSKIND/BASECLASS/
           OCCTHRESH/MLLRVAR/NUMREGCLASSES) instead of updating models
  -J dir   input transform directory (with -a)  -h mask speaker mask
  -a       apply input transforms during accumulation: CMLLR in feature
           space (fMLLR-SAT), MLLR mean/variance per speaker group in
           model space — the canonical model updates from summed stats
  -r       single-pass retraining: the script pairs files ("old new" on
           one line, or alternating lines); occupancies are aligned on
           channel 1 (config HPARM1:/HWAVE1: overrides), moment stats
           accumulate from channel 2 (HPARM2:/HWAVE2:), and the updated
           means/variances take channel 2's width and parm kind
  Standard: -A -C -D -S -T -V
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ..algo.reestimate import UpdateFlags, reestimate
from ..algo.trainer import Trainer, prepare_utterance
from ..io.mlf import MLF, find_labels
from ..io.mmf import load_hmm_list, load_mmf, save_mmf
from ..models.hmmset import compile_hmmset, write_back
from ..parallel.acc_files import dump_accs, load_accs, sum_accs
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError, HRError
from ._common import (channel_config, open_speech_file, outp_precision,
                      preload_corpus)

USAGE = "Usage: HERest [options] hmmList [accFiles...]"

OPTS = {
    "H": Option("H", 1, "load MMF", repeatable=True),
    "M": Option("M", 1, "output directory"),
    "I": Option("I", 1, "load MLF", repeatable=True),
    "L": Option("L", 1, "label directory"),
    "X": Option("X", 1, "label extension"),
    "u": Option("u", 1, "update flags tmvw"),
    "t": Option("t", 1, "pruning beam(s) f [i l]", typ=float, greedy=True),
    "p": Option("p", 1, "parallel mode", typ=int),
    "v": Option("v", 1, "minimum variance", typ=float),
    "w": Option("w", 1, "mixture weight floor", typ=float),
    "s": Option("s", 1, "stats file"),
    "d": Option("d", 1, "hmm definition directory"),
    "b": Option("b", 1, "batch size", typ=int),
    "K": Option("K", 1, "output transform dir (estimate adaptation)"),
    "J": Option("J", 1, "input transform dir"),
    "a": Option("a", 0, "apply input transforms"),
    "h": Option("h", 1, "speaker mask (accepted; global transform)"),
    "r": Option("r", 0, "single-pass retraining (paired script)"),
}


def _load_stats_targets(comp, accs):
    """Per-physical-state occupancy for the HHEd stats file."""
    return np.asarray(accs.wt_occ).sum(axis=1)


def write_stats_file(path: str, hset, comp, accs) -> None:
    """HERest -s stats file: per-HMM per-state occupancies (HHEd RO input).

    Format (HTK): index logicalName nUtts totalOcc then per-state occs.
    """
    state_occ = _load_stats_targets(comp, accs)
    with open(path, "w") as f:
        for i, name in enumerate(comp.names):
            n = int(comp.model_nstates[i])
            occs = [state_occ[comp.model_states[i, k]] for k in range(n - 2)]
            f.write(
                f'{i + 1:4d} "{name}" {int(np.asarray(accs.n_utts)):10d} '
                + " ".join(f"{o:10.2f}" for o in occs)
                + "\n"
            )


def run(argv: List[str]) -> int:
    ta = parse_args("HERest", argv, OPTS, min_args=1, usage=USAGE)
    prune = None
    if ta.has("t"):
        v = ta.get("t")
        vs = [float(x) for x in (v if isinstance(v, tuple) else (v,))]
        if len(vs) == 2:
            # HERest.c reads inc and limit together — two values would
            # silently kill the retry ladder (inc with limit == init)
            HError(1021, "HERest: -t takes f or f i l (inc without "
                         "limit given)")
        prune = (vs[0],
                 vs[1] if len(vs) > 1 else 0.0,
                 vs[2] if len(vs) > 2 else vs[0])
        if ta.trace:
            print(f"HERest: FB beam pruning {prune[0]:.1f} "
                  f"(inc {prune[1]:.1f}, limit {prune[2]:.1f})")
    cfg = ta.config
    hmm_list_file = ta.args[0]
    extra = ta.args[1:]

    mmfs = ta.get_all("H")
    if not mmfs:
        HError(1030, "HERest: at least one -H mmf required\n%s", USAGE)
    hset = load_mmf(mmfs, cfg=ta.config)
    hmm_list = load_hmm_list(hmm_list_file, ta.config)
    missing = [l for l, p in hmm_list if (p or l) not in hset.hmms]
    if missing:
        HError(7035, "HERest: HMMs not in MMF: %s", " ".join(missing[:5]))
    comp = compile_hmmset(hset)

    retrain = ta.has("r")
    kind2 = None  # -r: channel-2 parm kind for the output MMF
    flags = UpdateFlags.parse(ta.get("u", "tmvw"))
    min_var = float(ta.get("v", 1e-6) or 1e-6)
    var_floor = hset.macros["v"].get("varFloor1")
    p_mode = int(ta.get("p", -1)) if ta.has("p") else -1
    out_dir = ta.get("M", ".")
    batch_size = int(ta.get("b", 8) or 8)

    if p_mode == 0:
        if ta.has("K"):
            HError(1030, "HERest: -K transform estimation needs utterance "
                         "mode, not -p 0 accumulator combining")
        if not extra:
            HError(1030, "HERest: -p 0 needs accumulator files")
        accs = sum_accs([load_accs(p) for p in extra])
        if comp.full_cov:
            fc_xxT = None
            for p in extra:
                try:
                    side = np.load(p + ".fcx.npy")
                except OSError:
                    HError(7111, "HERest -p 0: FULLC set needs the "
                                 "second-moment sidecar %s.fcx.npy "
                                 "(dumped by the matching -p N run)", p)
                fc_xxT = side if fc_xxT is None else fc_xxT + side
    else:
        mlfs = [MLF.load(p, ta.config) for p in ta.get_all("I")]
        label_dir = ta.get("L")
        label_ext = ta.get("X", "lab")
        files = ta.script + extra
        if not files:
            HError(1030, "HERest: no training files\n%s", USAGE)

        if comp.full_cov and (retrain or ta.has("a")):
            HError(7060, "HERest: full-covariance training combines with "
                         "neither -r nor -a input transforms (-K MLLRMEAN "
                         "estimation is supported)")
        if retrain and comp.discrete:
            HError(7060, "HERest: -r single-pass retraining needs a "
                         "continuous-density set")
        if retrain and ta.has("a"):
            HError(1030, "HERest: -r cannot combine with -a input "
                         "transforms")
        # device-side composite assembly is the default trainer path
        # (it runs on one device); HTKTPU: DEVICECOMPOSITE = F selects
        # host assembly and the trainer that shards over every device. Adaptation
        # estimation (-K) needs the host composite objects.
        use_dev_comp = (
            cfg.bool_("DEVICECOMPOSITE", True, module="HTKTPU")
            and not comp.discrete and not retrain and not ta.has("K")
            and not comp.full_cov  # dedicated path needs host composites
        )
        # -r pairs the script: "old new" on one line or alternating lines
        pairs = {}
        if retrain:
            paired = []
            pend = None
            for fn in list(files):
                toks = fn.split()
                if len(toks) == 2:
                    paired.append((toks[0], toks[1]))
                elif pend is None:
                    pend = fn
                else:
                    paired.append((pend, fn))
                    pend = None
            if pend is not None:
                HError(1030, "HERest: -r script has an unpaired file %s",
                       pend)
            files = [a for a, _b in paired]
            pairs = dict(paired)
            cfg1 = channel_config(cfg, 1)
            cfg2 = channel_config(cfg, 2)
            # channel-2 width: open the first pair's second file
            d2_probe, _p2, kind2, _e2 = open_speech_file(
                paired[0][1], cfg2)
            retrain_dim = int(d2_probe.shape[1])

        if prune is not None and (comp.full_cov or comp.discrete):
            if ta.trace:
                print("HERest: -t applies to continuous-density scan "
                      "training only — accumulating exactly")
            prune = None
        if comp.full_cov:
            trainer = None  # dedicated path below (algo/fullcov_train)
        elif use_dev_comp:
            from ..algo.trainer import DeviceCompositeTrainer

            trainer = DeviceCompositeTrainer(
                comp, precision=outp_precision(cfg), prune=prune)
        elif retrain:
            trainer = Trainer(comp, retrain_dim=retrain_dim,
                              precision=outp_precision(cfg), prune=prune)
        else:
            trainer = (_make_discrete_trainer(comp) if comp.discrete
                       else _make_trainer(comp, cfg, prune))
        # input transforms (-J dir with -a): per-speaker TMFs applied
        # during accumulation — CMLLR in feature space (fMLLR-SAT), MLLR
        # mean/variance in model space (each speaker group accumulates
        # against its adapted parameters; the canonical model is then
        # reestimated from the summed statistics).
        in_xfs = {}
        if ta.has("a") and ta.get_all("J") and not comp.discrete:
            import glob as _glob

            from ..algo.adapt import load_tmf, load_tmf_classes

            for d in ta.get_all("J"):
                for tmf in sorted(_glob.glob(os.path.join(d, "*.tmf"))):
                    key = os.path.splitext(os.path.basename(tmf))[0]
                    multi = load_tmf_classes(tmf)
                    in_xfs[key] = (multi if multi is not None
                                   else load_tmf(tmf)[1])
            if not in_xfs:
                HRError(7441, "HERest: -a but no TMFs under -J")
        spk_mask = ta.get("h")

        utts = []
        tagged = []  # (model-space speaker or None, utt)
        from ..algo.trainer import prepare_utterance_ids

        prep = prepare_utterance_ids if use_dev_comp else prepare_utterance
        pre = {} if retrain else preload_corpus(files, cfg)
        for fn in files:
            data2 = None
            if retrain:
                data, _p, _k, e = open_speech_file(fn, cfg1)
                data2, _p2, kind2, _e2 = open_speech_file(pairs[fn], cfg2)
                if data2.shape[0] != data.shape[0]:
                    n = min(data.shape[0], data2.shape[0])
                    HRError(7327, "HERest -r: %s/%s frame counts differ "
                            "(%d vs %d), clipping", fn, pairs[fn],
                            data.shape[0], data2.shape[0])
                    data, data2 = data[:n], data2[:n]
            else:
                data, period, kind, e = (pre.get(fn)
                                         or open_speech_file(fn, cfg))
            tr = find_labels(e.logical, mlfs, label_dir, label_ext)
            names = [l.name for l in tr.labels]
            if not names:
                HRError(7325, "HERest: empty transcription for %s", e.logical)
                continue
            spk = None
            if in_xfs:
                from ..algo.adapt import speaker_from_mask

                spk = (speaker_from_mask(spk_mask, e.logical) if spk_mask
                       else next(iter(in_xfs)))
                xf = in_xfs.get(spk)
                if xf is None:
                    HRError(7441, "HERest: no input transform for %s", spk)
                    spk = None
                elif not isinstance(xf, tuple) and xf.kind == "CMLLR":
                    data = xf.apply_to_features(data).astype(np.float32)
                    spk = None  # feature-space transform: no model group
            u = (prepare_utterance(comp, e.logical, data, names,
                                   feats2=data2)
                 if retrain else prep(comp, e.logical, data, names))
            utts.append(u)
            tagged.append((spk, u))
        if not utts:
            HError(7326, "HERest: no trainable utterances")

        model_groups = {}
        plain = []
        for spk, u in tagged:
            if spk is not None:
                model_groups.setdefault(spk, []).append(u)
            else:
                plain.append(u)
        if model_groups:
            from ..algo.adapt import (apply_mllr_classes,
                                      apply_mllr_classes_vars)
            from ..models.hmmset import write_back as _wb

            base_means = comp.means.copy()
            base_vars = comp.variances.copy()
            acc_list = []
            if plain:
                acc_list.append(trainer.accumulate(
                    plain, batch_size=batch_size, trace=ta.trace))
            for spk, uset in model_groups.items():
                xf = in_xfs[spk]
                if isinstance(xf, tuple):
                    _nm, xfs_l, c2x, cls = xf
                    nv = (apply_mllr_classes_vars(comp, base_vars, xfs_l,
                                                  c2x, cls)
                          if any(x.var_scale is not None for x in xfs_l)
                          else None)
                    _wb(comp, means=apply_mllr_classes(
                        comp, base_means, xfs_l, c2x, cls), variances=nv)
                else:
                    _wb(comp, means=xf.apply_to_means(base_means),
                        variances=(xf.apply_to_vars(base_vars)
                                   if xf.var_scale is not None else None))
                acc_list.append(trainer.accumulate(
                    uset, batch_size=batch_size, trace=ta.trace))
            _wb(comp, means=base_means, variances=base_vars)
            accs = sum_accs(acc_list)
        elif comp.full_cov:
            from ..algo.fullcov_train import fullcov_accumulate
            from ..utils.metrics import maybe_profile

            with maybe_profile(cfg, "HERest"):
                accs, fc_xxT = fullcov_accumulate(comp, utts,
                                                  trace=ta.trace)
        else:
            from ..utils.metrics import maybe_profile

            with maybe_profile(cfg, "HERest"):
                accs = trainer.accumulate(utts, batch_size=batch_size,
                                          trace=ta.trace)

        if p_mode > 0:
            os.makedirs(out_dir, exist_ok=True)
            acc_path = os.path.join(out_dir, f"HER{p_mode}.acc")
            dump_accs(accs, acc_path)
            if comp.full_cov:
                # full second moments ride a sidecar next to the .acc
                np.save(acc_path + ".fcx.npy", fc_xxT)
            if ta.trace:
                print(f"HERest: dumped accumulators to {acc_path}")
            return 0

    tf = float(np.asarray(accs.total_frames))
    tl = float(np.asarray(accs.total_logp))
    nu = int(np.asarray(accs.n_utts))
    if ta.trace:
        print(
            f"Reestimation complete - average log prob per frame = "
            f"{tl / max(tf, 1.0):.5f} ({nu} utterances, {int(tf)} frames)"
        )
    from ..utils.metrics import emit_metric

    emit_metric(cfg, "HERest", logp_per_frame=tl / max(tf, 1.0),
                frames=int(tf), utterances=nu)

    if ta.has("K"):
        # transform estimation mode (HERest adaptation): estimate one
        # transform per speaker (-h mask; one global speaker without it)
        # and save TMFs; models unchanged.
        from ..algo.adapt import (cmllr_stats_from_gammas, estimate_cmllr,
                                  estimate_mllr_mean, save_tmf,
                                  speaker_from_mask)

        kind = (cfg.str_("TRANSKIND", "MLLRMEAN", module="HADAPT")
                or "MLLRMEAN").upper()
        # HADAPT: BLOCKS — block-diagonal transform structure (HAdapt
        # BLOCKINFO): the standard guard against under-determined
        # full-matrix solves on sparse adaptation data (3 on _D_A
        # features keeps statics/deltas/accelerations separate)
        n_blocks = int(cfg.flt_("BLOCKS", 1.0, module="HADAPT"))
        out_xf_dir = ta.get("K")
        os.makedirs(out_xf_dir, exist_ok=True)
        mask = ta.get("h")
        groups = {}
        for u in utts:
            spk = speaker_from_mask(mask, u.name) if mask else "global"
            groups.setdefault(spk, []).append(u)

        def cmllr_from(uset):
            import jax.numpy as jnp
            from ..algo.fb import mix_posteriors_utterance
            from ..algo.trainer import pad_batch

            stats = None
            params = trainer.params()
            for u in uset:
                arrs = pad_batch([u], comp.n_states)
                _lp, gam = mix_posteriors_utterance(
                    jnp.asarray(arrs["feats"][0]), jnp.asarray(arrs["t_real"][0]),
                    jnp.asarray(arrs["comp_state"][0]), jnp.asarray(arrs["q_mask"][0]),
                    jnp.asarray(arrs["logA"][0]), jnp.asarray(arrs["a0"][0]),
                    jnp.asarray(arrs["aE"][0]),
                    means=params[0], variances=params[1], gconsts=params[2],
                    state_mix=params[3], state_logw=params[4],
                    state_sw=params[5],
                    slot_blocks=tuple(comp.slot_blocks) or None,
                )
                T = u.feats.shape[0]
                s = cmllr_stats_from_gammas(
                    u.feats.astype(np.float64), np.asarray(gam)[:T],
                    comp.means, comp.variances,
                )
                if stats is None:
                    stats = s
                else:
                    stats.G += s.G
                    stats.k += s.k
                    stats.beta += s.beta
            return estimate_cmllr(stats, blocks=n_blocks)

        def mllrcov_from(uset):
            import jax.numpy as jnp

            from ..algo.adapt import (estimate_mllrcov,
                                      mllrcov_stats_from_gammas)
            from ..algo.fb import mix_posteriors_utterance
            from ..algo.trainer import pad_batch

            G = None
            beta = 0.0
            params = trainer.params()
            for u in uset:
                arrs = pad_batch([u], comp.n_states)
                _lp, gam = mix_posteriors_utterance(
                    jnp.asarray(arrs["feats"][0]),
                    jnp.asarray(arrs["t_real"][0]),
                    jnp.asarray(arrs["comp_state"][0]),
                    jnp.asarray(arrs["q_mask"][0]),
                    jnp.asarray(arrs["logA"][0]), jnp.asarray(arrs["a0"][0]),
                    jnp.asarray(arrs["aE"][0]),
                    means=params[0], variances=params[1], gconsts=params[2],
                    state_mix=params[3], state_logw=params[4],
                    state_sw=params[5],
                    slot_blocks=tuple(comp.slot_blocks) or None,
                )
                T = u.feats.shape[0]
                g, b = mllrcov_stats_from_gammas(
                    u.feats.astype(np.float64), np.asarray(gam)[:T],
                    comp.means, comp.variances)
                G = g if G is None else G + g
                beta += b
            return estimate_mllrcov(G, beta)

        n_reg = cfg.int_("NUMREGCLASSES", 1, module="HADAPT") or 1
        # HHEd RC output (classes + regression tree) overrides on-the-fly
        # clustering when given; the tree enables occupancy back-off
        bc_path = cfg.str_("BASECLASS", None, module="HADAPT")
        bc_classes = None
        bc_tree = None
        if bc_path:
            from ..algo.adapt import load_baseclass

            _bc_name, bc_classes, bc_tree = load_baseclass(
                bc_path, hset=hset, comp=comp)
            if len(bc_classes) != comp.n_mix:
                HError(7460, "HERest: baseclass %s covers %d Gaussians, "
                       "set has %d", bc_path, len(bc_classes), comp.n_mix)
            n_reg = max(n_reg, int(bc_classes.max()) + 1)
        mllr_var = cfg.bool_("MLLRVAR", False, module="HADAPT") or False
        occ_thresh = cfg.flt_("OCCTHRESH", 700.0, module="HADAPT") or 700.0
        if comp.full_cov and (kind != "MLLRMEAN" or mllr_var):
            HError(7450, "HERest -K: full-covariance sets estimate "
                         "MLLRMEAN mean transforms only (TRANSKIND %s%s)",
                   kind, ", MLLRVAR" if mllr_var else "")

        def _spk_accs(uset):
            if len(groups) == 1:
                return accs
            if comp.full_cov:
                from ..algo.fullcov_train import fullcov_accumulate

                return fullcov_accumulate(comp, uset, trace=ta.trace)[0]
            return trainer.accumulate(uset, batch_size=batch_size)

        for spk, uset in groups.items():
            tmf_path = os.path.join(out_xf_dir, f"{spk}.tmf")
            if kind == "MLLRMEAN":
                spk_accs = _spk_accs(uset)
                if n_reg > 1:
                    from ..algo.adapt import (build_regression_classes,
                                              estimate_mllr_classes,
                                              estimate_mllr_tree,
                                              save_tmf_classes)

                    if bc_tree is not None:
                        classes = bc_classes
                        xfs, c2x = estimate_mllr_tree(
                            comp, spk_accs, classes, bc_tree[0], bc_tree[1],
                            occ_thresh=occ_thresh, mllr_var=mllr_var)
                    else:
                        classes = (bc_classes if bc_classes is not None
                                   else build_regression_classes(comp, n_reg))
                        xfs, c2x = estimate_mllr_classes(comp, spk_accs,
                                                         classes)
                    save_tmf_classes(tmf_path, spk, xfs, c2x, classes)
                    if ta.trace:
                        print(f"HERest: {len(xfs)} regression-class "
                              f"transforms for {spk} -> {tmf_path}")
                    continue
                xf = estimate_mllr_mean(comp, spk_accs,
                                        blocks=n_blocks)
                if mllr_var:
                    from ..algo.adapt import estimate_mllr_var

                    xf.var_scale = estimate_mllr_var(
                        comp, spk_accs, xf.apply_to_means(comp.means))
            elif kind == "CMLLR":
                if n_reg > 1:
                    from ..algo.adapt import (build_regression_classes,
                                              cmllr_stats_from_gammas,
                                              estimate_cmllr_classes,
                                              save_tmf_classes)
                    import jax.numpy as jnp

                    from ..algo.fb import mix_posteriors_utterance
                    from ..algo.trainer import pad_batch

                    classes = (bc_classes if bc_classes is not None
                               else build_regression_classes(comp, n_reg))
                    C = int(classes.max()) + 1
                    g_stats = None
                    c_stats = [None] * C
                    params = trainer.params()
                    for u in uset:
                        arrs = pad_batch([u], comp.n_states)
                        _lp, gam = mix_posteriors_utterance(
                            jnp.asarray(arrs["feats"][0]),
                            jnp.asarray(arrs["t_real"][0]),
                            jnp.asarray(arrs["comp_state"][0]),
                            jnp.asarray(arrs["q_mask"][0]),
                            jnp.asarray(arrs["logA"][0]),
                            jnp.asarray(arrs["a0"][0]),
                            jnp.asarray(arrs["aE"][0]),
                            means=params[0], variances=params[1],
                            gconsts=params[2], state_mix=params[3],
                            state_logw=params[4], state_sw=params[5],
                            slot_blocks=tuple(comp.slot_blocks) or None,
                        )
                        T = u.feats.shape[0]
                        gam = np.asarray(gam)[:T]
                        fx = u.feats.astype(np.float64)

                        def _acc(tot, st):
                            if tot is None:
                                return st
                            tot.G += st.G
                            tot.k += st.k
                            tot.beta += st.beta
                            return tot

                        g_stats = _acc(g_stats, cmllr_stats_from_gammas(
                            fx, gam, comp.means, comp.variances))
                        for c in range(C):
                            gm = gam * (classes[None, :] == c)
                            if gm.sum() <= 0:
                                continue
                            c_stats[c] = _acc(
                                c_stats[c], cmllr_stats_from_gammas(
                                    fx, gm, comp.means, comp.variances))
                    xfs, c2x = estimate_cmllr_classes(
                        c_stats, g_stats, occ_thresh=occ_thresh)
                    save_tmf_classes(tmf_path, spk, xfs, c2x, classes,
                                     kind="CMLLRCLASSES")
                    if ta.trace:
                        print(f"HERest: {len(xfs)} base-class CMLLR "
                              f"transforms for {spk} -> {tmf_path}")
                    continue
                xf = cmllr_from(uset)
            elif kind == "MLLRCOV":
                xf = mllrcov_from(uset)
            else:
                HError(7450, "HERest: unsupported TRANSKIND %s", kind)
            save_tmf(tmf_path, spk, xf)
            if ta.trace:
                print(f"HERest: estimated {kind} transform for {spk} "
                      f"({len(uset)} utts) -> {tmf_path}")
        return 0

    if comp.discrete:
        from ..algo.fb_discrete import reestimate_discrete
        from ..models.hmmset import write_back_discrete

        table, new_tr = reestimate_discrete(comp, accs)
        write_back_discrete(comp, table)
        if flags.transitions:
            from ..models.hmmset import write_back as _wb

            _wb(comp, transps=new_tr)
        os.makedirs(out_dir, exist_ok=True)
        out_mmf = os.path.join(out_dir, os.path.basename(mmfs[0]))
        save_mmf(hset, out_mmf, binary=ta.binary)
        if ta.trace:
            print(f"HERest: saved {out_mmf} (discrete)")
        return 0

    map_tau = cfg.flt_("MAPTAU", 0.0, module="HMAP") or 0.0
    if comp.full_cov:
        from ..algo.fullcov_train import fullcov_update

        comp, n_upd = fullcov_update(hset, comp, accs, fc_xxT, flags,
                                     min_var=min_var)
        if ta.trace:
            print(f"HERest: FULLC update touched {n_upd} Gaussians")
    elif retrain or (p_mode == 0 and ta.has("r")):
        # single-pass retraining update: weights/transitions from the
        # alignment statistics as usual; means/variances wholesale from
        # the channel-2 moment sums, set takes channel 2's geometry
        from ..algo.reestimate import retrain_params
        from ..models.hmmset import write_back_retrained
        from ..io import parmkind as _pk

        if kind2 is None:  # -p 0 combine: geometry from config + accs
            k2s = channel_config(cfg, 2).str_("TARGETKIND", None,
                                              module="HPARM")
            if not k2s or k2s.upper() == "ANON":
                HError(1030, "HERest -r -p 0: config HPARM2: TARGETKIND "
                             "must name the new channel's kind")
            kind2 = _pk.str2parmkind(k2s)
        _mw, _vw, w, t = reestimate(
            comp, accs,
            UpdateFlags(means=False, variances=False,
                        weights=flags.weights,
                        transitions=flags.transitions))
        write_back(comp, weights=w, transps=t)
        m2, v2, g_var = retrain_params(accs, min_var=min_var)
        write_back_retrained(comp, m2, v2,
                             int(kind2) & ~(_pk.HASCOMPX | _pk.HASCRCC),
                             g_var=g_var)
    elif map_tau > 0:
        from ..algo.adapt import map_update

        m = map_update(comp, accs, map_tau)
        write_back(comp, means=m)
    else:
        m, v, w, t = reestimate(comp, accs, flags, var_floor=var_floor,
                                min_var=min_var)
        write_back(comp, means=m, variances=v, weights=w, transps=t)

    if ta.has("s"):
        write_stats_file(ta.get("s"), hset, comp, accs)

    os.makedirs(out_dir, exist_ok=True)
    out_mmf = os.path.join(out_dir, os.path.basename(mmfs[0]))
    save_mmf(hset, out_mmf, binary=ta.binary)
    if ta.trace:
        print(f"HERest: saved {out_mmf}")
    return 0


def _make_discrete_trainer(comp):
    from ..algo.fb_discrete import DiscreteTrainer

    return DiscreteTrainer(comp)


def _make_trainer(comp, cfg, prune=None) -> Trainer:
    """Serial or device-sharded trainer per visible devices / config.

    Multi-host: with JAX_COORDINATOR_ADDRESS set (or config HTKTPU:
    COORDINATOR), the distributed runtime is initialised first, so the
    mesh spans every host's devices and accumulator psums cross DCN —
    the one-program form of multi-machine `HERest -p N`.
    """
    import jax

    from ..parallel.mesh import ShardedTrainer, init_distributed, make_mesh

    coord = cfg.str_("COORDINATOR", None, module="HTKTPU")
    init_distributed(coordinator=coord)
    n_dev = len(jax.devices())
    prec = outp_precision(cfg)
    if n_dev > 1 and cfg.bool_("USESHARDING", True, module="HTKTPU"):
        return ShardedTrainer(comp, make_mesh(), precision=prec,
                              prune=prune)
    return Trainer(comp, precision=prec, prune=prune)


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
