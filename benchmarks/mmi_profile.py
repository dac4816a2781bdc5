"""Decompose one MMI pass into its phases on the real chip.

Evidence for VERDICT r5 (config #5 discriminative half): where does the
time go — lattice generation, den-lattice pruning (the HTK MMI recipe
prunes denominator lattices before HMMIRest), host arc expansion,
device scoring, host DAG posteriors, device accumulation, numerator FB?

Usage:  python benchmarks/mmi_profile.py [prune_beam]
Prints one JSON line with per-phase seconds and arc counts.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(prune_beam=None):
    from bench import build_tied_triphone_system

    import jax

    from htk_jax.algo.decode import generate_lattice_batch
    from htk_jax.algo.fb import zero_accs
    from htk_jax.algo.latops import arc_posteriors, prune
    from htk_jax.algo.lvnet import compile_lv_loop
    from htk_jax.algo.trainer import Trainer, prepare_utterance
    from htk_jax.tools.hmmirest import ArcFB, lattice_arc_utts

    n_utts, T, period = 4, 500, 100000
    comp, vocab, words, lm = build_tied_triphone_system(5000, n_tied=2000,
                                                        seed=7)
    net = compile_lv_loop(words, vocab, comp, lm=lm)
    rng = np.random.default_rng(5)
    dim = comp.means.shape[1]
    trainer = Trainer(comp)
    arcfb = ArcFB(trainer, comp)
    feats = [rng.normal(size=(T, dim)).astype(np.float32)
             for _ in range(n_utts)]
    trans = [[words[j] for j in rng.integers(0, len(words), 8)]
             for _ in range(n_utts)]

    out = {"prune_beam": prune_beam}

    def phase(key, fn):
        t0 = time.perf_counter()
        r = fn()
        out[key] = round(time.perf_counter() - t0, 3)
        return r

    def full(warm):
        # numerator transcript FB
        utts = [prepare_utterance(
            comp, f"u{i}", feats[i],
            [p for w in trans[i] for p in vocab.get(w).prons[0].phones])
            for i in range(n_utts)]
        num = phase("num_fb_s", lambda: trainer.accumulate(utts, 8))
        lats = phase("latgen_s", lambda: generate_lattice_batch(
            net, comp, feats, lm_scale=8.0, lattice_beam=150.0))
        if prune_beam is not None:
            lats = phase("prune_s", lambda: [
                prune(l, prune_beam, lmscale=8.0) for l in lats])
        out["arcs"] = sum(len(l.arcs) for l in lats)
        fbank = phase("bank_s", lambda: arcfb.load_block(feats))
        per_lat, all_utts = [], []

        def expand():
            for i, lat in enumerate(lats):
                us, a2n = lattice_arc_utts(lat, vocab, comp, feats[i],
                                           period, f"u{i}", arcfb, utt=i)
                per_lat.append((lat, a2n))
                all_utts.extend(us)
        phase("expand_s", expand)
        out["unique_utts"] = len(all_utts)
        arc_ll = phase("score_s", lambda: arcfb.score(fbank, all_utts))

        def posts():
            wts = {}
            for lat, a2n in per_lat:
                for a in lat.arcs:
                    nm = a2n.get(a.id)
                    if nm is not None and nm in arc_ll:
                        a.aclike = arc_ll[nm]
                _lp, post = arc_posteriors(lat, lmscale=8.0, wdpenalty=0.0)
                for aid, g in post.items():
                    nm = a2n.get(aid)
                    if nm is not None and g > -30:
                        wts[nm] = wts.get(nm, 0.0) + float(
                            np.exp(min(g, 0.0)))
            return wts
        wts = phase("posteriors_s", posts)
        den = zero_accs(comp.n_mix, comp.dim, comp.n_states, comp.max_mix,
                        trainer.tr_flat)
        den = phase("acc_s", lambda: arcfb.accumulate(fbank, all_utts, wts,
                                                      den))
        jax.block_until_ready(den.occ)
        return num, den

    full(warm=False)  # compile
    t0 = time.perf_counter()
    full(warm=True)
    out["total_s"] = round(time.perf_counter() - t0, 3)
    out["utt_per_sec"] = round(n_utts / out["total_s"], 4)
    out["backend"] = jax.default_backend()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(float(sys.argv[1]) if len(sys.argv) > 1 else None)
