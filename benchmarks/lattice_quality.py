"""Lattice-quality harness: oracle error and pass-2 search error vs
the pruning knobs (-t genBeam, -u top-A, -n lattice beam).

Quantifies the claim that "the lattice beam bounds the pass-2
approximation" (tools/hdecode.py): synthesizes utterances FROM the
benchmark system (known references), generates pass-1 lattices per
pruning configuration, and reports 1-best WER, lattice ORACLE WER
(algo/latops.oracle_error), rescored WER, and the search-error rate
vs the widest configuration.

Run on the accelerator: python benchmarks/lattice_quality.py
(VOCAB=20000 for the 20k sweep; defaults to 5000.)

LMORDER=3 builds a trigram LM and sweeps every configuration twice in
one interleaved run — pass 1 plain bigram vs single-pass trigram
guidance (compile_lv_loop(trigram=True), the HLVRec-LM.c role) — so
the guided column shows whether the genBeam search-error knee
collapses when the beam protects trigram-best hypotheses.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

VOCAB = int(os.environ.get("VOCAB", "5000"))
N_UTT = int(os.environ.get("NUTT", "16"))
LATPREDS = int(os.environ.get("LATPREDS", "1"))  # HLVRec alt arcs
WORDS_PER = (6, 10)


def synth_utt(comp, vocab, seq, rng, frames_per_state=3,
              noise=float(os.environ.get("NOISE", "4.0"))):
    """Emit frames by walking each word's pron chain state means."""
    from htk_jax.algo.composite import build_composite

    frames = []
    for w in seq:
        for ph in vocab.get(w).prons[0].phones:
            ch = build_composite(comp, [comp.model_id(ph)])
            for s in np.asarray(ch.comp_state):
                mixes = np.asarray(comp.state_mix[int(s)])
                m0 = int(mixes[mixes >= 0][0])
                mu = np.asarray(comp.means[m0])
                for _ in range(frames_per_state):
                    frames.append(mu + noise * rng.normal(size=mu.shape))
    return np.stack(frames).astype(np.float32)


def wer(ref, hyp):
    n, m = len(ref), len(hyp)
    d = np.zeros((n + 1, m + 1), np.int32)
    d[:, 0] = np.arange(n + 1)
    d[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            d[i, j] = min(d[i - 1, j] + 1, d[i, j - 1] + 1,
                          d[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]))
    return int(d[n, m])


def main():
    from bench import build_tied_triphone_system
    from htk_jax.algo.decode import generate_lattice_batch
    from htk_jax.algo.latops import best_path_trigram, oracle_error
    from htk_jax.algo.lvnet import compile_lv_loop

    rng = np.random.default_rng(7)
    lm_order = int(os.environ.get("LMORDER", "2"))
    comp, vocab, words, lm = build_tied_triphone_system(
        VOCAB, n_tied=2000, seed=11, lm_order=lm_order)
    nets = [("bigram", compile_lv_loop(words, vocab, comp, lm=lm))]
    if lm_order >= 3:
        nets.append(("triguide", compile_lv_loop(words, vocab, comp,
                                                 lm=lm, trigram=True)))
    net = nets[0][1]
    print(f"{VOCAB} words, {net.n_chains} rows "
          f"({'factored' if net.xw_backoff is not None else 'dense'}), "
          f"LM order {lm_order}", flush=True)

    # reference transcripts: for trigram sweeps, SAMPLE FROM THE LM —
    # uniform-random refs make trigram context uninformative about the
    # truth, so guided and bigram pass-1 decode identically and the
    # sweep cannot show what guidance protects (round-5 finding; the
    # earlier table's identical triguide/bigram columns were this)
    tri_succ = {}
    bi_succ = {}
    if lm_order >= 3:
        for (u, v, w) in lm.trigrams:
            tri_succ.setdefault((u, v), []).append(w)
        for (u, v) in lm.bigrams:
            bi_succ.setdefault(u, []).append(v)

    def sample_seq(k):
        seq = [words[int(rng.integers(0, len(words)))]]
        while len(seq) < k:
            u = seq[-2] if len(seq) >= 2 else None
            v = seq[-1]
            r = rng.random()
            cands = tri_succ.get((u, v)) if u is not None else None
            if cands and r < 0.7:
                seq.append(cands[int(rng.integers(len(cands)))])
                continue
            cands = bi_succ.get(v)
            if cands and r < 0.9:
                seq.append(cands[int(rng.integers(len(cands)))])
                continue
            seq.append(words[int(rng.integers(0, len(words)))])
        return seq

    refs, feats = [], []
    for _ in range(N_UTT):
        k = int(rng.integers(*WORDS_PER))
        seq = (sample_seq(k) if lm_order >= 3 else
               [words[int(i)] for i in rng.integers(0, len(words), k)])
        refs.append(seq)
        feats.append(synth_utt(comp, vocab, seq, rng))
    n_ref = sum(len(r) for r in refs)

    # sweep: (genBeam, top-A, lattice beam); None = off
    configs = [
        (None, None, 400.0),   # widest (the reference point)
        (None, None, 150.0),
        (None, None, 50.0),
        (400.0, None, 150.0),
        (300.0, None, 150.0),
        (250.0, None, 150.0),
        (200.0, None, 150.0),
        (None, 64, 150.0),
        (None, 16, 150.0),
        (300.0, 16, 50.0),
    ]
    base_hyps = None
    lm_scale = 8.0
    print(f"{'mode':>9} {'genBeam':>8} {'topA':>5} {'latBeam':>8} | "
          f"{'WER%':>6} {'oracle%':>8} {'resc%':>6} {'searchErr%':>10} "
          f"{'xRT':>7} {'arcs/utt':>9}")
    for beam, top_a, lat_beam in configs:
        for tag, net_ in nets:
            generate_lattice_batch(  # warm-up: exclude compilation of
                net_, comp, feats, lm_scale=lm_scale,  # every bucket
                lattice_beam=lat_beam, beam=beam, max_active=top_a,
                max_preds=LATPREDS)
            t0 = time.perf_counter()
            lats = generate_lattice_batch(
                net_, comp, feats, lm_scale=lm_scale,
                lattice_beam=lat_beam, beam=beam, max_active=top_a,
                max_preds=LATPREDS)
            dt = time.perf_counter() - t0
            errs = orc = resc = diff = 0
            n_arcs = 0
            hyps = []
            for lat, ref in zip(lats, refs):
                if lat is None:
                    errs += len(ref)
                    orc += len(ref)
                    resc += len(ref)
                    hyps.append([])
                    continue
                from htk_jax.algo.latops import best_path

                _s, path = best_path(lat)
                hyp = [w for (w, _t, _a) in path
                       if w not in ("!NULL", "", None)]
                e, _r = oracle_error(lat, ref)
                _s2, path2 = best_path_trigram(lat, lm, lm_scale, 0.0)
                hyp2 = [w for (w, _t) in path2]
                errs += wer(ref, hyp)
                orc += e
                resc += wer(ref, hyp2)
                n_arcs += len(lat.arcs)
                hyps.append(hyp2)
            if base_hyps is None:
                # reference point: the widest configuration's rescored
                # transcripts (mode-independent at a wide-open beam) —
                # both modes' search errors count against the same truth
                base_hyps = hyps
            diff = sum(h != b for h, b in zip(hyps, base_hyps))
            audio = sum(f.shape[0] for f in feats) * 0.01
            print(f"{tag:>9} {beam if beam else '-':>8} "
                  f"{top_a if top_a else '-':>5} {lat_beam:>8.0f} | "
                  f"{100 * errs / n_ref:6.2f} {100 * orc / n_ref:8.2f} "
                  f"{100 * resc / n_ref:6.2f} "
                  f"{100 * diff / N_UTT:10.2f} {dt / audio:7.4f} "
                  f"{n_arcs // N_UTT:9d}", flush=True)


if __name__ == "__main__":
    main()
