"""Single-pass trigram guidance (the `HTKLVRec/HLVRec-LM.c` role).

The LV cross-word step scores each word end under its own token's
trigram context (lvnet._trigram_tables + the xw3 leg in
decode._make_uniform_step) — the word-pair approximation of HLVRec's
LM-state tokens. These tests pin:
  - table semantics (lookup == ARPA back-off arithmetic, max form),
  - neutrality (a trigram section that adds nothing leaves the decode
    bit-identical to the bigram loop),
  - steering (explicit trigrams change pass 1 to the trigram-best path
    and the score matches the exact lattice rescoring),
  - lattice arithmetic (acoustic scores are unchanged by guidance —
    the subtraction uses exactly what pass 1 added),
  - top-A exactness when A covers every live word end.
"""

import numpy as np
import pytest

from htk_jax.algo.decode import (_host_lm3_lookup, decode,
                                 generate_lattice)
from htk_jax.algo.lvnet import _trigram_tables, compile_lv_loop
from htk_jax.io.dictionary import Vocab
from htk_jax.io.lm import NGramLM

from test_decode import emit_frames, separable_set
from test_lvdecode import make_lm, make_vocab


def make_trilm(words=("A", "I", "S"), tri=None, bows=None):
    """make_lm's bigram loop promoted to order 3: every bigram gets a
    trigram back-off weight (default ln 0.7) and `tri` supplies
    explicit trigrams {(u, v, w): ln p}."""
    lm = make_lm(words)
    lm.order = 3
    all_w = list(words) + ["!ENTER"]
    for k in list(lm.bigrams):
        p, _bo = lm.bigrams[k]
        bow = (bows or {}).get(k, np.log(0.7))
        lm.bigrams[k] = (p, bow)
    for k, p in (tri or {}).items():
        assert k[0] in all_w and k[1] in all_w
        lm.trigrams[k] = p
    return lm


def _expected_lm3(lm, u, v, w):
    """Back-off-NETWORK (max) semantics, as the decoder applies them."""
    bi = max(lm.bigrams[(v, w)][0],
             lm.unigrams[v][1] + lm.unigrams[w][0])
    e = lm.trigrams.get((u, v, w))
    b = lm.bigrams.get((u, v))
    tribow = b[1] if b is not None else 0.0
    out = tribow + bi
    if e is not None and e > out:
        out = e
    return out


class TestTables:
    def test_lookup_matches_arpa(self):
        words = ["A", "I", "S"]
        tri = {("A", "I", "A"): np.log(0.8),
               ("I", "A", "S"): np.log(0.6),
               ("!ENTER", "A", "I"): np.log(0.9)}
        lm = make_trilm(tri=tri, bows={("A", "I"): np.log(0.3)})
        comp = separable_set()
        net = compile_lv_loop(words, make_vocab(), comp, lm=lm,
                              trigram=True)
        assert net.xw_trigram is not None
        lm3 = _host_lm3_lookup(net)
        for ur in range(3):
            for vr in range(3):
                for wr in range(3):
                    got = lm3(ur, vr, wr)[0]
                    want = _expected_lm3(lm, words[ur], words[vr],
                                         words[wr])
                    assert got == pytest.approx(want, abs=1e-5), (
                        words[ur], words[vr], words[wr])
        # no-predecessor tokens use the sentence-start context
        got = lm3(-1, 0, 1)[0]
        assert got == pytest.approx(
            _expected_lm3(lm, "!ENTER", "A", "I"), abs=1e-5)

    def test_multi_pron_rows(self):
        """Pronunciation variants share their word's contexts and
        targets."""
        v = Vocab()
        v.add_pron("A", ["aa"])
        v.add_pron("A", ["aa", "iy"])  # second row for A
        v.add_pron("I", ["iy"])
        v.add_pron("S", ["sil"], out_sym="")
        words = ["A", "I", "S"]
        lm = make_trilm(tri={("A", "I", "A"): np.log(0.8)})
        comp = separable_set()
        net = compile_lv_loop(words, v, comp, lm=lm, trigram=True)
        lm3 = _host_lm3_lookup(net)
        # rows: 0, 1 = A's prons; 2 = I; 3 = S
        want = _expected_lm3(lm, "A", "I", "A")
        for ur in (0, 1):
            for wr in (0, 1):
                assert lm3(ur, 2, wr)[0] == pytest.approx(want, abs=1e-5)

    def test_bigram_lm_gives_no_tables(self):
        comp = separable_set()
        net = compile_lv_loop(["A", "I", "S"], make_vocab(), comp,
                              lm=make_lm(), trigram=True)
        assert net.xw_trigram is None
        assert net.xw_backoff is None  # small net: dense path kept


class TestDecode:
    def test_neutral_trigrams_change_nothing(self):
        """tribow = 0 and no explicit trigrams: guided == bigram loop."""
        words = ["A", "I", "S"]
        lm = make_trilm(bows={k: 0.0 for k in make_lm().bigrams})
        lm.trigrams[("A", "A", "A")] = np.log(1e-8)  # never competitive
        comp = separable_set()
        v = make_vocab()
        net_g = compile_lv_loop(words, v, comp, lm=lm, trigram=True)
        assert net_g.xw_trigram is not None
        net_b = compile_lv_loop(words, v, comp, lm=make_lm(),
                                factored=True)
        for seed, seq in ((3, ["sil", "aa", "iy", "aa", "sil"]),
                          (9, ["iy", "iy", "sil", "aa"])):
            feats = emit_frames(seq, seed=seed)
            rg = decode(net_g, comp, feats, lm_scale=2.0, word_pen=-1.0)
            rb = decode(net_b, comp, feats, lm_scale=2.0, word_pen=-1.0)
            assert rg is not None and rb is not None
            assert rg.words == rb.words and rg.times == rb.times
            assert rg.score == pytest.approx(rb.score, rel=1e-6)

    def test_trigram_steers_the_beam(self):
        """An explicit trigram strong enough to outweigh the acoustics
        flips the decode; without guidance the bigram pass misses it."""
        words = ["A", "I", "S"]
        comp = separable_set()
        v = make_vocab()
        # the third segment (constant 2.3) acoustically prefers sil
        # (center 0) over aa (center 5) by ~40 nats; the explicit
        # trigram (A, I, A) vs the tiny (A, I) back-off weight is worth
        # ~85 at lm_scale 8, so guidance flips the transcript
        tri = {("A", "I", "A"): np.log(0.95)}
        lm = make_trilm(tri=tri, bows={("A", "I"): np.log(1e-4)})
        feats = np.concatenate([emit_frames(["aa", "iy"], seed=3),
                                np.full((8, 3), 2.3, np.float32)])
        net_g = compile_lv_loop(words, v, comp, lm=lm, trigram=True)
        net_b = compile_lv_loop(words, v, comp, lm=lm, factored=True)
        rb = decode(net_b, comp, feats, lm_scale=8.0)
        rg = decode(net_g, comp, feats, lm_scale=8.0)
        assert rb is not None and rg is not None
        assert rb.words == ["A", "I"]  # S is a silence (empty out_sym)
        assert rg.words == ["A", "I", "A"]

    def test_guided_score_equals_exact_rescore(self):
        """Pass-1 guided 1-best == exact trigram best path over the
        lattice (no approximation bites on this utterance).

        Non-boundary mode: best_path_trigram ignores the end-exit LM
        term and charges wdpenalty on the first word (conventions that
        cancel only in relative comparisons), so the identity holds
        after adding them back.
        """
        from htk_jax.algo.latops import best_path_trigram

        words = ["A", "I", "S"]
        comp = separable_set()
        v = make_vocab()
        tri = {("A", "I", "A"): np.log(0.95),
               ("I", "A", "I"): np.log(0.9)}
        lm = make_trilm(tri=tri)
        net = compile_lv_loop(words, v, comp, lm=lm, trigram=True)
        feats = emit_frames(["aa", "iy", "aa", "iy"], seed=5)
        lat, res = generate_lattice(net, comp, feats, lm_scale=4.0,
                                    word_pen=-1.0, lattice_beam=500.0,
                                    want_result=True)
        assert lat is not None and res is not None
        score, path = best_path_trigram(lat, lm, 4.0, -1.0)
        wl = [w for (w, _t) in path if w not in ("!NULL", "", "S")]
        assert wl == list(res.words)
        last = path[-1][0]
        adj = score + 4.0 * lm.logp_bi(last, "!EXIT") - (-1.0)
        assert adj == pytest.approx(res.score, rel=1e-6)

    def test_guided_score_equals_exact_rescore_boundary(self):
        """Boundary mode (<s>/</s> as obligatory rows): pass-1 guided
        1-best score == the exact trigram rescore with no convention
        adjustments (</s> is a real scored node; word_pen 0)."""
        from htk_jax.algo.latops import best_path_trigram

        v = Vocab()
        v.add_pron("A", ["aa"])
        v.add_pron("I", ["iy"])
        v.add_pron("<s>", ["sil"], out_sym="")
        v.add_pron("</s>", ["sil"], out_sym="")
        words = ["A", "I"]
        lm = NGramLM(order=3)
        for w, p in (("A", 0.3), ("I", 0.3), ("<s>", 0.2), ("</s>", 0.2)):
            lm.unigrams[w] = (np.log(p), np.log(0.1))
        for w1 in ("A", "I", "<s>"):
            for w2 in ("A", "I", "</s>"):
                lm.bigrams[(w1, w2)] = (np.log(0.25), np.log(0.5))
        lm.trigrams[("<s>", "A", "I")] = np.log(0.9)
        lm.trigrams[("A", "I", "</s>")] = np.log(0.8)
        comp = separable_set()
        net = compile_lv_loop(words, v, comp, lm=lm, trigram=True,
                              sent_start="<s>", sent_end="</s>",
                              start_word="<s>", end_word="</s>")
        feats = emit_frames(["sil", "aa", "iy", "sil"], seed=3)
        lat, res = generate_lattice(net, comp, feats, lm_scale=4.0,
                                    lattice_beam=500.0, want_result=True)
        assert lat is not None and res is not None
        score, path = best_path_trigram(lat, lm, 4.0, 0.0,
                                        sent_start="<s>")
        wl = [w for (w, _t) in path if w not in ("!NULL", "", "<s>",
                                                 "</s>")]
        assert wl == list(res.words) == ["A", "I"]
        assert score == pytest.approx(res.score, rel=1e-6)

    def test_lattice_acoustics_unchanged_by_guidance(self):
        """Guidance changes LM scores, never acoustics: arcs present in
        both lattices carry identical aclike."""
        words = ["A", "I", "S"]
        comp = separable_set()
        v = make_vocab()
        lm = make_trilm(tri={("A", "I", "A"): np.log(0.95)})
        net_g = compile_lv_loop(words, v, comp, lm=lm, trigram=True)
        net_b = compile_lv_loop(words, v, comp, lm=lm, factored=True)
        feats = emit_frames(["aa", "iy", "aa"], seed=7)
        lg = generate_lattice(net_g, comp, feats, lm_scale=2.0,
                              lattice_beam=500.0)
        lb = generate_lattice(net_b, comp, feats, lm_scale=2.0,
                              lattice_beam=500.0)
        assert lg is not None and lb is not None

        def arcmap(lat):
            out = {}
            for a in lat.arcs:
                ns, ne = lat.nodes[a.start], lat.nodes[a.end]
                out[(ns.word, round(ns.time, 6), ne.word,
                     round(ne.time, 6))] = a
            return out

        mg, mb = arcmap(lg), arcmap(lb)
        common = set(mg) & set(mb)
        assert len(common) >= 3
        for k in common:
            assert mg[k].aclike == pytest.approx(mb[k].aclike, rel=1e-4,
                                                 abs=1e-3), k

    def test_topa_nonbinding_exact(self):
        from test_lvdecode import TestFactoredCrossWord

        comp, v, words, lm2, _lex = TestFactoredCrossWord._big_fixture()
        lm = make_trilm(tuple(words),
                        tri={("W3", "W4", "W3"): np.log(0.9)})
        net = compile_lv_loop(words, v, comp, lm=lm, trigram=True)
        assert net.xw_backoff["succ_j"] is not None
        for seed, seq in ((3, ["aa", "iy", "aa", "iy", "aa"]),
                          (9, ["sil", "aa", "iy", "sil"])):
            feats = emit_frames(seq, seed=seed)
            r0 = decode(net, comp, feats, lm_scale=2.0, word_pen=-1.0)
            ra = decode(net, comp, feats, lm_scale=2.0, word_pen=-1.0,
                        max_active=6)
            assert r0 is not None and ra is not None
            assert ra.words == r0.words and ra.times == r0.times
            assert ra.score == pytest.approx(r0.score, rel=1e-6)

    def test_boundary_rows(self):
        """STARTWORD/ENDWORD boundary rows carry trigram context: the
        second word is scored P(w | <s>, first)."""
        v = Vocab()
        v.add_pron("A", ["aa"])
        v.add_pron("I", ["iy"])
        v.add_pron("<s>", ["sil"], out_sym="")
        v.add_pron("</s>", ["sil"], out_sym="")
        words = ["A", "I"]
        lm = NGramLM(order=3)
        for w, p in (("A", 0.3), ("I", 0.3), ("<s>", 0.2), ("</s>", 0.2)):
            lm.unigrams[w] = (np.log(p), np.log(0.1))
        for w1 in ("A", "I", "<s>"):
            for w2 in ("A", "I", "</s>"):
                lm.bigrams[(w1, w2)] = (np.log(0.25), np.log(0.5))
        lm.trigrams[("<s>", "A", "I")] = np.log(0.9)
        comp = separable_set()
        net = compile_lv_loop(words, v, comp, lm=lm, trigram=True,
                              sent_start="<s>", sent_end="</s>",
                              start_word="<s>", end_word="</s>")
        assert net.xw_trigram is not None
        feats = emit_frames(["sil", "aa", "iy", "sil"], seed=3)
        r = decode(net, comp, feats, lm_scale=2.0)
        assert r is not None and r.words == ["A", "I"]
        # rows: 0 = <s>, 1 = A, 2 = I, 3 = </s>
        lm3 = _host_lm3_lookup(net)
        assert lm3(0, 1, 2)[0] == pytest.approx(np.log(0.9), abs=1e-5)


class TestMultiPredLattice:
    def test_rescoring_recovers_offpath_trigram(self):
        """Single-pred lattices can only rescore the words pass 1
        chained; with max_preds > 1 (HLVRec lattice semantics) the
        exact trigram rescore can swap in an alternative word at the
        same boundary.

        Y and W share a pronunciation (acoustics tie); the bigram pass
        links ... -> Y -> Z (P(Y|X) > P(W|X)), but the trigram
        (X, W, Z) is far stronger than (X, Y, Z)'s punitive back-off —
        only the alternative-predecessor W -> Z arc makes the swap
        reachable. (Different SEGMENTATIONS remain the job of
        single-pass guidance — alternatives share the winner's
        boundaries by the acoustic-invariance approximation.)"""
        from htk_jax.algo.latops import best_path_trigram

        v = Vocab()
        v.add_pron("X", ["aa"])
        v.add_pron("Y", ["iy"])
        v.add_pron("W", ["iy"])
        v.add_pron("Z", ["sil"])
        words = ["X", "Y", "W", "Z"]
        lm = NGramLM(order=3)
        for w in words:
            lm.unigrams[w] = (np.log(0.2), np.log(0.1))
        lm.unigrams["!ENTER"] = (-99.0, np.log(0.2))
        lm.unigrams["!EXIT"] = (np.log(0.2), 0.0)
        for w1 in words + ["!ENTER"]:
            for w2 in words + ["!EXIT"]:
                if w2 == "!ENTER" or w1 == "!EXIT":
                    continue
                p = 0.3 if (w1, w2) == ("X", "Y") else 0.2
                bow = 1e-3 if (w1, w2) == ("X", "Y") else 0.7
                lm.bigrams[(w1, w2)] = (np.log(p), np.log(bow))
        lm.trigrams[("X", "W", "Z")] = np.log(0.9)
        comp = separable_set()
        net = compile_lv_loop(words, v, comp, lm=lm, factored=True)
        feats = emit_frames(["aa", "iy", "sil"], seed=3)
        lat1 = generate_lattice(net, comp, feats, lm_scale=8.0,
                                lattice_beam=400.0)
        latm = generate_lattice(net, comp, feats, lm_scale=8.0,
                                lattice_beam=400.0, max_preds=6)
        assert len(latm.arcs) > len(lat1.arcs)
        _s1, p1 = best_path_trigram(lat1, lm, 8.0, 0.0)
        _sm, pm = best_path_trigram(latm, lm, 8.0, 0.0)
        w1 = [w for (w, _t) in p1 if w != "!NULL"]
        wm = [w for (w, _t) in pm if w != "!NULL"]
        assert w1 == ["X", "Y", "Z"]  # single-pred: W -> Z missing
        assert wm == ["X", "W", "Z"]  # the alternative arc enables it

    def test_default_unchanged(self):
        words = ["A", "I", "S"]
        comp = separable_set()
        v = make_vocab()
        lm = make_trilm()
        net = compile_lv_loop(words, v, comp, lm=lm, factored=True)
        feats = emit_frames(["aa", "iy", "aa"], seed=7)
        la = generate_lattice(net, comp, feats, lm_scale=2.0)
        lb = generate_lattice(net, comp, feats, lm_scale=2.0,
                              max_preds=1)
        assert len(la.arcs) == len(lb.arcs)

    def test_batch_matches_sequential_multipred(self):
        from htk_jax.algo.decode import generate_lattice_batch
        from test_lvdecode import TestLVBatch

        words = ["A", "I", "S"]
        comp = separable_set()
        v = make_vocab()
        lm = make_trilm(tri={("A", "I", "A"): np.log(0.9)})
        net = compile_lv_loop(words, v, comp, lm=lm, factored=True)
        seqs = [["sil", "aa", "iy", "aa"], ["iy", "aa", "sil"]]
        feats = [emit_frames(s, seed=i + 1) for i, s in enumerate(seqs)]
        latb = generate_lattice_batch(net, comp, feats, lm_scale=2.0,
                                      lattice_beam=300.0, pad_to=16,
                                      max_preds=4)
        for f, lb in zip(feats, latb):
            ls = generate_lattice(net, comp, f, 2.0,
                                  lattice_beam=300.0, max_preds=4)
            TestLVBatch._assert_lat_eq(lb, ls)

    def test_alt_arcs_scored_consistently(self):
        """With bigram (context-free) arc scores, alternative arcs are
        exactly scan-consistent: same-boundary alternatives share the
        winner's internal path, so the lattice's best (ac + s*lm + pen)
        path still equals the 1-best decode score — alternatives widen
        the lattice, never inflate it. (On a trigram-GUIDED lattice the
        arc lmlike is context-dependent and this identity is not
        defined; rescoring there goes through best_path_trigram.)"""
        words = ["A", "I", "S"]
        comp = separable_set()
        v = make_vocab()
        lm = make_trilm(tri={("A", "I", "A"): np.log(0.9)})
        net = compile_lv_loop(words, v, comp, lm=lm, factored=True)
        feats = emit_frames(["aa", "iy", "aa", "iy"], seed=5)
        lat = generate_lattice(net, comp, feats, lm_scale=4.0,
                               word_pen=-1.0, lattice_beam=400.0,
                               max_preds=8)
        from htk_jax.algo.latops import best_path

        lat1 = generate_lattice(net, comp, feats, lm_scale=4.0,
                                word_pen=-1.0, lattice_beam=400.0)
        score, _path = best_path(lat)
        score1, _p1 = best_path(lat1)
        r = decode(net, comp, feats, lm_scale=4.0, word_pen=-1.0)
        # alternatives never inflate the lattice's best path...
        assert score == pytest.approx(score1, rel=1e-6)
        # ...which equals the decode score modulo best_path's charge of
        # wdpenalty on the first word (decode's t=0 entry collects none)
        assert score == pytest.approx(r.score + (-1.0), rel=1e-5)
