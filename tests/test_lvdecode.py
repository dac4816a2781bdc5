"""LVCSR decode path: uniform-row networks (algo/lvnet), pruning,
equivalence with the general decoder, lattices, batching."""

import numpy as np
import pytest

from htk_jax.algo.decode import decode, decode_batch, generate_lattice
from htk_jax.algo.lvnet import compile_lv_loop, lm_loop_matrices
from htk_jax.algo.net import compile_network
from htk_jax.io.dictionary import Vocab
from htk_jax.io.lm import NGramLM
from htk_jax.tools.hbuild import bigram_lattice, word_loop_lattice

from test_decode import emit_frames, separable_set


def make_vocab():
    v = Vocab()
    v.add_pron("A", ["aa"])
    v.add_pron("I", ["iy"])
    v.add_pron("S", ["sil"], out_sym="")
    return v


def make_lm(words=("A", "I", "S")):
    """Back-off bigram LM whose explicit bigrams dominate the back-off
    path, so network max-semantics == LM replace-semantics."""
    lm = NGramLM(order=2)
    n = len(words)
    for w in words:
        lm.unigrams[w] = (np.log(0.5 / n), np.log(0.1))
    lm.unigrams["!ENTER"] = (-99.0, np.log(0.2))
    lm.unigrams["!EXIT"] = (np.log(0.2), 0.0)
    for w1 in list(words) + ["!ENTER"]:
        for w2 in list(words) + ["!EXIT"]:
            if w2 == "!ENTER" or w1 == "!EXIT":
                continue
            lm.bigrams[(w1, w2)] = (np.log(0.9 / (n + 1)), 0.0)
    return lm


class TestLVLoop:
    def test_matches_general_decoder_no_lm(self):
        comp = separable_set()
        v = make_vocab()
        words = ["A", "I", "S"]
        net_g = compile_network(word_loop_lattice(words, probs=[0.0] * 3),
                                v, comp)
        net_lv = compile_lv_loop(words, v, comp)
        assert net_lv.uniform_width is not None
        for seed, seq in ((3, ["sil", "aa", "iy", "aa", "sil"]),
                          (5, ["iy", "sil", "iy"])):
            feats = emit_frames(seq, seed=seed)
            rg = decode(net_g, comp, feats)
            rl = decode(net_lv, comp, feats)
            assert rg is not None and rl is not None
            assert rl.words == rg.words
            assert rl.times == rg.times
            assert rl.score == pytest.approx(rg.score, rel=1e-6)

    def test_matches_bigram_network(self):
        comp = separable_set()
        v = make_vocab()
        words = ["A", "I", "S"]
        lm = make_lm()
        net_g = compile_network(
            bigram_lattice(words, lm, "!ENTER", "!EXIT"), v, comp)
        net_lv = compile_lv_loop(words, v, comp, lm=lm)
        feats = emit_frames(["sil", "aa", "iy", "aa", "sil"], seed=3)
        rg = decode(net_g, comp, feats, lm_scale=1.0)
        rl = decode(net_lv, comp, feats, lm_scale=1.0)
        assert rg is not None and rl is not None
        assert rl.words == rg.words
        assert rl.score == pytest.approx(rg.score, rel=1e-6)

    def test_lm_loop_matrices_backoff(self):
        lm = make_lm()
        lm.bigrams.pop(("A", "I"))  # force back-off for this pair
        tr, se, ee = lm_loop_matrices(["A", "I", "S"], lm)
        assert tr[0, 1] == pytest.approx(lm.logp_bi("A", "I"))
        assert tr[0, 2] == pytest.approx(lm.logp_bi("A", "S"))
        assert se[1] == pytest.approx(lm.logp_bi("!ENTER", "I"))
        assert ee[0] == pytest.approx(lm.logp_bi("A", "!EXIT"))


class TestLVPruning:
    def _nets(self):
        comp = separable_set()
        net = compile_lv_loop(["A", "I", "S"], make_vocab(), comp,
                              lm=make_lm())
        feats = emit_frames(["sil", "aa", "iy", "aa", "iy", "sil"], seed=11)
        return comp, net, feats

    def test_nonbinding_beams_exact(self):
        """genBeam and maxActive that don't bind leave the result
        bit-identical to the unpruned decode."""
        comp, net, feats = self._nets()
        r0 = decode(net, comp, feats)
        r1 = decode(net, comp, feats, beam=1e9, max_active=net.n_nodes)
        r2 = decode(net, comp, feats, beam=500.0, max_active=2)
        assert r1.words == r0.words and r1.score == pytest.approx(
            r0.score, rel=1e-9)
        # 3 words but only 2 can be alive at once here; top-2 is exact
        assert r2.words == r0.words and r2.score == pytest.approx(
            r0.score, rel=1e-6)

    def test_binding_beam_still_decodes(self):
        comp, net, feats = self._nets()
        r = decode(net, comp, feats, beam=30.0, max_active=1)
        assert r is not None and len(r.words) >= 1


class TestLVLattice:
    def test_lattice_best_path_matches(self):
        from htk_jax.algo.latops import best_path

        comp = separable_set()
        net = compile_lv_loop(["A", "I", "S"], make_vocab(), comp,
                              lm=make_lm())
        feats = emit_frames(["sil", "aa", "iy", "sil"], seed=7)
        lat, res = generate_lattice(net, comp, feats, want_result=True)
        assert lat is not None and res is not None
        score, path = best_path(lat)
        words = [w for (w, _t, _a) in path if w not in ("!NULL", "", "S")]
        assert words == list(res.words)


class TestLVBatch:
    def test_batched_equals_sequential(self):
        comp = separable_set()
        net = compile_lv_loop(["A", "I", "S"], make_vocab(), comp,
                              lm=make_lm())
        seqs = [["sil", "aa", "iy", "aa", "sil"],
                ["sil", "iy", "sil"],
                ["aa", "iy", "aa", "iy"]]
        feats = [emit_frames(s, seed=i + 1) for i, s in enumerate(seqs)]
        batch = decode_batch(net, comp, feats, pad_to=16)
        for f, rb in zip(feats, batch):
            rs = decode(net, comp, f)
            assert rb.words == rs.words and rb.times == rs.times
            assert rb.score == pytest.approx(rs.score, rel=1e-6)

    @staticmethod
    def _assert_lat_eq(la, lb):
        assert la is not None and lb is not None
        assert len(la.nodes) == len(lb.nodes)
        assert len(la.arcs) == len(lb.arcs)
        for na, nb in zip(la.nodes, lb.nodes):
            assert na.word == nb.word
            assert na.time == pytest.approx(nb.time, abs=1e-9)
        for aa, ab in zip(la.arcs, lb.arcs):
            assert (aa.start, aa.end) == (ab.start, ab.end)
            assert aa.aclike == pytest.approx(ab.aclike, rel=1e-5,
                                              abs=1e-4)
            assert aa.lmlike == pytest.approx(ab.lmlike, rel=1e-5,
                                              abs=1e-4)

    def test_lattice_batch_equals_sequential(self):
        from htk_jax.algo.decode import generate_lattice_batch

        comp = separable_set()
        net = compile_lv_loop(["A", "I", "S"], make_vocab(), comp,
                              lm=make_lm())
        seqs = [["sil", "aa", "iy", "aa", "sil"],
                ["sil", "iy", "sil"],
                ["aa", "iy", "aa", "iy"]]
        feats = [emit_frames(s, seed=i + 1) for i, s in enumerate(seqs)]
        latb = generate_lattice_batch(net, comp, feats, lm_scale=2.0,
                                      word_pen=-1.0, lattice_beam=300.0,
                                      pad_to=16)
        for f, lb in zip(feats, latb):
            ls = generate_lattice(net, comp, f, 2.0, -1.0,
                                  lattice_beam=300.0)
            self._assert_lat_eq(lb, ls)

    def test_lattice_batch_tight_beam_resurrection(self):
        """A tight lattice beam forces transitive predecessor
        resurrection through the on-device planes; results must still
        match the sequential builder."""
        from htk_jax.algo.decode import generate_lattice_batch

        comp = separable_set()
        net = compile_lv_loop(["A", "I", "S"], make_vocab(), comp,
                              lm=make_lm())
        seqs = [["sil", "aa", "iy", "aa", "iy", "sil"],
                ["iy", "aa", "sil"]]
        feats = [emit_frames(s, seed=i + 21) for i, s in enumerate(seqs)]
        for lbeam in (5.0, 30.0):
            latb = generate_lattice_batch(net, comp, feats,
                                          lattice_beam=lbeam, pad_to=16)
            for f, lb in zip(feats, latb):
                ls = generate_lattice(net, comp, f, lattice_beam=lbeam)
                self._assert_lat_eq(lb, ls)

    def test_lattice_batch_want_results(self):
        """want_results: the batched 1-best (walked from the compacted
        record planes) equals sequential want_result exactly."""
        from htk_jax.algo.decode import (generate_lattice,
                                         generate_lattice_batch)

        comp = separable_set()
        net = compile_lv_loop(["A", "I", "S"], make_vocab(), comp,
                              lm=make_lm())
        seqs = [["sil", "aa", "iy", "aa", "sil"],
                ["sil", "iy", "sil"],
                ["aa", "iy", "aa", "iy"]]
        feats = [emit_frames(s, seed=i + 1) for i, s in enumerate(seqs)]
        prs = generate_lattice_batch(net, comp, feats, lm_scale=2.0,
                                     word_pen=-1.0, lattice_beam=300.0,
                                     pad_to=16, want_results=True)
        for f, (lb, rb) in zip(feats, prs):
            ls, rs = generate_lattice(net, comp, f, 2.0, -1.0,
                                      lattice_beam=300.0,
                                      want_result=True)
            self._assert_lat_eq(lb, ls)
            assert rb is not None and rs is not None
            assert rb.words == rs.words and rb.times == rs.times
            assert rb.score == pytest.approx(rs.score, rel=1e-5)

    def test_lattice_batch_k_rec_overflow_degrades_gracefully(self, capsys):
        """A record budget below the in-beam count drops the WEAKEST
        records (global-beam-style degradation), warns 8523, and the
        lattice's best path still equals the 1-best decode."""
        from htk_jax.algo.decode import generate_lattice_batch
        from htk_jax.algo.latops import best_path

        comp = separable_set()
        net = compile_lv_loop(["A", "I", "S"], make_vocab(), comp,
                              lm=make_lm())
        feats = [emit_frames(["sil", "aa", "iy", "aa", "sil"], seed=9)]
        full = generate_lattice_batch(net, comp, feats, pad_to=16,
                                      lattice_beam=400.0)
        n_full = len(full[0].arcs)
        budget = max(4, n_full // 3)
        latb = generate_lattice_batch(net, comp, feats, pad_to=16,
                                      lattice_beam=400.0, k_rec=budget)
        err = capsys.readouterr().err
        assert "WARNING [-8523]" in err
        assert latb[0] is not None
        assert len(latb[0].arcs) < n_full
        r = decode(net, comp, feats[0])
        _score, path = best_path(latb[0])
        words = [w for (w, _t, _a) in path if w not in ("!NULL", "", "S")]
        assert words == list(r.words)

    def test_lattice_batch_topk_cap(self):
        """k_lat below the row count still produces a usable lattice
        whose best path equals the 1-best decode."""
        from htk_jax.algo.decode import generate_lattice_batch
        from htk_jax.algo.latops import best_path

        comp = separable_set()
        net = compile_lv_loop(["A", "I", "S"], make_vocab(), comp,
                              lm=make_lm())
        feats = [emit_frames(["sil", "aa", "iy", "sil"], seed=7)]
        latb = generate_lattice_batch(net, comp, feats, pad_to=16,
                                      k_lat=2)
        assert latb[0] is not None
        r = decode(net, comp, feats[0])
        _score, path = best_path(latb[0])
        words = [w for (w, _t, _a) in path if w not in ("!NULL", "", "S")]
        assert words == list(r.words)


class TestFactoredCrossWord:
    def test_factored_equals_dense(self):
        """Back-off-factored cross-word == dense matrix decode (the LM
        here has explicit >= back-off everywhere, where the two agree
        exactly; see lvnet._factored_rows on the max-vs-replace
        distinction)."""
        comp = separable_set()
        v = make_vocab()
        words = ["A", "I", "S"]
        lm = make_lm()
        net_f = compile_lv_loop(words, v, comp, lm=lm, factored=True)
        net_d = compile_lv_loop(words, v, comp, lm=lm, factored=False)
        assert net_f.xw_backoff is not None
        assert net_d.xw_backoff is None
        for seed, seq in ((3, ["sil", "aa", "iy", "aa", "sil"]),
                          (9, ["iy", "iy", "sil", "aa"])):
            feats = emit_frames(seq, seed=seed)
            rf = decode(net_f, comp, feats, lm_scale=3.0, word_pen=-2.0)
            rd = decode(net_d, comp, feats, lm_scale=3.0, word_pen=-2.0)
            assert rf is not None and rd is not None
            assert rf.words == rd.words
            assert rf.times == rd.times
            assert rf.score == pytest.approx(rd.score, rel=1e-6)

    @staticmethod
    def _big_fixture():
        """10 multi-phone words over the 3 separable models: enough rows
        that top-A actually prunes, with clean frames so few word ends
        are ever live."""
        comp = separable_set()
        v = Vocab()
        lex = {
            "W0": ["aa"], "W1": ["iy"], "W2": ["sil"],
            "W3": ["aa", "iy"], "W4": ["iy", "aa"],
            "W5": ["aa", "sil"], "W6": ["sil", "iy"],
            "W7": ["aa", "iy", "aa"], "W8": ["iy", "sil", "iy"],
            "W9": ["sil", "aa", "sil"],
        }
        for w, ph in lex.items():
            v.add_pron(w, ph)
        words = sorted(lex)
        lm = make_lm(tuple(words))
        return comp, v, words, lm, lex

    def test_factored_topa_matches_exact(self):
        """Non-binding top-A on the factored explicit leg reproduces the
        exact bucketed-gather decode (clean frames: few live ends)."""
        comp, v, words, lm, lex = self._big_fixture()
        net = compile_lv_loop(words, v, comp, lm=lm, factored=True)
        assert net.xw_backoff["succ_j"] is not None
        for seed, seq in ((3, ["aa", "iy", "aa", "iy", "aa"]),
                          (9, ["sil", "aa", "iy", "sil"])):
            feats = emit_frames(seq, seed=seed)
            r0 = decode(net, comp, feats, lm_scale=2.0, word_pen=-1.0)
            ra = decode(net, comp, feats, lm_scale=2.0, word_pen=-1.0,
                        max_active=6)
            assert r0 is not None and ra is not None
            assert ra.words == r0.words
            assert ra.times == r0.times
            assert ra.score == pytest.approx(r0.score, rel=1e-6)

    def test_factored_topa_binding_still_decodes(self):
        comp, v, words, lm, _lex = self._big_fixture()
        net = compile_lv_loop(words, v, comp, lm=lm, factored=True)
        feats = emit_frames(["aa", "iy", "sil"], seed=5)
        r = decode(net, comp, feats, max_active=1)
        assert r is not None and len(r.words) >= 1

    def test_backoff_leg_used_when_bigram_missing(self):
        comp = separable_set()
        v = make_vocab()
        lm = make_lm()
        lm.bigrams.pop(("A", "I"))  # A -> I must take bow(A) + uni(I)
        net = compile_lv_loop(["A", "I", "S"], v, comp, lm=lm,
                              factored=True)
        x = net.xw_backoff
        # row 1 (word I) has no explicit pred from row 0 (word A)
        from htk_jax.algo.decode import _host_lm_lookup
        lm_of = _host_lm_lookup(net)
        assert lm_of(0, 1) == pytest.approx(lm.logp_bi("A", "I"), abs=1e-5)
        assert lm_of(0, 2) == pytest.approx(lm.logp_bi("A", "S"), abs=1e-5)
        feats = emit_frames(["sil", "aa", "iy", "sil"], seed=4)
        r = decode(net, comp, feats)
        assert r is not None and r.words == ["A", "I"]


class TestBatchedUniformScan:
    def test_batch_equals_vmapped_single(self):
        import jax
        import jax.numpy as jnp

        from htk_jax.algo.decode import (_net_dev, decode_scan_uniform,
                                         decode_scan_uniform_batch)

        comp = separable_set()
        net = compile_lv_loop(["A", "I", "S"], make_vocab(), comp,
                              lm=make_lm(), factored=False)
        d = _net_dev(net)
        rng = np.random.default_rng(0)
        B, T = 3, 40
        outp = jnp.asarray(
            rng.normal(size=(B, T, net.n_states)).astype(np.float32) - 4.0)
        S = net.uniform_width
        args = (d["band"], d["a0"], d["aE"], S, d["bonus"],
                d["trans"] * 2.0, d["start"] * 2.0, -1.5)
        one = lambda o: decode_scan_uniform(o, *args)  # noqa: E731
        (v1, wn1, wt1), (W1, p1, q1) = jax.vmap(one)(outp)
        (v2, wn2, wt2), (W2, p2, q2) = decode_scan_uniform_batch(outp, *args)
        np.testing.assert_allclose(np.asarray(v2), np.asarray(v1),
                                   atol=1e-5)
        assert np.array_equal(np.asarray(wn2), np.asarray(wn1))
        assert np.array_equal(np.asarray(wt2), np.asarray(wt1))
        np.testing.assert_allclose(np.asarray(W2), np.asarray(W1),
                                   atol=1e-5)
        assert np.array_equal(np.asarray(p2), np.asarray(p1))
        assert np.array_equal(np.asarray(q2), np.asarray(q1))


class TestLongUtteranceChunking:
    def test_long_decode_chunks_and_concatenates(self):
        """A >32767-frame utterance decodes via low-energy-cut chunks;
        the transcript equals the concatenation of the per-chunk
        decodes and the old numbered error is gone."""
        from htk_jax.algo.decode import (CHUNK_T, REC_TMASK,
                                         _decode_chunked)

        comp = separable_set()
        net = compile_lv_loop(["A", "I", "S"], make_vocab(), comp,
                              lm=make_lm())
        # ~34k frames: repeated word units with silence (low-energy)
        # gaps the cutter can land on
        unit = emit_frames(["aa", "iy", "sil"], frames_per=8, seed=3)
        reps = (REC_TMASK + 2000) // unit.shape[0] + 1
        feats = np.tile(unit, (reps, 1)).astype(np.float32)
        assert feats.shape[0] > REC_TMASK
        r = decode(net, comp, feats)
        assert r is not None
        # every repetition contributes its words
        assert r.words[:2] == ["A", "I"]
        assert len(r.words) == 2 * reps
        # times strictly increasing across chunk boundaries
        t_ends = [t1 for _t0, t1 in r.times]
        assert all(b > a for a, b in zip(t_ends, t_ends[1:]))
        assert t_ends[-1] > CHUNK_T  # words beyond the first chunk

    def test_batch_routes_long_through_chunking(self):
        from htk_jax.algo.decode import REC_TMASK

        comp = separable_set()
        net = compile_lv_loop(["A", "I", "S"], make_vocab(), comp,
                              lm=make_lm())
        unit = emit_frames(["aa", "iy", "sil"], frames_per=8, seed=3)
        reps = (REC_TMASK + 2000) // unit.shape[0] + 1
        long_f = np.tile(unit, (reps, 1)).astype(np.float32)
        short_f = emit_frames(["sil", "aa", "iy", "sil"], seed=5)
        rs = decode_batch(net, comp, [short_f, long_f], pad_to=16)
        assert rs[0] is not None and rs[1] is not None
        assert len(rs[1].words) == 2 * reps
        r_short = decode(net, comp, short_f)
        assert rs[0].words == r_short.words
