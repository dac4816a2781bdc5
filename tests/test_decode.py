"""Decode stack tests: dict/SLF parsing, alignment, word-loop recognition."""

import math

import numpy as np
import pytest

from htk_jax.algo.composite import build_composite
from htk_jax.algo.decode import decode
from htk_jax.algo.net import compile_network
from htk_jax.algo.viterbi import align
from htk_jax.io.dictionary import Vocab, read_dict, write_dict
from htk_jax.io.slf import read_slf, write_slf
from htk_jax.models.hmmset import compile_hmmset
from htk_jax.models.proto import clone_proto, make_proto
from htk_jax.tools.hbuild import word_loop_lattice
from htk_jax.tools.hresults import dp_align, strip_context

from test_fb import numpy_fb_reference, small_set
from htk_jax.algo.trainer import prepare_utterance


def separable_set(dim=3, seed=0):
    """Three 1-mix monophones with well-separated means."""
    hs = make_proto(nstates=4, dim=dim, parm_kind="USER")
    cl = clone_proto(hs, "proto", ["aa", "iy", "sil"])
    centers = {"aa": 5.0, "iy": -5.0, "sil": 0.0}
    for nm, h in cl.hmms.items():
        for k, si in enumerate(h.states):
            mp = si.streams[0].mixes[0]
            mp.mean = np.full(dim, centers[nm], np.float32) + 0.3 * k
            mp.var = np.full(dim, 0.6, np.float32)
            mp.fix_gconst()
    return compile_hmmset(cl)


def emit_frames(seq, frames_per=8, dim=3, seed=0):
    rng = np.random.default_rng(seed)
    centers = {"aa": 5.0, "iy": -5.0, "sil": 0.0}
    out = []
    for p in seq:
        out.append(centers[p] + 0.3 * rng.normal(size=(frames_per, dim)))
    return np.concatenate(out).astype(np.float32)


class TestDictSLF:
    def test_dict_roundtrip(self, tmp_path):
        p = tmp_path / "dict"
        p.write_text(
            "ONE   w ah n\n"
            "TWO   t uw\n"
            "TWO   t uh\n"
            "SIL [] sil\n"
            "SENT-START [s] 0.9 sil\n"
        )
        v = read_dict(str(p))
        assert len(v.words["TWO"].prons) == 2
        assert v.words["SIL"].prons[0].out_sym == ""
        assert v.words["SENT-START"].prons[0].prob == pytest.approx(0.9)
        out = tmp_path / "dict2"
        write_dict(v, str(out))
        v2 = read_dict(str(out))
        assert v2.words["SIL"].prons[0].out_sym == ""
        assert [p.phones for p in v2.words["TWO"].prons] == [["t", "uw"], ["t", "uh"]]

    def test_slf_roundtrip(self, tmp_path):
        lat = word_loop_lattice(["ONE", "TWO"])
        p = str(tmp_path / "wdnet.slf")
        write_slf(lat, p)
        l2 = read_slf(p)
        assert len(l2.nodes) == len(lat.nodes)
        assert len(l2.arcs) == len(lat.arcs)
        assert l2.start_node() == 0
        assert l2.end_node() == 2


class TestAlign:
    def test_alignment_recovers_boundaries(self):
        comp = separable_set()
        seq = ["sil", "aa", "iy", "sil"]
        feats = emit_frames(seq)
        hmm = build_composite(comp, [comp.model_id(p) for p in seq])
        res = align(comp, hmm, feats)
        # each instance should occupy roughly its 8-frame block
        assert len(res.model_seq) == 4
        for k, (inst, t0, t1, _s) in enumerate(res.model_seq):
            assert inst == k
            assert abs(t0 - 8 * k) <= 2
        # viterbi score <= FB logP (max path vs sum over paths)
        logp_ref, *_ = numpy_fb_reference(feats.astype(np.float64), hmm, comp)
        assert res.score <= logp_ref + 1e-3


class TestDecode:
    def make_net(self, comp):
        lat = word_loop_lattice(["A", "I", "S"])
        v = Vocab()
        v.add_pron("A", ["aa"])
        v.add_pron("I", ["iy"])
        v.add_pron("S", ["sil"], out_sym="")
        return compile_network(lat, v, comp)

    def test_word_loop_decode(self):
        comp = separable_set()
        net = self.make_net(comp)
        seq = ["sil", "aa", "iy", "aa", "sil"]
        feats = emit_frames(seq, seed=3)
        res = decode(net, comp, feats)
        assert res is not None
        # S is output-suppressed; word sequence should be A I A
        assert res.words == ["A", "I", "A"]
        # times roughly at 8-frame blocks
        assert abs(res.times[0][0] - 8) <= 2

    def test_insertion_penalty_reduces_words(self):
        comp = separable_set()
        net = self.make_net(comp)
        rng = np.random.default_rng(9)
        # ambiguous audio near zero: loop would happily insert many words
        feats = (0.4 * rng.normal(size=(40, 3))).astype(np.float32)
        res_free = decode(net, comp, feats, word_pen=0.0)
        res_pen = decode(net, comp, feats, word_pen=-50.0)
        assert res_pen is not None and res_free is not None
        assert len(res_pen.word_nodes) <= len(res_free.word_nodes)

    def test_multiple_pronunciations(self):
        comp = separable_set()
        lat = word_loop_lattice(["X"])
        v = Vocab()
        v.add_pron("X", ["aa"])
        v.add_pron("X", ["iy"])
        net = compile_network(lat, v, comp)
        feats = emit_frames(["iy"], frames_per=10, seed=4)
        res = decode(net, comp, feats)
        assert res is not None
        assert res.words == ["X"]


class TestHResults:
    def test_dp_align(self):
        ref = "a b c d".split()
        hyp = "a x c d e".split()
        h, s, d, i, pairs = dp_align(ref, hyp)
        assert (h, s, d, i) == (3, 1, 0, 1)

    def test_strip_context(self):
        assert strip_context("a-b+c") == "b"
        assert strip_context("b+c") == "b"
        assert strip_context("a-b") == "b"
        assert strip_context("b") == "b"


class TestDecodeBatch:
    def test_batched_equals_sequential(self):
        from htk_jax.algo.decode import decode_batch

        comp = separable_set()
        net = TestDecode().make_net(comp)
        seqs = [
            ["sil", "aa", "iy", "aa", "sil"],
            ["sil", "iy", "sil"],
            ["sil", "aa", "aa", "iy", "iy", "sil"],
        ]
        feats = [emit_frames(s, seed=i + 1) for i, s in enumerate(seqs)]
        batch = decode_batch(net, comp, feats, pad_to=16)
        for f, rb in zip(feats, batch):
            rs = decode(net, comp, f)
            assert rb is not None and rs is not None
            assert rb.words == rs.words
            assert rb.times == rs.times
            assert rb.score == pytest.approx(rs.score, rel=1e-6)

    def test_padding_never_leaks(self):
        """Same utterance decoded alone and alongside a much longer one
        (forcing heavy padding) must agree exactly."""
        from htk_jax.algo.decode import decode_batch

        comp = separable_set()
        net = TestDecode().make_net(comp)
        short = emit_frames(["sil", "aa", "sil"], seed=7)
        long = emit_frames(["sil", "iy", "aa", "iy", "aa", "iy", "sil"] * 3,
                           seed=8)
        rb = decode_batch(net, comp, [short, long], pad_to=64)[0]
        rs = decode(net, comp, short)
        assert rb.words == rs.words and rb.score == pytest.approx(
            rs.score, rel=1e-6)


class TestWordPairGrammar:
    def test_hbuild_w_constrains_pairs(self, tmp_path, monkeypatch):
        from htk_jax.tools import hbuild

        monkeypatch.chdir(tmp_path)
        open("wp", "w").write(
            "!ENTER A I\n"
            "A  I\n"
            "I  A !EXIT\n"
        )
        open("wl", "w").write("A\nI\n")
        assert hbuild.run(["-w", "wp", "wl", "wp.slf"]) == 0
        lat = read_slf("wp.slf")

        comp = separable_set()
        v = Vocab()
        v.add_pron("A", ["aa"])
        v.add_pron("I", ["iy"])
        net = compile_network(lat, v, comp)

        # decode sequences and check every transition is a listed pair
        allowed = {("A", "I"), ("I", "A")}
        for seq, seed in ((["aa", "iy", "aa", "iy"], 0), (["iy"], 1)):
            res = decode(net, comp, emit_frames(seq, seed=seed))
            assert res is not None
            ws = res.words
            assert ws[0] in ("A", "I")
            assert ws[-1] == "I"  # only I may precede !EXIT
            for a, b in zip(ws, ws[1:]):
                assert (a, b) in allowed


class TestGenerateLattice:
    def _lat(self, lattice_beam):
        from htk_jax.algo.decode import generate_lattice

        comp = separable_set()
        net = TestDecode().make_net(comp)
        seq = ["sil", "aa", "iy", "aa", "iy", "sil"]
        feats = emit_frames(seq, seed=11)
        lat, res = generate_lattice(net, comp, feats,
                                    lattice_beam=lattice_beam,
                                    want_result=True)
        return lat, res

    def test_tight_beam_never_reroutes_to_start(self):
        """A record whose predecessor fell below the per-frame lattice
        beam must have the predecessor resurrected (or the arc dropped),
        never rerouted to the start node with aclike ~ -LZERO."""
        lat, _ = self._lat(lattice_beam=0.5)
        assert lat is not None
        start = lat.start_node()
        for a in lat.arcs:
            assert abs(a.aclike) < 1e8, (
                f"arc {a.id} has pruned-predecessor garbage aclike {a.aclike}")
            if a.start == start:
                # genuine start arcs only leave from first-word records
                assert lat.nodes[a.end].time <= 0.20

    def test_tight_beam_best_path_matches_1best(self):
        from htk_jax.algo.latops import best_path

        lat, res = self._lat(lattice_beam=0.5)
        score, path = best_path(lat)
        # res.words applies output suppression (S has out_sym "");
        # the lattice keeps the S word nodes, so drop them for comparison
        words = [w for (w, _t, _a) in path if w not in ("!NULL", "", "S")]
        assert words == list(res.words)


class TestGenericLatticeBatch:
    """Batched -z on GENERAL (non-uniform) nets: one padded scan per
    bucket must reproduce the sequential generate_lattice exactly."""

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

    def test_batch_equals_sequential_with_results(self):
        from htk_jax.algo.decode import (generate_lattice,
                                         generate_lattice_batch)

        comp = separable_set()
        net = TestDecode().make_net(comp)
        seqs = [["sil", "aa", "iy", "sil"],
                ["sil", "iy", "aa", "iy", "aa", "sil"],
                ["aa", "iy"]]
        feats = [emit_frames(s, seed=30 + i) for i, s in enumerate(seqs)]
        prs = generate_lattice_batch(net, comp, feats, lm_scale=2.0,
                                     word_pen=-1.0, lattice_beam=300.0,
                                     pad_to=16, want_results=True)
        assert len(prs) == len(feats)
        for f, (lb, rb) in zip(feats, prs):
            ls, rs = generate_lattice(net, comp, f, 2.0, -1.0,
                                      lattice_beam=300.0,
                                      want_result=True)
            self._assert_lat_eq(lb, ls)
            assert rb is not None and rs is not None
            assert rb.words == rs.words and rb.times == rs.times
            assert rb.score == pytest.approx(rs.score, rel=1e-6)

    def test_batch_exact_pad_multiple_uses_carry(self):
        """ADVICE r4: when the longest utterance's length is an exact
        multiple of pad_to, the final records come from the scan CARRY
        instead of plane T — a branch arbitrary emit_frames lengths
        never hit. Trim the longest utterance to a multiple of 16 and
        assert batch == sequential including the 1-best."""
        from htk_jax.algo.decode import (generate_lattice,
                                         generate_lattice_batch)

        comp = separable_set()
        net = TestDecode().make_net(comp)
        seqs = [["sil", "aa", "iy", "sil"], ["iy", "aa", "sil"]]
        feats = [emit_frames(s, seed=50 + i) for i, s in enumerate(seqs)]
        # longest exactly tr == T (= k * pad_to): trailing sil frames
        # trim safely
        longest = max(range(len(feats)), key=lambda i: feats[i].shape[0])
        tlong = (feats[longest].shape[0] // 16) * 16
        feats[longest] = feats[longest][:tlong]
        assert max(f.shape[0] for f in feats) % 16 == 0
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
            assert rb.score == pytest.approx(rs.score, rel=1e-6)

    def test_batch_tight_beam_equals_sequential(self):
        from htk_jax.algo.decode import (generate_lattice,
                                         generate_lattice_batch)

        comp = separable_set()
        net = TestDecode().make_net(comp)
        seqs = [["sil", "aa", "iy", "aa", "sil"], ["iy", "aa", "sil"]]
        feats = [emit_frames(s, seed=40 + i) for i, s in enumerate(seqs)]
        for lbeam in (5.0, 50.0):
            latb = generate_lattice_batch(net, comp, feats,
                                          lattice_beam=lbeam, pad_to=16)
            for f, lb in zip(feats, latb):
                ls = generate_lattice(net, comp, f, lattice_beam=lbeam)
                self._assert_lat_eq(lb, ls)
