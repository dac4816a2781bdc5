"""Cross-word triphone network expansion (HNet cross-word case)."""

import numpy as np
import pytest

from htk_jax.algo.decode import decode
from htk_jax.algo.net import (_edge_phones, _xword_phones, compile_network,
                              make_context_lookup)
from htk_jax.io.dictionary import Vocab
from htk_jax.models.hmmset import compile_hmmset
from htk_jax.models.proto import clone_proto, make_proto
from htk_jax.tools.hbuild import word_loop_lattice

from test_decode import emit_frames, separable_set

CF = frozenset({"sp"})


def loop_vocab():
    v = Vocab()
    v.add_pron("A", ["aa"])
    v.add_pron("I", ["iy"])
    v.add_pron("S", ["sil"], out_sym="")
    return v


class TestContextMapping:
    def test_edge_phones_skip_cf(self):
        assert _edge_phones(["aa", "sp"], CF) == ("aa", "aa")
        assert _edge_phones(["sp"], CF) == ("sp", "sp")
        assert _edge_phones(["k", "ae", "t"], CF) == ("k", "t")

    def test_xword_phone_names(self):
        names = ["sil-aa+iy", "aa+iy", "k-ae+t", "k", "ae", "t", "aa", "sp"]
        best = make_context_lookup(names)
        # single-phone word takes both contexts from the neighbours
        assert _xword_phones(["aa"], "sil", "iy", CF, best) == ["sil-aa+iy"]
        # missing triphone falls back down the FindModel chain
        assert _xword_phones(["aa"], "k", "iy", CF, best) == ["aa+iy"]
        # interior phones stay word-internal; edges take cross contexts
        assert _xword_phones(["k", "ae", "t"], None, None, CF, best) == [
            "k", "k-ae+t", "t"]
        # cf phones stay monophone and are skipped for context
        assert _xword_phones(["aa", "sp"], "sil", "iy", CF, best) == [
            "sil-aa+iy", "sp"]


class TestCrossWordNetwork:
    def test_monophone_fallback_parity(self):
        """With a monophone-only set, the cross-word expansion falls back
        to the same models — variant nodes change the structure but not
        the decode result."""
        comp = separable_set()
        lat = word_loop_lattice(["A", "I", "S"])
        v = loop_vocab()
        net_i = compile_network(lat, v, comp)
        net_x = compile_network(lat, v, comp, cross_word=True)
        # with a monophone set every (l, r) variant resolves to the SAME
        # model chain, so the exact variant-dedup collapses the network
        # back to the word-internal size — no interior blow-up
        assert net_x.n_nodes == net_i.n_nodes
        feats = emit_frames(["sil", "aa", "iy", "aa", "sil"], seed=3)
        res_i = decode(net_i, comp, feats)
        res_x = decode(net_x, comp, feats)
        assert res_x is not None
        assert res_x.words == res_i.words == ["A", "I", "A"]
        assert res_x.score == pytest.approx(res_i.score, rel=1e-6)

    def _triphone_set(self, dim=3):
        """Monophones + all l-p+r clones; the correct-context triphones
        are moved onto distinct centers so only cross-word expansion can
        score the matched data well."""
        phones = ["aa", "iy", "sil"]
        tri = [f"{l}-{p}+{r}" for p in ("aa", "iy")
               for l in phones for r in phones]
        hs = make_proto(nstates=4, dim=dim, parm_kind="USER")
        cl = clone_proto(hs, "proto", phones + tri)
        base = {"aa": 5.0, "iy": -5.0, "sil": 0.0}
        for nm, h in cl.hmms.items():
            p = nm.split("-")[-1].split("+")[0]
            c = base[p] + (1.5 if "-" in nm or "+" in nm else 0.0)
            for k, si in enumerate(h.states):
                mp = si.streams[0].mixes[0]
                mp.mean = np.full(dim, c, np.float32) + 0.3 * k
                mp.var = np.full(dim, 0.6, np.float32)
                mp.fix_gconst()
        return compile_hmmset(cl)

    def test_triphones_score_better(self):
        comp = self._triphone_set()
        lat = word_loop_lattice(["A", "I", "S"])
        v = loop_vocab()
        net_i = compile_network(lat, v, comp)
        net_x = compile_network(lat, v, comp, cross_word=True)

        # emit at the *triphone* centers (base + 1.5) for aa/iy, base for sil
        rng = np.random.default_rng(7)
        centers = {"aa": 6.5, "iy": -3.5, "sil": 0.0}
        seq = ["sil", "aa", "iy", "aa", "sil"]
        feats = np.concatenate([
            centers[p] + 0.3 * rng.normal(size=(8, 3)) for p in seq
        ]).astype(np.float32)

        res_i = decode(net_i, comp, feats)
        res_x = decode(net_x, comp, feats)
        assert res_x is not None and res_i is not None
        assert res_x.words == ["A", "I", "A"]
        # word-internal single-phone words only reach monophones: the
        # cross-word net must beat it on triphone-matched data
        assert res_x.score > res_i.score + 10.0


class TestInteriorSharing:
    def _full_tri_set(self, dim=3):
        """All triphones over {k, ae, t, s}: a fully cross-word-trained
        set where no two context variants resolve to the same models, so
        only structural sharing can shrink the network."""
        phones = ["k", "ae", "t", "s"]
        tri = [f"{l}-{p}+{r}" for p in phones for l in phones
               for r in phones]
        hs = make_proto(nstates=4, dim=dim, parm_kind="USER")
        cl = clone_proto(hs, "proto", phones + tri)
        base = {"k": 6.0, "ae": 0.0, "t": -6.0, "s": 3.0}
        for nm, h in cl.hmms.items():
            p = nm.split("-")[-1].split("+")[0]
            for k_, si in enumerate(h.states):
                mp = si.streams[0].mixes[0]
                mp.mean = np.full(dim, base[p], np.float32) + 0.2 * k_
                mp.var = np.full(dim, 0.6, np.float32)
                mp.fix_gconst()
        return compile_hmmset(cl)

    def _emit(self, seq, seed=3):
        rng = np.random.default_rng(seed)
        base = {"k": 6.0, "ae": 0.0, "t": -6.0, "s": 3.0}
        return np.concatenate([
            base[p] + 0.3 * rng.normal(size=(6, 3)) for p in seq
        ]).astype(np.float32)

    def test_shared_interiors_shrink_and_match(self):
        comp = self._full_tri_set()
        v = Vocab()
        v.add_pron("KAT", ["k", "ae", "t"])
        v.add_pron("TAK", ["t", "ae", "k"])
        v.add_pron("SKS", ["s", "k", "s"])
        lat = word_loop_lattice(["KAT", "TAK", "SKS"])
        net_f = compile_network(lat, v, comp, cross_word=True)
        net_s = compile_network(lat, v, comp, cross_word=True,
                                share_interiors=True)
        assert net_s.node_cont is not None
        # fully distinct variants: sharing must cut states >= 2x
        assert net_f.n_states >= 2 * net_s.n_states
        for seed, seq in ((3, ["k", "ae", "t", "t", "ae", "k"]),
                          (9, ["s", "k", "s", "k", "ae", "t"]),
                          (11, ["t", "ae", "k", "s", "k", "s",
                                "k", "ae", "t"])):
            feats = self._emit(seq, seed)
            rf = decode(net_f, comp, feats, lm_scale=2.0, word_pen=-1.0)
            rs = decode(net_s, comp, feats, lm_scale=2.0, word_pen=-1.0)
            assert rf is not None and rs is not None
            assert rs.words == rf.words
            assert rs.times == rf.times
            assert rs.score == pytest.approx(rf.score, rel=1e-6)

    def test_share_off_is_bit_identical_to_before(self):
        """share_interiors=False must not change anything (default)."""
        comp = self._full_tri_set()
        v = Vocab()
        v.add_pron("KAT", ["k", "ae", "t"])
        lat = word_loop_lattice(["KAT"])
        net_a = compile_network(lat, v, comp, cross_word=True)
        net_b = compile_network(lat, v, comp, cross_word=True,
                                share_interiors=False)
        assert net_a.n_states == net_b.n_states
        assert net_a.n_nodes == net_b.n_nodes
        np.testing.assert_array_equal(net_a.trans, net_b.trans)
        assert net_a.node_cont is None
