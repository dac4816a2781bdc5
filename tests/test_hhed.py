"""HHEd model-surgery tests: item lists, MU splitting, TB clustering, AU."""

import numpy as np
import pytest

from htk_jax.algo.tree import (Question, build_tree, classify, load_trees,
                               parse_triphone, save_trees, state_stats)
from htk_jax.io.mmf import load_mmf, save_mmf
from htk_jax.models.hmmset import compile_hmmset
from htk_jax.models.itemlist import parse_item_list
from htk_jax.models.proto import clone_proto, make_proto
from htk_jax.tools.hhed import Editor, run_script


def mono_set(names=("aa", "iy", "sil"), dim=4, seed=0):
    hs = make_proto(nstates=5, dim=dim, parm_kind="USER")
    cl = clone_proto(hs, "proto", list(names))
    rng = np.random.default_rng(seed)
    for h in cl.hmms.values():
        for si in h.states:
            mp = si.streams[0].mixes[0]
            mp.mean = rng.normal(size=dim).astype(np.float32)
            mp.var = (0.5 + rng.random(dim)).astype(np.float32)
            mp.fix_gconst()
    return cl


class TestItemList:
    def test_patterns(self):
        hs = mono_set()
        items = parse_item_list("{*.transP}", hs)
        assert len(items) == 3 and items[0].kind == "transP"
        items = parse_item_list("{(aa,iy).state[2-4]}", hs)
        assert len(items) == 6
        items = parse_item_list("{*.state[2].mix}", hs)
        assert len(items) == 3 and items[0].kind == "mix"
        items = parse_item_list("{sil.state[3]}", hs)
        assert len(items) == 1 and items[0].state_idx == 3

    def test_triphone_family_pattern(self):
        hs = mono_set(names=("x-aa+y", "z-aa+w", "aa", "iy"))
        items = parse_item_list('{("*-aa+*","aa").state[2]}', hs)
        names = {it.hmm.name for it in items}
        assert names == {"x-aa+y", "z-aa+w", "aa"}


class TestTriphones:
    def test_parse(self):
        assert parse_triphone("l-b+r") == ("l", "b", "r")
        assert parse_triphone("b+r") == (None, "b", "r")
        assert parse_triphone("l-b") == ("l", "b", None)
        assert parse_triphone("b") == (None, "b", None)


class TestScript:
    def test_cl_ti_mu(self, tmp_path):
        hs = mono_set()
        tri_list = tmp_path / "triphones"
        tri_list.write_text("aa-iy+sil\nsil-aa+iy\naa\niy\nsil\n")
        script = (
            f"CL {tri_list}\n"
            "TI T_aa {(*-aa+*,aa).transP}\n"
            "MU 3 {sil.state[2-4].mix}\n"
        )
        ed = Editor(hs)
        run_script(script, ed)
        assert "aa-iy+sil" in hs.hmms
        # transP tying: sil-aa+iy shares with aa
        assert hs.hmms["sil-aa+iy"].transp is hs.hmms["aa"].transp
        # MU: sil states now have 3 mixtures each, weights sum to 1
        for si in hs.hmms["sil"].states:
            se = si.streams[0]
            assert len(se.mixes) == 3
            assert sum(se.weights) == pytest.approx(1.0, rel=1e-5)
        # cloned models compile cleanly
        compile_hmmset(hs)

    def test_tb_clusters_and_au(self, tmp_path):
        # 2 groups of triphones of 'aa' with distinct state-2 means
        names = ["p-aa+x", "b-aa+x", "t-aa+x", "k-aa+x"]
        hs = mono_set(names=tuple(names) + ("aa",))
        for nm in names:
            mp = hs.hmms[nm].states[0].streams[0].mixes[0]
            # p,b alike; t,k alike
            base = 10.0 if nm[0] in "pb" else -10.0
            mp.mean = np.full(4, base, np.float32)
            mp.var = np.ones(4, np.float32)
            mp.fix_gconst()
        ed = Editor(hs)
        script = (
            'QS "L_Stop_V" { p-*,b-* }\n'
            'QS "L_Stop_U" { t-*,k-* }\n'
            "RO 0.0\n"
            'TB 10.0 "ST_aa_2_" {(*-aa+*).state[2]}\n'
            f"ST {tmp_path / 'trees'}\n"
        )
        run_script(script, ed)
        # two clusters expected
        s2 = {id(hs.hmms[nm].states[0]) for nm in names}
        assert len(s2) == 2
        assert hs.hmms["p-aa+x"].states[0] is hs.hmms["b-aa+x"].states[0]
        assert hs.hmms["t-aa+x"].states[0] is hs.hmms["k-aa+x"].states[0]

        # tree file round-trips
        qd, trees = load_trees(str(tmp_path / "trees"))
        assert "L_Stop_V" in qd
        assert len(trees) == 1

        # AU synthesizes an unseen triphone using the loaded trees
        unseen = tmp_path / "all_tri"
        unseen.write_text("g-aa+x\n")
        ed2 = Editor(hs)
        ed2.qdict = qd
        ed2.questions = list(qd.values())
        ed2.trees = trees
        ed2.cmd_au(str(unseen))
        assert "g-aa+x" in hs.hmms
        # 'g' matches neither question -> follows 'no' branches; state tied
        # to one of the two leaf macros
        assert any(
            hs.hmms["g-aa+x"].states[0] is hs.hmms[nm].states[0] for nm in names
        )

    def test_tb_threshold_stops_splitting(self):
        names = ["p-aa+x", "b-aa+x"]
        hs = mono_set(names=tuple(names))
        ed = Editor(hs)
        script = (
            'QS "L1" { p-* }\n'
            "TB 1e9 ST_ {(*-aa+*).state[2]}\n"  # impossible threshold
        )
        run_script(script, ed)
        assert hs.hmms["p-aa+x"].states[0] is hs.hmms["b-aa+x"].states[0]

    def test_mmf_roundtrip_after_surgery(self, tmp_path):
        hs = mono_set()
        ed = Editor(hs)
        run_script("MU 2 {*.state[2-4].mix}\nTI T_all {*.transP}\n", ed)
        p = str(tmp_path / "out.mmf")
        save_mmf(hs, p)
        h2 = load_mmf(p)
        assert h2.hmms["aa"].transp is h2.hmms["iy"].transp
        assert len(h2.hmms["aa"].states[0].streams[0].mixes) == 2
        compile_hmmset(h2)


class TestCompactMixdown:
    def test_co_merges_identical(self, tmp_path):
        hs = mono_set()
        ed = Editor(hs)
        # tie everything between aa and iy so they become identical
        run_script("TI S2 {(aa,iy).state[2]}\nTI S3 {(aa,iy).state[3]}\n"
                   "TI S4 {(aa,iy).state[4]}\nTI TT {(aa,iy).transP}\n", ed)
        lst = str(tmp_path / "tiedlist")
        run_script(f"CO {lst}\n", ed)
        lines = open(lst).read().splitlines()
        assert any(len(l.split()) == 2 for l in lines)  # logical->physical
        assert len(hs.hmms) == 2  # one of aa/iy dropped, sil kept

    def test_md_reduces_mixtures(self):
        hs = mono_set()
        ed = Editor(hs)
        run_script("MU 4 {sil.state[2-4].mix}\nMD 2 {sil.state[2-4].mix}\n", ed)
        for si in hs.hmms["sil"].states:
            se = si.streams[0]
            assert sum(1 for m in se.mixes if m is not None) == 2
            live = [w for w, m in zip(se.weights, se.mixes) if m is not None]
            assert sum(live) == pytest.approx(1.0, rel=1e-5)


class TestStreamSplit:
    def test_ss_splits_and_trains(self):
        from htk_jax.algo.trainer import Trainer, prepare_utterance

        hs = mono_set()
        ed = Editor(hs)
        run_script("SS 2\n", ed)
        assert hs.swidth == [2, 2]
        comp = compile_hmmset(hs)
        assert comp.n_streams == 2
        # trains after splitting
        rng = np.random.default_rng(0)
        utts = [prepare_utterance(comp, "u0",
                                  rng.normal(size=(20, 4)).astype(np.float32),
                                  ["aa", "iy"])]
        accs = Trainer(comp).accumulate(utts)
        assert float(np.asarray(accs.total_logp)) < 0
        assert float(np.asarray(accs.n_utts)) == 1

    def test_sw_shrink_and_grow(self):
        from htk_jax.algo.trainer import Trainer, prepare_utterance

        hs = mono_set()
        ed = Editor(hs)
        # split 4 -> [2,2], then shrink stream 2 to width 1 -> vecsize 3
        run_script("SS 2\nSW 2 1\n", ed)
        assert hs.swidth == [2, 1]
        assert hs.vec_size == 3
        for h in hs.hmms.values():
            for si in h.states:
                mp = si.streams[1].mixes[0]
                assert mp.mean.shape == (1,) and mp.var.shape == (1,)
        # grow stream 1 to width 3: pad mean 0 / var 1
        run_script("SW 1 3\n", ed)
        assert hs.swidth == [3, 1]
        assert hs.vec_size == 4
        mp = hs.hmms["aa"].states[0].streams[0].mixes[0]
        assert mp.mean.shape == (3,)
        assert mp.mean[2] == 0.0 and mp.var[2] == 1.0
        # still compiles and trains at the new widths
        comp = compile_hmmset(hs)
        assert comp.n_streams == 2
        rng = np.random.default_rng(1)
        utts = [prepare_utterance(comp, "u0",
                                  rng.normal(size=(20, 4)).astype(np.float32),
                                  ["aa", "iy"])]
        accs = Trainer(comp).accumulate(utts)
        assert float(np.asarray(accs.total_logp)) < 0

    def test_sw_bad_stream_errors(self):
        from htk_jax.utils.errors import HTKError

        hs = mono_set()
        ed = Editor(hs)
        with pytest.raises(HTKError):
            run_script("SW 3 2\n", ed)


class TestRegClasses:
    def test_rc_builds_and_roundtrips(self, tmp_path):
        from htk_jax.algo.adapt import load_baseclass, save_baseclass

        hs = mono_set()
        ed = Editor(hs)
        run_script("MU 2 {*.state[2-4].mix}\nRC 2 global\n", ed)
        assert "global.cls" in ed.baseclasses
        name, classes, parent, leaf_node = ed.baseclasses["global.cls"]
        comp = compile_hmmset(hs)
        assert name == "global" and len(classes) == comp.n_mix
        assert set(np.unique(classes)) <= {0, 1}
        # tree invariants: root parent -1, children index above parents
        assert parent[0] == -1
        assert all(parent[k] < k for k in range(1, len(parent)))
        assert len(leaf_node) == 2
        p = str(tmp_path / "global.cls")
        save_baseclass(p, name, classes, parent=parent, leaf_node=leaf_node)
        name2, cl2, tree = load_baseclass(p)
        assert name2 == "global"
        np.testing.assert_array_equal(cl2, classes)
        assert tree is not None
        np.testing.assert_array_equal(tree[0], parent)
        np.testing.assert_array_equal(tree[1], leaf_node)


class TestNCUTFVRN:
    def test_nc_clusters_and_ties(self):
        from htk_jax.tools.hhed import Editor, run_script

        hs = mono_set(names=("a1", "a2", "a3", "a4", "a5", "a6"))
        # make a1-a3 near one centre and a4-a6 near another
        for k, nm in enumerate(("a1", "a2", "a3", "a4", "a5", "a6")):
            c = 0.0 if k < 3 else 10.0
            for si in hs.hmms[nm].states:
                mp = si.streams[0].mixes[0]
                mp.mean = (c + 0.1 * k + np.zeros(4)).astype(np.float32)
                mp.fix_gconst()
        ed = Editor(hs)
        run_script("NC 2 ncl {(a1,a2,a3,a4,a5,a6).state[2]}", ed)
        assert "ncl1" in hs.macros["s"] and "ncl2" in hs.macros["s"]
        # states in the same acoustic group share one object
        s = [hs.hmms[n].states[0] for n in
             ("a1", "a2", "a3", "a4", "a5", "a6")]
        assert s[0] is s[1] is s[2]
        assert s[3] is s[4] is s[5]
        assert s[0] is not s[3]

    def test_ut_unties(self):
        from htk_jax.tools.hhed import Editor, run_script

        hs = mono_set()
        ed = Editor(hs)
        run_script("TI shr {(aa,iy).state[2]}", ed)
        assert hs.hmms["aa"].states[0] is hs.hmms["iy"].states[0]
        run_script("UT {(aa,iy).state[2]}", ed)
        assert hs.hmms["aa"].states[0] is not hs.hmms["iy"].states[0]
        assert "shr" not in hs.macros["s"]
        # parameters preserved through the untie
        np.testing.assert_allclose(
            hs.hmms["aa"].states[0].streams[0].mixes[0].mean,
            hs.hmms["iy"].states[0].streams[0].mixes[0].mean)

    def test_fv_floors_and_rn(self, tmp_path):
        from htk_jax.io.mmf import save_mmf
        from htk_jax.tools.hhed import Editor, run_script

        hs = mono_set()
        # a vFloors-style set whose floor exceeds some variances
        vf = mono_set(names=("dummy",))
        vf.macros["v"]["varFloor1"] = np.full(4, 0.9, np.float32)
        save_mmf(vf, str(tmp_path / "vFloors"))
        ed = Editor(hs)
        run_script(f"FV {tmp_path / 'vFloors'}\nRN MYSET", ed)
        for h in hs.hmms.values():
            for si in h.states:
                assert float(si.streams[0].mixes[0].var.min()) >= 0.9 - 1e-6
        assert hs.hmm_set_id == "MYSET"


class TestFCSKFAMM:
    def test_fc_preserves_likelihood_until_retrained(self, tmp_path):
        """FC seeds INVCOVAR = diag(1/var): alignment scores must be
        unchanged, and the saved set must round-trip as FULLC."""
        from htk_jax.algo.composite import build_composite
        from htk_jax.algo.viterbi import align

        hs = mono_set()
        rng = np.random.default_rng(4)
        feats = rng.normal(size=(30, 4)).astype(np.float32)

        def logp(hset):
            comp = compile_hmmset(hset)
            hmm = build_composite(
                comp, [comp.model_id(n) for n in ("aa", "iy", "sil")])
            return align(comp, hmm, feats).score

        before = logp(hs)
        run_script("FC", Editor(hs))
        assert all(mp.cov_kind == "FULLC"
                   for h in hs.hmms.values() for si in h.states
                   for mp in si.streams[0].mixes)
        after = logp(hs)
        assert after == pytest.approx(before, rel=1e-5)
        p = str(tmp_path / "mmf")
        save_mmf(hs, p)
        assert "<INVCOVAR>" in open(p).read()
        assert compile_hmmset(load_mmf(p)).full_cov

    def test_sk_changes_parm_kind(self, tmp_path):
        from htk_jax.io.parmkind import str2parmkind

        hs = mono_set()
        run_script("SK MFCC_E_D_A", Editor(hs))
        p = str(tmp_path / "mmf")
        save_mmf(hs, p)
        assert load_mmf(p).parm_kind == int(str2parmkind("MFCC_E_D_A"))

    def test_fa_builds_and_applies_floor(self):
        hs = mono_set()
        vars_before = np.stack(
            [si.streams[0].mixes[0].var
             for h in hs.hmms.values() for si in h.states])
        avg = vars_before.mean(axis=0)
        run_script("FA 0.8", Editor(hs))
        floor = np.asarray(hs.macros["v"]["varFloor1"])
        np.testing.assert_allclose(floor, 0.8 * avg, rtol=1e-5)
        for h in hs.hmms.values():
            for si in h.states:
                assert np.all(si.streams[0].mixes[0].var >= floor - 1e-7)

    def test_mm_names_macros_and_roundtrips(self, tmp_path):
        hs = mono_set()
        run_script("MM st {(aa,iy).state[2]}", Editor(hs))
        assert "st1" in hs.macros["s"] and "st2" in hs.macros["s"]
        assert hs.macros["s"]["st1"] is hs.hmms["aa"].states[0]
        p = str(tmp_path / "mmf")
        save_mmf(hs, p)
        txt = open(p).read()
        assert '~s "st1"' in txt and '~s "st2"' in txt
        h2 = load_mmf(p)
        np.testing.assert_allclose(
            h2.hmms["aa"].states[0].streams[0].mixes[0].mean,
            hs.hmms["aa"].states[0].streams[0].mixes[0].mean, rtol=1e-5)


class TestTCDPXFSUPS:
    def _two_groups(self):
        hs = mono_set(names=("a1", "a2", "a3", "a4", "a5", "a6"))
        for k, nm in enumerate(("a1", "a2", "a3", "a4", "a5", "a6")):
            c = 0.0 if k < 3 else 10.0
            for si in hs.hmms[nm].states:
                mp = si.streams[0].mixes[0]
                mp.mean = (c + 0.1 * k + np.zeros(4)).astype(np.float32)
                mp.fix_gconst()
        return hs

    def test_tc_threshold_clusters(self):
        hs = self._two_groups()
        ed = Editor(hs)
        # threshold between intra-group (~0.4) and inter-group (~20)
        run_script("TC 3.0 tcl {(a1,a2,a3,a4,a5,a6).state[2]}", ed)
        s = [hs.hmms[n].states[0] for n in
             ("a1", "a2", "a3", "a4", "a5", "a6")]
        assert s[0] is s[1] is s[2]
        assert s[3] is s[4] is s[5]
        assert s[0] is not s[3]
        # a tiny threshold ties nothing together
        hs2 = self._two_groups()
        ed2 = Editor(hs2)
        run_script("TC 0.01 tcl {(a1,a2,a3,a4,a5,a6).state[2]}", ed2)
        s2 = [hs2.hmms[n].states[0] for n in ("a1", "a2", "a3")]
        assert s2[0] is not s2[1]

    def test_mt_makes_triphones_from_biphones(self, tmp_path):
        from htk_jax.utils.errors import HTKError

        hs = mono_set(names=("a-b", "b+c", "b", "a", "c"))
        tri = tmp_path / "tri"
        tri.write_text("a-b+c\n")
        ed = Editor(hs)
        run_script(f"MT {tri}", ed)
        assert "a-b+c" in hs.hmms
        h = hs.hmms["a-b+c"]
        left, right = hs.hmms["a-b"], hs.hmms["b+c"]
        # body is a private clone of the left biphone
        np.testing.assert_array_equal(
            h.states[0].streams[0].mixes[0].mean,
            left.states[0].streams[0].mixes[0].mean)
        assert h.states[0] is not left.states[0]
        # final emitting state tied to the right biphone's
        assert h.states[-1] is right.states[-1]
        # the tie is a ~s macro, so it survives an MMF round trip
        p = str(tmp_path / "mmf")
        save_mmf(hs, p)
        hs2 = load_mmf(p)
        assert (hs2.hmms["a-b+c"].states[-1]
                is hs2.hmms["b+c"].states[-1])
        compile_hmmset(hs)
        # existing models are skipped, non-triphones rejected
        run_script(f"MT {tri}", ed)  # idempotent
        bad = tmp_path / "bad"
        bad.write_text("q\n")
        with pytest.raises(HTKError):
            run_script(f"MT {bad}", ed)
        # missing biphone is a numbered error
        tri2 = tmp_path / "tri2"
        tri2.write_text("c-b+a\n")
        with pytest.raises(HTKError):
            run_script(f"MT {tri2}", ed)

    def test_dp_duplicates_with_sharing(self):
        hs = mono_set()
        ed = Editor(hs)
        run_script('DP "ms" 2 :m :f', ed)
        assert "aa:m" in hs.hmms and "iy:f" in hs.hmms
        assert "aa" in hs.hmms  # originals retained
        # states/mixes are private copies, transitions shared
        assert hs.hmms["aa:m"].states[0] is not hs.hmms["aa"].states[0]
        m0 = hs.hmms["aa"].states[0].streams[0].mixes[0]
        m1 = hs.hmms["aa:m"].states[0].streams[0].mixes[0]
        assert m0 is not m1
        np.testing.assert_array_equal(m0.mean, m1.mean)
        assert hs.hmms["aa:m"].transp is hs.hmms["aa"].transp
        # editing a duplicate must not touch the original
        m1.mean += 1.0
        assert not np.allclose(m0.mean, m1.mean)
        # no copies of copies: the second id clones the ORIGINAL set,
        # not the first id's duplicates (3 originals -> 9 total)
        assert len(hs.hmms) == 9
        assert not any(":m:" in n or ":f:" in n or n.count(":") > 1
                       for n in hs.hmms)

    def test_xf_attaches_and_roundtrips(self, tmp_path):
        from htk_jax.algo.adapt import Transform, save_tmf

        hs = mono_set()
        tmf = str(tmp_path / "in.tmf")
        save_tmf(tmf, "global", Transform(
            kind="CMLLR", A=np.eye(4), b=np.zeros(4)))
        ed = Editor(hs)
        run_script(f"XF {tmf}", ed)
        assert hs.input_xform and "CMLLR" in hs.input_xform
        p = str(tmp_path / "mmf")
        save_mmf(hs, p)
        hs2 = load_mmf(p)
        assert hs2.input_xform and "CMLLR" in hs2.input_xform
        # binary MMF keeps it too
        pb = str(tmp_path / "mmf.bin")
        save_mmf(hs, pb, binary=True)
        assert load_mmf(pb).input_xform is not None

    def test_su_uneven_split(self):
        hs = mono_set()  # dim 4
        ed = Editor(hs)
        run_script("SU 2 3 1", ed)
        assert hs.stream_widths == [3, 1]
        si = hs.hmms["aa"].states[0]
        assert len(si.streams) == 2
        assert si.streams[0].mixes[0].mean.shape == (3,)
        assert si.streams[1].mixes[0].mean.shape == (1,)

    def test_su_bad_widths_error(self):
        from htk_jax.utils.errors import HTKError

        hs = mono_set()
        ed = Editor(hs)
        with pytest.raises(HTKError):
            run_script("SU 2 3 3", ed)

    def test_ps_allocates_by_occupancy(self, tmp_path):
        hs = mono_set()
        stats = tmp_path / "stats"
        lines = []
        occs = {"aa": 100.0, "iy": 100.0, "sil": 1000.0}
        for i, (nm, occ) in enumerate(occs.items()):
            lines.append(f'{i} "{nm}" {int(occ)} '
                         + " ".join([str(occ)] * 3))
        stats.write_text("\n".join(lines) + "\n")
        ed = Editor(hs)
        run_script(f"LS {stats}\nPS 2 0.5", ed)
        n_aa = len([m for m in hs.hmms["aa"].states[0].streams[0].mixes
                    if m is not None])
        n_sil = len([m for m in hs.hmms["sil"].states[0].streams[0].mixes
                     if m is not None])
        assert n_sil > n_aa >= 1
