"""Tests for HInit/HRest/HLStats/HDMan/HParse/HSGen/HLEd."""

import os
import numpy as np
import pytest

from htk_jax.io.dictionary import Vocab, read_dict
from htk_jax.io.lm import read_arpa
from htk_jax.io.mlf import Label, Transcription
from htk_jax.io.slf import read_slf
from htk_jax.tools.hdman import apply_script
from htk_jax.tools.hled import LabelEditor
from htk_jax.tools.hlstats import estimate_backoff_bigram
from htk_jax.tools.hparse import parse_grammar
from htk_jax.algo.kmeans import kmeans, segment_kmeans_gmm


class TestKMeans:
    def test_two_clusters(self):
        rng = np.random.default_rng(0)
        a = rng.normal(size=(50, 2)) + [10, 0]
        b = rng.normal(size=(50, 2)) - [10, 0]
        x = np.concatenate([a, b])
        assign, means = kmeans(x, 2)
        assert len(set(assign[:50])) == 1
        assert len(set(assign[50:])) == 1
        assert assign[0] != assign[50]

    def test_gmm_from_segment(self):
        rng = np.random.default_rng(1)
        x = np.concatenate(
            [rng.normal(size=(60, 3)) + 5, rng.normal(size=(40, 3)) - 5]
        )
        w, m, v = segment_kmeans_gmm(x, 2)
        assert w.sum() == pytest.approx(1.0)
        assert sorted(np.round(m[:, 0] / 5).astype(int).tolist()) == [-1, 1]


class TestHLStats:
    def test_bigram_estimation(self, tmp_path):
        sents = [["a", "b"], ["a", "b"], ["a", "c"], ["b", "a"]]
        lm = estimate_backoff_bigram(sents)
        # P(b|a) should dominate P(c|a)
        assert lm.logp_bi("a", "b") > lm.logp_bi("a", "c")
        # backoff path returns a finite prob for unseen pairs
        assert lm.logp_bi("c", "b") > -50
        # ARPA roundtrip
        from htk_jax.io.lm import write_arpa

        p = str(tmp_path / "lm.arpa")
        write_arpa(lm, p)
        lm2 = read_arpa(p)
        assert lm2.logp_bi("a", "b") == pytest.approx(lm.logp_bi("a", "b"), abs=1e-3)

    def test_binary_lm_roundtrip_bitstable(self, tmp_path):
        """write -> read -> write is byte-identical; values match the
        ARPA source at f32 precision; read_lm sniffs all three
        containers; incompatible versions raise the numbered error."""
        from htk_jax.io.lm import (BINLM_MAGIC, NGramLM, read_binary_lm,
                                   read_lm, write_binary_lm)
        from htk_jax.utils.errors import HTKError

        sents = [["a", "b"], ["a", "b"], ["a", "c"], ["b", "a"]]
        lm = estimate_backoff_bigram(sents)
        lm.trigrams[("a", "b", "a")] = -1.25
        p1 = str(tmp_path / "lm.bin")
        p2 = str(tmp_path / "lm2.bin")
        write_binary_lm(lm, p1)
        lm2 = read_binary_lm(p1)
        write_binary_lm(lm2, p2)
        assert open(p1, "rb").read() == open(p2, "rb").read()
        assert lm2.logp_bi("a", "b") == pytest.approx(
            lm.logp_bi("a", "b"), abs=1e-6)
        assert lm2.logp_tri("a", "b", "a") == pytest.approx(-1.25,
                                                            abs=1e-6)
        assert lm2.logp_bi("c", "b") == pytest.approx(
            lm.logp_bi("c", "b"), abs=1e-6)  # back-off weights survive
        # sniffing: binary and ARPA through one entry point
        pa = str(tmp_path / "lm.arpa")
        from htk_jax.io.lm import write_arpa

        write_arpa(lm, pa)
        assert read_lm(p1).bigrams.keys() == read_lm(pa).bigrams.keys()
        # version guard
        bad = open(p1, "rb").read().replace(
            BINLM_MAGIC + b"1 ", BINLM_MAGIC + b"9 ", 1)
        pb = tmp_path / "bad.bin"
        pb.write_bytes(bad)
        with pytest.raises(HTKError) as ei:
            read_binary_lm(str(pb))
        assert "8152" in str(ei.value)

    def test_lbuild_savebinary_and_consumers(self, tmp_path, monkeypatch):
        """LBuild with HLM: SAVEBINARY = T emits the binary container;
        LPlex and HBuild consume it transparently."""
        import os

        from htk_jax.tools import hbuild, lbuild, lplex

        monkeypatch.chdir(tmp_path)
        open("train.txt", "w").write(
            "<s> a b a c </s>\n<s> b a b </s>\n<s> a b </s>\n")
        open("cfg", "w").write("HLM: SAVEBINARY = T\n")
        open("wmap", "w").write("a\nb\nc\n")
        assert lbuild.run(["-C", "cfg", "-n", "2", "wmap", "lm.bin",
                           "train.txt"]) == 0
        from htk_jax.io.lm import BINLM_MAGIC

        assert open("lm.bin", "rb").read().startswith(BINLM_MAGIC)
        open("words", "w").write("a\nb\nc\n")
        assert hbuild.run(["-n", "lm.bin", "words", "net.slf"]) == 0
        assert "!NULL" in open("net.slf").read()
        assert lplex.run(["lm.bin", "train.txt"]) == 0

    def test_matrix_bigram_roundtrip(self, tmp_path):
        from htk_jax.io.lm import read_matrix_bigram, write_matrix_bigram

        sents = [["a", "b"], ["a", "b"], ["a", "c"], ["b", "a"]]
        lm = estimate_backoff_bigram(sents)
        order = ["!ENTER", "a", "b", "c", "!EXIT"]
        p = str(tmp_path / "lm.mat")
        write_matrix_bigram(lm, order, p)
        # rows renormalise over the matrix columns; relative order of
        # successors must survive the round trip
        lm2 = read_matrix_bigram(p)
        assert lm2.logp_bi("a", "b") > lm2.logp_bi("a", "c")
        assert lm2.logp_bi("b", "a") > lm2.logp_bi("b", "c")

    def test_hlstats_matrix_default_and_hbuild(self, tmp_path, monkeypatch):
        """HLStats default -b output is the matrix form; HBuild -n
        consumes it (sniffed vs ARPA)."""
        import os

        from htk_jax.tools import hbuild, hlstats

        monkeypatch.chdir(tmp_path)
        open("wlist", "w").write("a\nb\nc\n")
        with open("train.mlf", "w") as f:
            f.write("#!MLF!#\n")
            for i, s in enumerate((["a", "b"], ["a", "c"], ["b", "a"])):
                f.write(f'"*/u{i}.lab"\n' + "\n".join(s) + "\n.\n")
        assert hlstats.run(["-b", "big.mat", "-I", "train.mlf",
                            "wlist"]) == 0
        text = open("big.mat").read()
        assert "\\data\\" not in text  # matrix, not ARPA
        assert text.split()[0] == "!ENTER"
        assert hbuild.run(["-n", "big.mat", "wlist", "net.slf"]) == 0
        assert os.path.exists("net.slf")
        # -o gives the ARPA back-off form
        assert hlstats.run(["-o", "-b", "big.arpa", "-I", "train.mlf",
                            "wlist"]) == 0
        assert "\\data\\" in open("big.arpa").read()


class TestHDMan:
    def test_script_commands(self):
        v = Vocab()
        v.add_pron("HELLO", ["hh", "ax", "l", "ow1"])
        v.add_pron("WORLD", ["w", "er1", "l", "d"])
        apply_script(v, "RS cmu\nAS sp\nRP ax aa\n")
        assert v.words["HELLO"].prons[0].phones == ["hh", "ax", "l", "ow", "sp"]
        assert v.words["WORLD"].prons[0].phones == ["w", "er", "l", "d", "sp"]
        apply_script(v, "MP axl ax l\n")
        assert v.words["HELLO"].prons[0].phones == ["hh", "axl", "ow", "sp"]
        apply_script(v, "DP sp\n")
        assert v.words["HELLO"].prons[0].phones[-1] == "ow"

    def test_context_conversion(self):
        v = Vocab()
        v.add_pron("CAT", ["k", "ae", "t"])
        apply_script(v, "TC\n")
        assert v.words["CAT"].prons[0].phones == ["k+ae", "k-ae+t", "ae-t"]
        v2 = Vocab()
        v2.add_pron("CAT", ["k", "ae", "t"])
        apply_script(v2, "TC sil sil\n")
        assert v2.words["CAT"].prons[0].phones == [
            "sil-k+ae", "k-ae+t", "ae-t+sil"]
        v3 = Vocab()
        v3.add_pron("CAT", ["k", "ae", "t"])
        apply_script(v3, "LC\n")
        assert v3.words["CAT"].prons[0].phones == ["k", "k-ae", "ae-t"]
        v4 = Vocab()
        v4.add_pron("CAT", ["k", "ae", "t"])
        apply_script(v4, "RC\n")
        assert v4.words["CAT"].prons[0].phones == ["k+ae", "ae+t", "t"]

    def test_cr_contexts(self):
        v = Vocab()
        v.add_pron("ABBA", ["ax", "b", "ax", "b"])
        # replace b by p only between ax_ax
        apply_script(v, "CR p ax b ax\n")
        assert v.words["ABBA"].prons[0].phones == ["ax", "p", "ax", "b"]
        # wildcard context reaches the word edge
        apply_script(v, "CR d ax b *\n")
        assert v.words["ABBA"].prons[0].phones == ["ax", "p", "ax", "d"]
        # concrete context never matches past the edge
        v2 = Vocab()
        v2.add_pron("B", ["b"])
        apply_script(v2, "CR p ax b ax\n")
        assert v2.words["B"].prons[0].phones == ["b"]

    def test_dd_deletes_single_pron(self):
        v = Vocab()
        v.add_pron("A", ["ax"])
        v.add_pron("A", ["ey"])
        apply_script(v, "DD A ax\n")
        assert [p.phones for p in v.words["A"].prons] == [["ey"]]
        apply_script(v, "DD A ey\n")
        assert "A" not in v.words  # word gone with its last pron

    def test_ds_deletes_by_source(self):
        v = Vocab()
        v.add_pron("A", ["ax"])
        v.add_pron("A", ["ey"])
        v.words["A"].prons[0].source = "/dicts/cmu.dict"
        v.words["A"].prons[1].source = "/dicts/beep.dict"
        apply_script(v, "DS cmu.dict\n")  # basename match
        assert [p.phones for p in v.words["A"].prons] == [["ey"]]

    def test_lp_up_case(self):
        v = Vocab()
        v.add_pron("Cat", ["k"])
        v.add_pron("CAT", ["kk"])
        apply_script(v, "LP\n")
        assert list(v.words) == ["cat"]
        assert [p.phones for p in v.words["cat"].prons] == [["k"], ["kk"]]
        apply_script(v, "UP\n")
        assert list(v.words) == ["CAT"]


class TestHParse:
    def test_digit_loop(self, tmp_path):
        g = """
        $digit = one | two | three;
        ( sent-start < $digit > sent-end )
        """
        lat = parse_grammar(g)
        words = {n.word for n in lat.nodes}
        assert {"one", "two", "three", "sent-start", "sent-end"} <= words
        assert lat.start_node() is not None
        # network admits repeated digits: check a back arc exists
        # (plus-loop: exit null -> entry null)
        from htk_jax.io.slf import write_slf

        p = str(tmp_path / "g.slf")
        write_slf(lat, p)
        l2 = read_slf(p)
        assert len(l2.arcs) == len(lat.arcs)

    def test_optional_and_star(self):
        lat = parse_grammar("( [a] {b} c )")
        words = [n.word for n in lat.nodes]
        assert "a" in words and "b" in words and "c" in words

    def test_undefined_var(self):
        from htk_jax.utils.errors import HTKError

        with pytest.raises(HTKError):
            parse_grammar("( $nope )")


class TestHLEd:
    def test_ex_tc_pipeline(self):
        v = Vocab()
        v.add_pron("ONE", ["w", "ah", "n"])
        v.add_pron("TWO", ["t", "uw"])
        ed = LabelEditor(v)
        ed.parse_script("EX\nIS sil sil\nWB sil\nTC\n")
        tr = Transcription(alternatives=[[Label("ONE"), Label("TWO")]])
        out = ed.apply(tr)
        names = [l.name for l in out.labels]
        assert names == [
            "sil", "w+ah", "w-ah+n", "ah-n+t", "n-t+uw", "t-uw", "sil",
        ]

    def test_wb_blocks_context(self):
        v = Vocab()
        v.add_pron("ONE", ["w", "ah", "n"])
        ed = LabelEditor(v)
        ed.parse_script("EX\nIS sil sil\nWB sil\nTC\n")
        tr = Transcription(alternatives=[[Label("ONE")]])
        out = ed.apply(tr)
        # sil gives no context: w has no left context
        assert out.labels[1].name == "w+ah"
        assert out.labels[3].name == "ah-n"

    def test_merge_replace_delete(self):
        ed = LabelEditor()
        ed.parse_script("RE x y z\nME q a b\nDE junk\n")
        tr = Transcription(
            alternatives=[[Label("y"), Label("a"), Label("b"), Label("junk")]]
        )
        out = ed.apply(tr)
        assert [l.name for l in out.labels] == ["x", "q"]


class TestWaveFormats:
    def test_aiff_roundtrip(self, tmp_path):
        import struct
        import numpy as np
        from htk_jax.io.wavefile import read_wave

        s = np.arange(-50, 50, dtype=">i2")
        # 80-bit extended float for 16000.0: exp=16383+13, mant=16000<<50
        rate = 16000
        exp = 16383 + 13
        mant = rate << 50
        comm = struct.pack(">HIH", 1, 100, 16) + struct.pack(">HQ", exp, mant)
        ssnd = struct.pack(">II", 0, 0) + s.tobytes()
        body = (b"COMM" + struct.pack(">I", len(comm)) + comm
                + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd)
        raw = b"FORM" + struct.pack(">I", 4 + len(body)) + b"AIFF" + body
        p = str(tmp_path / "a.aiff")
        open(p, "wb").write(raw)
        w = read_wave(p, fmt="AIFF")
        assert w.samp_period == 625
        np.testing.assert_array_equal(w.samples, np.arange(-50, 50))

    def test_sunau_linear16(self, tmp_path):
        import struct
        import numpy as np
        from htk_jax.io.wavefile import read_wave

        s = np.arange(0, 30, dtype=">i2")
        hdr = b".snd" + struct.pack(">IIIII", 24, len(s) * 2, 3, 8000, 1)
        p = str(tmp_path / "a.au")
        open(p, "wb").write(hdr + s.tobytes())
        w = read_wave(p, fmt="SUNAU8")
        assert w.samp_period == 1250
        np.testing.assert_array_equal(w.samples, np.arange(0, 30))

    def test_sunau_ulaw_silence(self, tmp_path):
        import struct
        import numpy as np
        from htk_jax.io.wavefile import read_wave

        # mu-law 0xFF encodes 0
        hdr = b".snd" + struct.pack(">IIIII", 24, 8, 1, 8000, 1)
        p = str(tmp_path / "u.au")
        open(p, "wb").write(hdr + b"\xff" * 8)
        w = read_wave(p, fmt="AU")
        assert np.all(np.abs(w.samples) <= 8)


class TestLM4:
    def test_fourgram_roundtrip(self, tmp_path):
        from htk_jax.io.lm import read_arpa, write_arpa
        from htk_jax.tools.lbuild import build_lm

        sents = [["a", "b", "c", "d"], ["a", "b", "c", "e"],
                 ["a", "b", "c", "d"]]
        lm = build_lm(sents, order=4)
        assert lm.fourgrams
        # 4-gram prefers the majority continuation
        assert lm.logp_4("a", "b", "c", "d") > lm.logp_4("a", "b", "c", "e")
        p = str(tmp_path / "lm4.arpa")
        write_arpa(lm, p)
        lm2 = read_arpa(p)
        assert lm2.order == 4
        assert lm2.logp_4("a", "b", "c", "d") == pytest.approx(
            lm.logp_4("a", "b", "c", "d"), abs=1e-3
        )

    def test_subset(self):
        from htk_jax.tools.lbuild import build_lm
        from htk_jax.tools.lsubset import subset

        lm = build_lm([["a", "b"], ["c", "d"]], order=2)
        out = subset(lm, {"a", "b", "<s>", "</s>"})
        assert "c" not in out.unigrams
        assert ("a", "b") in out.bigrams


class TestHList:
    def test_htk_file_header_and_rows(self, tmp_path, monkeypatch, capsys):
        from htk_jax.io import parmkind as pk
        from htk_jax.io.htkfeat import write_htk_file
        from htk_jax.tools import hlist

        monkeypatch.chdir(tmp_path)
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        write_htk_file("a.usr", x, 100000, pk.str2parmkind("USER"))
        assert hlist.run(["a.usr"]) == 0
        out = capsys.readouterr().out
        assert "Sample Kind: USER" in out
        assert "Num Samples:          3" in out
        assert "    2:" in out and "11.000" in out
        # -h suppresses observations, keeps the header
        assert hlist.run(["-h", "a.usr"]) == 0
        out = capsys.readouterr().out
        assert "Sample Kind: USER" in out and "    0:" not in out

    def test_wav_source_shows_target_block(self, tmp_path, monkeypatch,
                                           capsys):
        import sys
        sys.path.insert(0, os.path.dirname(__file__))
        from test_e2e import synth, write_wav
        from htk_jax.tools import hlist

        monkeypatch.chdir(tmp_path)
        rng = np.random.default_rng(0)
        write_wav("a.wav", synth(["aa"], rng))
        open("cfg", "w").write(
            "SOURCEFORMAT = WAV\nTARGETKIND = MFCC_E\n")
        assert hlist.run(["-C", "cfg", "-z", "a.wav"]) == 0
        out = capsys.readouterr().out
        assert "Sample Kind: WAVEFORM" in out
        assert "Target" in out and "Sample Kind: MFCC_E" in out
        assert "    0:" not in out


class TestHCompVSegments:
    def test_l_restricts_stats_to_label(self, tmp_path, monkeypatch):
        from htk_jax.io import parmkind as pk
        from htk_jax.io.htkfeat import write_htk_file
        from htk_jax.io.mmf import load_mmf, save_mmf
        from htk_jax.models.proto import make_proto
        from htk_jax.tools import hcompv

        monkeypatch.chdir(tmp_path)
        rng = np.random.default_rng(0)
        kind = pk.str2parmkind("USER")
        mlf = ["#!MLF!#"]
        # first 50 frames labelled 'hi' at +5, next 50 'lo' at -5
        for i in range(2):
            x = np.concatenate([
                5.0 + 0.1 * rng.normal(size=(50, 4)),
                -5.0 + 0.1 * rng.normal(size=(50, 4)),
            ]).astype(np.float32)
            write_htk_file(f"u{i}.usr", x, 100000, kind)
            mlf += [f'"*/u{i}.lab"',
                    "0 5000000 hi", "5000000 10000000 lo", "."]
        open("lab.mlf", "w").write("\n".join(mlf) + "\n")
        open("train.scp", "w").write("u0.usr\nu1.usr")
        save_mmf(make_proto(nstates=5, dim=4, parm_kind="USER"), "proto")

        assert hcompv.run(["-m", "-l", "hi", "-I", "lab.mlf", "-M", "hi",
                           "-S", "train.scp", "proto"]) == 0
        m = load_mmf("hi/proto").hmms["proto"].states[0].streams[0] \
            .mixes[0].mean
        assert np.all(np.abs(m - 5.0) < 0.2)  # only 'hi' frames counted

        # without -l the mean sits between the clusters
        assert hcompv.run(["-m", "-M", "all", "-S", "train.scp",
                           "proto"]) == 0
        m2 = load_mmf("all/proto").hmms["proto"].states[0].streams[0] \
            .mixes[0].mean
        assert np.all(np.abs(m2) < 0.5)


class TestHLEdExtra:
    def test_ch_sb(self):
        ed = LabelEditor()
        ed.parse_script("CH b a\nSB sil\n")
        tr = Transcription(alternatives=[[
            Label("sil"), Label("a"), Label("c"), Label("sil")]])
        out = ed.apply(tr)
        assert [l.name for l in out.labels] == ["b", "c"]


class TestHSGen:
    def test_walks_and_stats(self, tmp_path, monkeypatch, capsys):
        from htk_jax.tools import hbuild, hsgen

        monkeypatch.chdir(tmp_path)
        open("wl", "w").write("one\ntwo\n")
        open("dict", "w").write("one o\ntwo t\n")
        assert hbuild.run(["wl", "net.slf"]) == 0
        assert hsgen.run(["-n", "10", "-l", "net.slf", "dict"]) == 0
        out = capsys.readouterr().out.splitlines()
        assert len(out) == 10 and out[0].startswith("1.")
        assert hsgen.run(["-n", "10", "-q", "-s", "net.slf", "dict"]) == 0
        out = capsys.readouterr().out
        assert "Perplexity" in out and "Average Sentence Length" in out


class TestHResultsSpeakers:
    def test_k_mask_per_speaker_table(self, tmp_path, monkeypatch, capsys):
        """HResults -k %%%* groups utterances by the captured speaker id
        and prints the SPKR breakdown table with per-speaker error."""
        # mask */%%%%_* captures the 4 chars between "*/" and "_"
        from htk_jax.tools import hresults

        monkeypatch.chdir(tmp_path)
        open("words.mlf", "w").write(
            '#!MLF!#\n'
            '"*/spkA_1.lab"\nONE\nTWO\n.\n'
            '"*/spkA_2.lab"\nONE\n.\n'
            '"*/spkB_1.lab"\nTWO\nTWO\n.\n')
        open("rec.mlf", "w").write(
            '#!MLF!#\n'
            '"*/spkA_1.rec"\nONE\nTWO\n.\n'      # spkA: all correct
            '"*/spkA_2.rec"\nONE\n.\n'
            '"*/spkB_1.rec"\nTWO\nONE\n.\n')     # spkB: 1 sub of 2
        open("list", "w").write("ONE\nTWO\n")
        assert hresults.run(["-I", "words.mlf", "-k", "*/%%%%_*",
                             "list", "rec.mlf"]) == 0
        out = capsys.readouterr().out
        assert "| SPKR" in out
        a = [l for l in out.splitlines() if l.startswith("| spkA")][0]
        b = [l for l in out.splitlines() if l.startswith("| spkB")][0]
        assert "100.00" in a and "    2 |" in a  # 2 sentences, all correct
        assert " 50.00" in b                      # 50% corr / 50% sub


class TestHResultsDNW:
    def test_d_scores_best_alternative(self, tmp_path, monkeypatch,
                                       capsys):
        """-d N oracle-scores the best of the first N alternatives
        (HVite -n N-best MLFs use /// separators)."""
        from htk_jax.tools import hresults

        monkeypatch.chdir(tmp_path)
        open("ref.mlf", "w").write(
            '#!MLF!#\n"*/u1.lab"\nONE\nTWO\n.\n')
        open("rec.mlf", "w").write(
            '#!MLF!#\n"*/u1.rec"\nONE\nONE\n///\nONE\nTWO\n.\n')
        open("list", "w").write("ONE\nTWO\n")
        # without -d: first alternative only -> 1 sub
        assert hresults.run(["-I", "ref.mlf", "list", "rec.mlf"]) == 0
        out = capsys.readouterr().out
        assert "%Corr=50.00" in out
        # -d 2: second alternative is perfect
        assert hresults.run(["-I", "ref.mlf", "-d", "2", "list",
                             "rec.mlf"]) == 0
        out = capsys.readouterr().out
        assert "%Corr=100.00, Acc=100.00" in out

    def test_n_nist_table(self, tmp_path, monkeypatch, capsys):
        from htk_jax.tools import hresults

        monkeypatch.chdir(tmp_path)
        open("ref.mlf", "w").write(
            '#!MLF!#\n"*/u1.lab"\nONE\nTWO\n.\n"*/u2.lab"\nTWO\n.\n')
        open("rec.mlf", "w").write(
            '#!MLF!#\n"*/u1.rec"\nONE\nONE\n.\n"*/u2.rec"\nTWO\n.\n')
        open("list", "w").write("ONE\nTWO\n")
        assert hresults.run(["-I", "ref.mlf", "-n", "list",
                             "rec.mlf"]) == 0
        out = capsys.readouterr().out
        assert "| Sum/Avg |" in out
        row = [l for l in out.splitlines() if "Sum/Avg" in l][0]
        # 2 sentences, 3 ref words, 2 hits, 1 sub: 66.67 corr, 33.33 sub
        assert "2" in row and "66.67" in row and "33.33" in row
        assert "SENT:" not in out

    def test_w_figure_of_merit(self, tmp_path, monkeypatch, capsys):
        """-w: hits/FAs per keyword and FOM. One keyword, 1h of audio,
        2 true occurrences; spots: best-scored hits first, then an FA —
        detection stays 100% for every FA band -> FOM 100; a second
        run with the hit below the FA drops the first band."""
        from htk_jax.tools import hresults

        monkeypatch.chdir(tmp_path)
        HOUR = 36_000_000_000  # 100ns units
        open("ref.mlf", "w").write(
            '#!MLF!#\n"*/u1.lab"\n'
            f"0 1000000 KEY\n2000000 3000000 KEY\n"
            f"3000000 {HOUR} FILLER\n.\n")
        open("list", "w").write("KEY\n")
        # both true occurrences found above the FA
        open("rec.mlf", "w").write(
            '#!MLF!#\n"*/u1.rec"\n'
            "0 1000000 KEY -10.0\n2000000 3000000 KEY -12.0\n"
            "5000000 6000000 KEY -90.0\n.\n")
        assert hresults.run(["-I", "ref.mlf", "-w", "list",
                             "rec.mlf"]) == 0
        out = capsys.readouterr().out
        assert "Figure of Merit" in out
        krow = [l for l in out.splitlines() if l.strip().startswith("KEY")][0]
        assert "100.00" in krow  # FOM
        assert krow.split()[1:4] == ["2", "1", "2"]  # hits, FAs, actual
        # second hit hidden BELOW two false alarms. HTKBook FOM:
        # p_i = % true hits found BEFORE the i-th false alarm, so
        # p1 = p2 = 50% (one hit outranks both FAs), p3..p10 = 100%
        open("rec2.mlf", "w").write(
            '#!MLF!#\n"*/u1.rec"\n'
            "0 1000000 KEY -10.0\n5000000 6000000 KEY -12.0\n"
            "7000000 8000000 KEY -13.0\n"
            "2000000 3000000 KEY -90.0\n.\n")
        assert hresults.run(["-I", "ref.mlf", "-w", "list",
                             "rec2.mlf"]) == 0
        out = capsys.readouterr().out
        krow = [l for l in out.splitlines() if l.strip().startswith("KEY")][0]
        # FOM over 10 bands: (50 + 50 + 100*8) / 10
        assert "90.00" in krow
        assert krow.split()[1:4] == ["2", "2", "2"]
