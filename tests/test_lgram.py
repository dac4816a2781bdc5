"""Gram-file tools: LNewMap / LGPrep / LGCopy / LFoF / LBuild-from-grams."""

import os

import pytest

from htk_jax.tools import lbuild
from htk_jax.tools.lgram import (WordMap, read_gram, run_lfof, run_lgcopy,
                                 run_lgprep, run_lnewmap)

TEXT1 = "a b a\nb b\n"
TEXT2 = "a b\na a b\n"


@pytest.fixture
def work(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    open("t1.txt", "w").write(TEXT1)
    open("t2.txt", "w").write(TEXT2)
    assert run_lnewmap(["base", "wmap"]) == 0
    return tmp_path


def test_lnewmap_seeds_base_words(work):
    wm = WordMap.load("wmap")
    assert {"!!UNK", "<s>", "</s>"} <= set(wm.ids)
    assert wm.name == "base"


def test_lgprep_counts_and_updates_map(work):
    assert run_lgprep(["-n", "2", "-r", "g1", "wmap", "t1.txt"]) == 0
    o, uni = read_gram("g1.1gram")
    assert o == 1
    assert uni[("a",)] == 2 and uni[("b",)] == 3
    assert uni[("<s>",)] == 2  # one per sentence
    o2, bi = read_gram("g1.2gram")
    assert o2 == 2 and bi[("a", "b")] == 1
    wm = WordMap.load("wmap")
    assert "a" in wm.ids and "b" in wm.ids and wm.seqno == 1


def test_lgcopy_merges_shards(work):
    assert run_lgprep(["-n", "2", "-r", "g1", "wmap", "t1.txt"]) == 0
    assert run_lgprep(["-n", "2", "-r", "g2", "wmap", "t2.txt"]) == 0
    assert run_lgcopy(["-o", "all.2gram", "wmap",
                       "g1.2gram", "g2.2gram"]) == 0
    _o, merged = read_gram("all.2gram")
    # whole-corpus counts
    open("both.txt", "w").write(TEXT1 + TEXT2)
    assert run_lgprep(["-n", "2", "-r", "gb", "wmap", "both.txt"]) == 0
    _o, whole = read_gram("gb.2gram")
    assert merged == whole


def test_lgcopy_remap_oov_to_unk(work, tmp_path):
    assert run_lgprep(["-n", "1", "-r", "g1", "wmap", "t1.txt"]) == 0
    assert run_lnewmap(["small", "smallmap"]) == 0
    wm = WordMap.load("smallmap")
    wm.add("a")
    wm.save("smallmap")
    assert run_lgcopy(["-o", "r.1gram", "-m", "smallmap", "wmap",
                       "g1.1gram"]) == 0
    _o, counts = read_gram("r.1gram")
    assert counts[("!!UNK",)] >= 3  # all b's collapsed


def test_lfof_table(work):
    assert run_lgprep(["-n", "2", "-r", "g1", "wmap", "t1.txt"]) == 0
    assert run_lfof(["-n", "4", "wmap", "fof", "g1.2gram"]) == 0
    rows = {}
    for ln in open("fof"):
        if ln.startswith("!"):
            continue
        o, r, c = ln.split()
        rows[(int(o), int(r))] = int(c)
    # t1: bigrams <s>a, ab(x2), ba, aa? seq1 = <s> a b a </s>:
    # (<s>,a) (a,b) (b,a) (a,</s>); seq2 = <s> b b </s>: (<s>,b) (b,b)
    # (b,</s>) -> singletons 6, none twice
    assert rows[(2, 1)] == 7 and rows[(2, 2)] == 0


def test_lbuild_from_grams_matches_text(work):
    assert run_lgprep(["-n", "2", "-r", "g1", "wmap",
                       "t1.txt", "t2.txt"]) == 0
    assert lbuild.run(["-n", "2", "wmap", "lm_text.arpa",
                       "t1.txt", "t2.txt"]) == 0
    assert lbuild.run(["-n", "2", "wmap", "lm_gram.arpa",
                       "g1.1gram", "g1.2gram"]) == 0
    assert open("lm_gram.arpa").read() == open("lm_text.arpa").read()


def test_lglist_dumps_and_fof(work, capsys):
    from htk_jax.tools.lgram import run_lglist

    assert run_lgprep(["-n", "2", "-r", "g1", "wmap", "t1.txt"]) == 0
    assert run_lglist(["wmap", "g1.2gram"]) == 0
    out = capsys.readouterr().out
    assert "2-grams" in out and "a b 1" in out
    assert run_lglist(["-f", "wmap", "g1.1gram"]) == 0
    out = capsys.readouterr().out
    assert "r=2: 3" in out and "r=3: 1" in out  # a,<s>,</s> x2; b x3
    assert run_lglist(["-m", "3", "wmap", "g1.1gram"]) == 0
    out = capsys.readouterr().out
    assert "b 3" in out and "a 2" not in out


def test_llink_composes_word_lm(work):
    from htk_jax.io.lm import read_lm
    from htk_jax.tools.cluster import run as run_cluster
    from htk_jax.tools.cluster import run_llink

    # cluster on t1, then re-link fresh counts from t2 under that map
    assert run_cluster(["-c", "2", "wmap", "cmap", "t1.txt"]) == 0
    assert run_llink(["-o", "out.arpa", "cmap", "t2.txt"]) == 0
    lm = read_lm("out.arpa")
    assert lm.order == 2 and ("a", "b") in lm.bigrams
    # gram-file inputs give the same LM as the text they came from
    assert run_lgprep(["-n", "2", "-r", "g2", "wmap", "t2.txt"]) == 0
    assert run_llink(["-o", "out2.arpa", "cmap",
                      "g2.1gram", "g2.2gram"]) == 0
    assert open("out.arpa").read() == open("out2.arpa").read()
