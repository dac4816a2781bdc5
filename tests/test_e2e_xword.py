"""E2E: cross-word triphone decode through HHEd CL + HVite FORCECXTEXP."""

import os

import pytest

from htk_jax.tools import hhed, hresults, hvite

from test_e2e import corpus  # fixture: tiny synthetic corpus workdir
from test_e2e import synth, write_wav  # noqa: F401


@pytest.fixture
def trained(corpus):
    from htk_jax.io.mmf import load_mmf, save_mmf
    from htk_jax.models.proto import clone_proto
    from htk_jax.tools import hbuild, hcompv, hcopy, herest

    assert hcopy.run(["-C", "cfg_wav", "-S", "copy.scp"]) == 0
    assert hcompv.run(["-C", "cfg", "-f", "0.01", "-m", "-M", "hmm0",
                       "-S", "train.scp", "proto"]) == 0
    hs = load_mmf("hmm0/proto")
    cl = clone_proto(hs, "proto", ["aa", "iy", "sil"])
    cl.macros["v"]["varFloor1"] = load_mmf("hmm0/vFloors").macros["v"][
        "varFloor1"]
    save_mmf(cl, "hmm0/hmmdefs")
    for it in (1, 2):
        os.makedirs(f"hmm{it}", exist_ok=True)
        assert herest.run(["-C", "cfg", "-I", "phones.mlf",
                           "-H", f"hmm{it - 1}/hmmdefs", "-M", f"hmm{it}",
                           "-S", "train.scp", "monophones"]) == 0
    assert hbuild.run(["wlist", "wdnet.slf"]) == 0
    return corpus


def test_hvite_cross_word_expansion(trained, capsys):
    # clone all cross-word triphones (exact monophone copies)
    ctx = ["aa", "iy", "sil"]
    tris = [f"{l}-{p}+{r}" for p in ("aa", "iy") for l in ctx for r in ctx]
    open("trilist", "w").write("\n".join(["aa", "iy", "sil"] + tris) + "\n")
    open("cl.hed", "w").write("CL trilist\n")
    assert hhed.run(["-H", "hmm2/hmmdefs", "-M", "tri0",
                     "cl.hed", "monophones"]) == 0

    # FORCECXTEXP: the network must expand cross-word triphones and,
    # with exact clones, still decode at 100%
    open("cfgx", "w").write(
        "TARGETKIND = MFCC_E_D_A\nHNET: FORCECXTEXP = T\n")
    assert hvite.run(["-C", "cfgx", "-T", "1", "-w", "wdnet.slf",
                      "-p", "-8", "-i", "recx.mlf", "-H", "tri0/hmmdefs",
                      "-S", "train.scp", "dict", "trilist"]) == 0
    out = capsys.readouterr().out
    # variant nodes: more than the 3 word-internal nodes
    import re
    m = re.search(r"network (\d+) nodes", out)
    assert m and int(m.group(1)) > 3
    assert hresults.run(["-I", "words.mlf", "monophones", "recx.mlf"]) == 0
    out = capsys.readouterr().out
    assert "WORD: %Corr=100.00" in out

    # ALLOWXWRDEXP with a context-dependent set takes the same path
    open("cfga", "w").write(
        "TARGETKIND = MFCC_E_D_A\nHNET: ALLOWXWRDEXP = T\n")
    assert hvite.run(["-C", "cfga", "-w", "wdnet.slf", "-p", "-8",
                      "-i", "reca.mlf", "-H", "tri0/hmmdefs",
                      "-S", "train.scp", "dict", "trilist"]) == 0
    assert hresults.run(["-I", "words.mlf", "monophones", "reca.mlf"]) == 0
    out = capsys.readouterr().out
    assert "WORD: %Corr=100.00" in out


def test_hdecode_cross_word_expansion(trained, capsys):
    from htk_jax.tools import hhed, lbuild, hdecode

    # cross-word triphone clones (exact copies)
    ctx = ["aa", "iy", "sil"]
    tris = [f"{l}-{p}+{r}" for p in ("aa", "iy") for l in ctx for r in ctx]
    open("trilist", "w").write("\n".join(["aa", "iy", "sil"] + tris) + "\n")
    open("cl.hed", "w").write("CL trilist\n")
    assert hhed.run(["-H", "hmm2/hmmdefs", "-M", "tri0",
                     "cl.hed", "monophones"]) == 0

    # bigram LM over the word transcripts
    sents, cur = [], []
    for ln in open("words.mlf"):
        ln = ln.strip()
        if ln.startswith('"'):
            cur = []
        elif ln == ".":
            sents.append(" ".join(cur))
        elif ln and ln != "#!MLF!#":
            cur.append(ln)
    open("words.txt", "w").write("\n".join(sents) + "\n")
    assert lbuild.run(["-n", "2", "wlist", "lm2.arpa", "words.txt"]) == 0

    open("cfgx", "w").write(
        "TARGETKIND = MFCC_E_D_A\nHNET: FORCECXTEXP = T\n")
    assert hdecode.run(["-C", "cfgx", "-T", "1", "-w", "lm2.arpa",
                        "-p", "-8", "-i", "rechd.mlf", "-H", "tri0/hmmdefs",
                        "-S", "train.scp", "dict", "trilist"]) == 0
    from htk_jax.tools import hresults
    assert hresults.run(["-I", "words.mlf", "monophones", "rechd.mlf"]) == 0
    out = capsys.readouterr().out
    assert "WORD: %Corr=100.00" in out


def test_hdecode_lv_two_pass(trained, capsys):
    """LVDECODE=T: uniform-row pass-1 loop + lattice-constrained
    cross-word rescore must still decode the tiny corpus at 100%."""
    from htk_jax.tools import hhed, lbuild, hdecode, hresults

    ctx = ["aa", "iy", "sil"]
    tris = [f"{l}-{p}+{r}" for p in ("aa", "iy") for l in ctx for r in ctx]
    open("trilist", "w").write("\n".join(["aa", "iy", "sil"] + tris) + "\n")
    open("cl.hed", "w").write("CL trilist\n")
    assert hhed.run(["-H", "hmm2/hmmdefs", "-M", "tri0",
                     "cl.hed", "monophones"]) == 0

    sents, cur = [], []
    for ln in open("words.mlf"):
        ln = ln.strip()
        if ln.startswith('"'):
            cur = []
        elif ln == ".":
            sents.append(" ".join(cur))
        elif ln and ln != "#!MLF!#":
            cur.append(ln)
    open("words.txt", "w").write("\n".join(sents) + "\n")
    assert lbuild.run(["-n", "2", "wlist", "lm2.arpa", "words.txt"]) == 0

    open("cfglv", "w").write(
        "TARGETKIND = MFCC_E_D_A\nHNET: FORCECXTEXP = T\n"
        "HTKTPU: LVDECODE = T\n")
    # with pruning flags on (generous beams: must not change the result)
    assert hdecode.run(["-C", "cfglv", "-T", "1", "-w", "lm2.arpa",
                        "-p", "-8", "-t", "500.0", "-u", "8",
                        "-i", "reclv.mlf", "-H", "tri0/hmmdefs",
                        "-S", "train.scp", "dict", "trilist"]) == 0
    out = capsys.readouterr().out
    assert "[LV uniform rows]" in out
    assert hresults.run(["-I", "words.mlf", "monophones", "reclv.mlf"]) == 0
    out = capsys.readouterr().out
    assert "WORD: %Corr=100.00" in out
