"""E2E: HHEd RC base classes -> HERest -K class-MLLR -> HVite -J decode."""

import os

import pytest

from htk_jax.tools import herest, hhed, hresults, hvite

from test_e2e import corpus  # fixture: tiny synthetic corpus workdir
from test_e2e import synth, write_wav  # noqa: F401


@pytest.fixture
def trained(corpus):
    from htk_jax.io.mmf import load_mmf, save_mmf
    from htk_jax.models.proto import clone_proto
    from htk_jax.tools import hbuild, hcompv, hcopy

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


def test_hdecode_adaptation(trained, capsys):
    """HDecode -J/-h: HERest -K estimates a global MLLRMEAN TMF on
    channel-shifted features; adapted LV decoding recovers 100% and
    beats the unadapted decode (the `HTKLVRec/HDecode.c` -J chain)."""
    import numpy as np

    from htk_jax.io.htkfeat import read_htk_file, write_htk_file
    from htk_jax.tools import hdecode, lbuild

    # speaker-shifted test channel: a constant offset per dim, sized to
    # the corpus' own std so unadapted decoding degrades but survives
    feats = [read_htk_file(f"u{i}.mfc") for i in range(6)]
    g_std = np.concatenate([f.data for f in feats]).std(axis=0)
    shift = (0.8 * g_std).astype(np.float32)
    for i, f in enumerate(feats):
        write_htk_file(f"s{i}.mfc", f.data + shift, f.samp_period,
                       f.parm_kind)
    open("shift.scp", "w").write("\n".join(f"s{i}.mfc" for i in range(6)))
    open("phones_s.mlf", "w").write(
        open("phones.mlf").read().replace("/u", "/s"))
    open("words_s.mlf", "w").write(
        open("words.mlf").read().replace("/u", "/s"))

    # global MLLRMEAN transform from the shifted channel
    os.makedirs("xfhd", exist_ok=True)
    assert herest.run(["-C", "cfg", "-I", "phones_s.mlf",
                       "-H", "hmm2/hmmdefs", "-K", "xfhd",
                       "-S", "shift.scp", "monophones"]) == 0
    assert "MLLRMEAN" in open("xfhd/global.tmf").read()

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
    assert lbuild.run(["-n", "2", "wlist", "lm.arpa", "words.txt"]) == 0

    open("cfglv", "w").write(
        "TARGETKIND = MFCC_E_D_A\nHTKTPU: LVDECODE = T\n")

    def wer(rec):
        assert hresults.run(["-I", "words_s.mlf", "monophones",
                             rec]) == 0
        out = capsys.readouterr().out
        for tok in out.split():
            if tok.startswith("%Corr="):
                return float(tok.split("=")[1].rstrip(","))
        return -1.0

    assert hdecode.run(["-C", "cfglv", "-T", "1", "-w", "lm.arpa",
                        "-p", "-8", "-i", "rec_un.mlf",
                        "-H", "hmm2/hmmdefs", "-S", "shift.scp",
                        "dict", "monophones"]) == 0
    out = capsys.readouterr().out
    assert "[LV uniform rows]" in out
    assert hdecode.run(["-C", "cfglv", "-w", "lm.arpa", "-p", "-8",
                        "-J", "xfhd", "-k", "-i", "rec_ad.mlf",
                        "-H", "hmm2/hmmdefs", "-S", "shift.scp",
                        "dict", "monophones"]) == 0
    w_un, w_ad = wer("rec_un.mlf"), wer("rec_ad.mlf")
    assert w_ad == 100.0
    assert w_ad >= w_un


def test_rc_baseclass_mllr_chain(trained, capsys):
    # HHEd RC: mixture-up then 2 regression base classes next to the MMF
    open("rc.hed", "w").write("MU 2 {*.state[2-4].mix}\nRC 2 global\n")
    assert hhed.run(["-H", "hmm2/hmmdefs", "-M", "hmm3",
                     "rc.hed", "monophones"]) == 0
    assert os.path.exists("hmm3/global.cls")

    # refine the split models once so the class statistics are sane
    os.makedirs("hmm4", exist_ok=True)
    assert herest.run(["-C", "cfg", "-I", "phones.mlf",
                       "-H", "hmm3/hmmdefs", "-M", "hmm4",
                       "-S", "train.scp", "monophones"]) == 0

    # HERest -K with the HHEd base classes -> MLLRCLASSES TMF; a tiny
    # OCCTHRESH exercises per-leaf tree transforms, MLLRVAR adds
    # per-transform variance scaling
    open("cfg_adapt", "w").write(
        "TARGETKIND = MFCC_E_D_A\n"
        "HADAPT: BASECLASS = hmm3/global.cls\n"
        "HADAPT: OCCTHRESH = 1.0\n"
        "HADAPT: MLLRVAR = T\n"
    )
    assert herest.run(["-C", "cfg_adapt", "-I", "phones.mlf",
                       "-H", "hmm4/hmmdefs", "-K", "xf",
                       "-S", "train.scp", "monophones"]) == 0
    assert os.listdir("xf") == ["global.tmf"]
    tmf = open("xf/global.tmf").read()
    assert "MLLRCLASSES" in tmf and "<VARSCALE>" in tmf

    # HVite -J applies the class transforms; matched data stays at 100%
    assert hvite.run(["-w", "wdnet.slf", "-p", "-8", "-J", "xf",
                      "-i", "rec.mlf", "-H", "hmm4/hmmdefs",
                      "-S", "train.scp", "dict", "monophones"]) == 0
    assert hresults.run(["-I", "words.mlf", "monophones", "rec.mlf"]) == 0
    out = capsys.readouterr().out
    assert "WORD: %Corr=100.00" in out
