"""E2E: hybrid DNN-HMM tools — HNTrainSGD (CE + sequence MMI),
HNForward, hybrid HVite decoding."""

import os

import pytest

from htk_jax.tools import (hbuild, hcompv, hcopy, herest, hnforward,
                           hntrainsgd, hresults, hvite)

from test_e2e import corpus  # fixture: tiny synthetic corpus workdir
from test_e2e import synth, write_wav  # noqa: F401


@pytest.fixture
def trained(corpus):
    import numpy as np

    from htk_jax.io.mmf import load_mmf, save_mmf
    from htk_jax.models.proto import clone_proto

    # the 6-utterance base corpus is enough for the GMM tests but
    # data-starves the DNN on realistic speech; add 6 more utterances
    # (hybrid tests only pay this cost)
    rng = np.random.default_rng(77)
    words = {"A": ["aa"], "I": ["iy"]}
    extra = []
    for i in range(6, 12):
        ws = [["A", "I"][int(x)] for x in rng.integers(0, 2, size=2)]
        phs = ["sil"]
        for w in ws:
            phs += words[w] + ["sil"]
        write_wav(f"u{i}.wav", synth(phs, rng))
        with open("phones.mlf", "a") as f:
            f.write(f'"*/u{i}.lab"\n' + "\n".join(phs) + "\n.\n")
        with open("words.mlf", "a") as f:
            f.write(f'"*/u{i}.lab"\n' + "\n".join(ws) + "\n.\n")
        extra.append(i)
    with open("copy.scp", "a") as f:
        f.write("\n" + "\n".join(f"u{i}.wav u{i}.mfc" for i in extra))
    with open("train.scp", "a") as f:
        f.write("\n" + "\n".join(f"u{i}.mfc" for i in extra))

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


def test_hntrainsgd_mmi_chain(trained, capsys):
    # CE training followed by sequence-MMI fine-tuning in one invocation
    open("cfg_nn", "w").write(
        "TARGETKIND = MFCC_E_D_A\n"
        "HNTRAINSGD: HIDDENSIZE = 128\n"
        "HNTRAINSGD: CONTEXT = 2\n"
        "HNTRAINSGD: LEARNRATE = 0.01\n"
        "HNTRAINSGD: LRSCHEDULER = LIST\n"
        "HNTRAINSGD: LRVALUES = 0.01 0.01 0.005 0.005 0.002\n"
        "HNTRAINSGD: ACTIVATION = RELU\n"
        "HNTRAINSGD: CRITERION = MMI\n"
        "HNTRAINSGD: SEQITERS = 2\n")
    assert hntrainsgd.run(["-C", "cfg_nn", "-T", "1", "-e", "15",
                           "-H", "hmm2/hmmdefs", "-M", "nn",
                           "-I", "phones.mlf", "-S", "train.scp",
                           "monophones"]) == 0
    out = capsys.readouterr().out
    assert "MMI sequence training" in out and "MMI objective" in out

    # HNForward writes posterior feature files
    os.makedirs("post", exist_ok=True)
    assert hnforward.run(["-C", "cfg", "-N", "nn/ann", "-M", "post",
                          "-S", "train.scp", "monophones"]) == 0
    assert os.path.exists("post/u0.pos")

    # hybrid decode at 100% on the tiny corpus (posterior scores are
    # O(1) per frame, so no GMM-scale word penalty)
    assert hvite.run(["-C", "cfg", "-N", "nn/ann", "-w", "wdnet.slf",
                      "-i", "rech.mlf", "-H", "hmm2/hmmdefs",
                      "-S", "train.scp", "dict", "monophones"]) == 0
    assert hresults.run(["-I", "words.mlf", "monophones", "rech.mlf"]) == 0
    out = capsys.readouterr().out
    assert "WORD: %Corr=100.00" in out
