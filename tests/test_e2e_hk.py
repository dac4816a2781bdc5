"""E2E: HHEd HK continuous->discrete conversion, retrain, decode.

Covers HHEd.c's SetHMMSetKind conversion path: train continuous
monophones, build a VQ codebook (HQuants), HK DISCRETEHS (codeword
probs from the GMMs), quantise the corpus (HCopy DISCRETE/_V), one
discrete HERest iteration, then HVite at 100% accuracy.
"""

import os

import pytest

from htk_jax.tools import (hbuild, hcompv, hcopy, herest, hhed, hquants,
                           hresults, hvite)

from test_e2e import corpus  # fixture: tiny synthetic corpus workdir
from test_e2e import synth, write_wav  # noqa: F401


@pytest.fixture
def trained(corpus):
    from htk_jax.io.mmf import load_mmf, save_mmf
    from htk_jax.models.proto import clone_proto

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


def test_hk_discrete_conversion_chain(trained, capsys):
    from htk_jax.io.mmf import load_mmf
    from htk_jax.models.hmmset import compile_hmmset

    # 1. VQ codebook over the training features
    assert hquants.run(["-C", "cfg", "-n", "1", "64", "cb.vq",
                        "-S", "train.scp"]) == 0

    # 2. HK DISCRETEHS: convert the continuous set
    open("hk.hed", "w").write("HK DISCRETEHS\n")
    open("cfg_hk", "w").write("HHED: VQTABLE = cb.vq\n")
    assert hhed.run(["-C", "cfg_hk", "-T", "1", "-H", "hmm2/hmmdefs",
                     "-M", "disc0", "hk.hed", "monophones"]) == 0
    out = capsys.readouterr().out
    assert "HK DISCRETEHS converted" in out
    dset = load_mmf("disc0/hmmdefs")
    assert compile_hmmset(dset).discrete
    assert dset.hmms["aa"].states[0].streams[0].dprobs is not None

    # 3. quantise the corpus to DISCRETE feature files
    open("cfg_vq", "w").write(
        "TARGETKIND = DISCRETE\nHPARM: VQTABLE = cb.vq\n")
    open("vq.scp", "w").write(
        "\n".join(f"u{i}.mfc u{i}.dsc" for i in range(6)))
    assert hcopy.run(["-C", "cfg_vq", "-S", "vq.scp"]) == 0
    open("train_d.scp", "w").write("\n".join(f"u{i}.dsc" for i in range(6)))

    # 4. one discrete reestimation iteration (retrain)
    os.makedirs("disc1", exist_ok=True)
    assert herest.run(["-I", "phones.mlf", "-H", "disc0/hmmdefs",
                       "-M", "disc1", "-S", "train_d.scp",
                       "monophones"]) == 0

    # 5. decode the quantised corpus at 100%
    assert hvite.run(["-w", "wdnet.slf", "-p", "-8", "-i", "recd.mlf",
                      "-H", "disc1/hmmdefs", "-S", "train_d.scp",
                      "dict", "monophones"]) == 0
    assert hresults.run(["-I", "words.mlf", "monophones", "recd.mlf"]) == 0
    out = capsys.readouterr().out
    assert "WORD: %Corr=100.00" in out


def test_hk_tiedhs_conversion_chain(trained, capsys):
    """HK TIEDHS: continuous -> tied-mixture pool, MMF round-trip
    (text + binary), retrain one iteration, decode at 100%."""
    from htk_jax.io.mmf import load_mmf, save_mmf

    # JO sets the pool size + weight floor for the conversion (the HTK
    # tied-mixture join parameters); no config key needed
    open("hkt.hed", "w").write("JO 6 1e-5\nHK TIEDHS\n")
    assert hhed.run(["-T", "1", "-H", "hmm2/hmmdefs",
                     "-M", "tied0", "hkt.hed", "monophones"]) == 0
    out = capsys.readouterr().out
    assert "HK TIEDHS converted" in out

    ts = load_mmf("tied0/hmmdefs")
    assert ts.hmm_set_id == "TIEDHS"
    se = ts.hmms["aa"].states[0].streams[0]
    assert se.tmix_base == "tm1_"
    assert len(se.mixes) == 6  # 9 source Gaussians clustered to 6
    # the pool is genuinely SHARED across states after the round trip
    se2 = ts.hmms["iy"].states[1].streams[0]
    assert se2.mixes[0] is se.mixes[0]
    assert "<TMIX> tm1_" in open("tied0/hmmdefs").read()

    # binary round trip preserves the tied structure
    save_mmf(ts, "tied0/hmmdefs.bin", binary=True)
    tb = load_mmf("tied0/hmmdefs.bin")
    seb = tb.hmms["aa"].states[0].streams[0]
    assert seb.tmix_base == "tm1_" and len(seb.mixes) == 6
    import numpy as np
    np.testing.assert_allclose(seb.weights, se.weights, atol=1e-6)

    # retrain the tied set one iteration and decode
    os.makedirs("tied1", exist_ok=True)
    assert herest.run(["-C", "cfg", "-I", "phones.mlf",
                       "-H", "tied0/hmmdefs", "-M", "tied1",
                       "-S", "train.scp", "monophones"]) == 0
    assert hvite.run(["-C", "cfg", "-w", "wdnet.slf", "-p", "-10",
                      "-i", "rect.mlf", "-H", "tied1/hmmdefs",
                      "-S", "train.scp", "dict", "monophones"]) == 0
    assert hresults.run(["-I", "words.mlf", "monophones", "rect.mlf"]) == 0
    out = capsys.readouterr().out
    assert "WORD: %Corr=100.00" in out
