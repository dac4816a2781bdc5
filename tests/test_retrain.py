"""Single-pass retraining (HERest -r): algo property + tool e2e.

HERest.c -r semantics: forward-backward occupancies are aligned on the
old feature channel, moment statistics accumulate from the new channel,
and the updated models take the new channel's geometry — switching
frontends without realigning.
"""

import os

import numpy as np
import pytest

from htk_jax.algo.trainer import Trainer, prepare_utterance
from htk_jax.tools import hcompv, hcopy, herest, hresults, hvite, hbuild

from _synth import synth_utterance, write_wav
from test_decode import separable_set


class TestRetrainAccumulators:
    def test_affine_channel_stats(self):
        """With feats2 = 2*feats + 1, the channel-2 moment sums must be
        the exact affine images of the channel-1 sums under the SAME
        occupancies: sum_x2 = 2 sum_x1 + occ."""
        comp = separable_set()
        rng = np.random.default_rng(0)
        seq = ["sil", "aa", "iy", "sil"]
        feats = np.concatenate([
            {"aa": 5.0, "iy": -5.0, "sil": 0.0}[p]
            + 0.3 * rng.normal(size=(8, 3)) for p in seq
        ]).astype(np.float32)
        feats2 = (2.0 * feats + 1.0).astype(np.float32)

        u1 = prepare_utterance(comp, "u", feats, seq)
        u2 = prepare_utterance(comp, "u", feats, seq, feats2=feats2)
        a1 = Trainer(comp).accumulate([u1])
        a2 = Trainer(comp, retrain_dim=3).accumulate([u2])
        occ = np.asarray(a1.occ)
        np.testing.assert_allclose(np.asarray(a2.occ), occ, rtol=1e-6)
        np.testing.assert_allclose(
            np.asarray(a2.sum_x), 2.0 * np.asarray(a1.sum_x) + occ[:, None],
            rtol=1e-4, atol=1e-3)
        # E[(2x+1)^2] = 4 E[x^2] + 4 E[x] + 1 under the same weights
        np.testing.assert_allclose(
            np.asarray(a2.sum_xx),
            4.0 * np.asarray(a1.sum_xx) + 4.0 * np.asarray(a1.sum_x)
            + occ[:, None],
            rtol=1e-4, atol=1e-2)


@pytest.fixture
def corpus26(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(5)
    words = {"A": ["aa"], "I": ["iy"]}
    word_seqs = []
    for i in range(6):
        ws = [["A", "I"][int(x)] for x in rng.integers(0, 2, size=2)]
        phs = ["sil"]
        for w in ws:
            phs += words[w] + ["sil"]
        word_seqs.append(ws)
        write_wav(f"u{i}.wav", synth_utterance(phs, rng))
        with open("phones.mlf", "a") as f:
            if i == 0:
                f.write("#!MLF!#\n")
            f.write(f'"*/u{i}.lab"\n' + "\n".join(phs) + "\n.\n")
    with open("words.mlf", "w") as f:
        f.write("#!MLF!#\n")
        for i, ws in enumerate(word_seqs):
            f.write(f'"*/u{i}.lab"\n' + "\n".join(ws) + "\n.\n")
    open("monophones", "w").write("aa\niy\nsil\n")
    open("dict", "w").write("A  aa\nI  iy\nSIL [] sil\n")
    open("wlist", "w").write("A\nI\nSIL\n")
    open("cfg26w", "w").write("SOURCEFORMAT = WAV\nTARGETKIND = MFCC_E_D\n")
    open("cfg39w", "w").write("SOURCEFORMAT = WAV\nTARGETKIND = MFCC_E_D_A\n")
    open("cfg", "w").write("TARGETKIND = ANON\n")
    open("copy26.scp", "w").write(
        "\n".join(f"u{i}.wav u{i}.mfc" for i in range(6)))
    open("copy39.scp", "w").write(
        "\n".join(f"u{i}.wav u{i}.mfc39" for i in range(6)))
    open("train26.scp", "w").write("\n".join(f"u{i}.mfc" for i in range(6)))
    open("pair.scp", "w").write(
        "\n".join(f"u{i}.mfc u{i}.mfc39" for i in range(6)))
    open("train39.scp", "w").write(
        "\n".join(f"u{i}.mfc39" for i in range(6)))

    from htk_jax.io.mmf import save_mmf
    from htk_jax.models.proto import make_proto

    save_mmf(make_proto(nstates=5, dim=26, parm_kind="MFCC_E_D"), "proto")
    return tmp_path


def test_single_pass_retraining_e2e(corpus26, capsys):
    from htk_jax.io.mmf import load_mmf, save_mmf
    from htk_jax.io.parmkind import parmkind2str
    from htk_jax.models.proto import clone_proto

    assert hcopy.run(["-C", "cfg26w", "-S", "copy26.scp"]) == 0
    assert hcopy.run(["-C", "cfg39w", "-S", "copy39.scp"]) == 0
    assert hcompv.run(["-C", "cfg", "-f", "0.01", "-m", "-M", "hmm0",
                       "-S", "train26.scp", "proto"]) == 0
    hs = load_mmf("hmm0/proto")
    cl = clone_proto(hs, "proto", ["aa", "iy", "sil"])
    cl.macros["v"]["varFloor1"] = \
        load_mmf("hmm0/vFloors").macros["v"]["varFloor1"]
    save_mmf(cl, "hmm0/hmmdefs")
    for it in (1, 2):
        os.makedirs(f"hmm{it}", exist_ok=True)
        assert herest.run(
            ["-C", "cfg", "-I", "phones.mlf", "-H", f"hmm{it - 1}/hmmdefs",
             "-M", f"hmm{it}", "-S", "train26.scp", "monophones"]) == 0

    # single-pass retrain 26-dim MFCC_E_D -> 39-dim MFCC_E_D_A
    os.makedirs("hmmr", exist_ok=True)
    assert herest.run(
        ["-C", "cfg", "-r", "-I", "phones.mlf", "-H", "hmm2/hmmdefs",
         "-M", "hmmr", "-S", "pair.scp", "monophones"]) == 0
    hr = load_mmf("hmmr/hmmdefs")
    assert hr.vec_size == 39
    assert "MFCC_E_D_A" in parmkind2str(hr.parm_kind)

    # the retrained set decodes the NEW features perfectly
    assert hbuild.run(["wlist", "wdnet.slf"]) == 0
    assert hvite.run(
        ["-C", "cfg", "-w", "wdnet.slf", "-p", "-10", "-i", "rec.mlf",
         "-H", "hmmr/hmmdefs", "-S", "train39.scp", "dict",
         "monophones"]) == 0
    assert hresults.run(["-I", "words.mlf", "monophones", "rec.mlf"]) == 0
    out = capsys.readouterr().out
    assert "WORD: %Corr=100.00, Acc=100.00" in out

    # and one further NORMAL iteration on the new channel still works
    os.makedirs("hmmr2", exist_ok=True)
    assert herest.run(
        ["-C", "cfg", "-I", "phones.mlf", "-H", "hmmr/hmmdefs",
         "-M", "hmmr2", "-S", "train39.scp", "monophones"]) == 0


def test_single_pass_retraining_parallel_accs(corpus26):
    """-r with -p N shard dumps then -p 0 combine: same retrained model
    geometry as the direct path."""
    from htk_jax.io.mmf import load_mmf, save_mmf
    from htk_jax.models.proto import clone_proto

    assert hcopy.run(["-C", "cfg26w", "-S", "copy26.scp"]) == 0
    assert hcopy.run(["-C", "cfg39w", "-S", "copy39.scp"]) == 0
    assert hcompv.run(["-C", "cfg", "-f", "0.01", "-m", "-M", "hmm0",
                       "-S", "train26.scp", "proto"]) == 0
    hs = load_mmf("hmm0/proto")
    cl = clone_proto(hs, "proto", ["aa", "iy", "sil"])
    cl.macros["v"]["varFloor1"] = \
        load_mmf("hmm0/vFloors").macros["v"]["varFloor1"]
    save_mmf(cl, "hmm0/hmmdefs")
    os.makedirs("hmm1", exist_ok=True)
    assert herest.run(["-C", "cfg", "-I", "phones.mlf", "-H",
                       "hmm0/hmmdefs", "-M", "hmm1", "-S", "train26.scp",
                       "monophones"]) == 0

    # shard the paired script in two, dump accumulators
    pairs = open("pair.scp").read().splitlines()
    open("pair1.scp", "w").write("\n".join(pairs[:3]))
    open("pair2.scp", "w").write("\n".join(pairs[3:]))
    for n, scp in ((1, "pair1.scp"), (2, "pair2.scp")):
        os.makedirs(f"acc{n}", exist_ok=True)
        assert herest.run(["-C", "cfg", "-r", "-p", str(n),
                           "-I", "phones.mlf", "-H", "hmm1/hmmdefs",
                           "-M", f"acc{n}", "-S", scp,
                           "monophones"]) == 0
    # combine: the -r flag tells the combiner to do the retrain update;
    # channel-2 geometry comes from config HPARM2: TARGETKIND
    open("cfg2", "w").write(
        "TARGETKIND = ANON\nHPARM2: TARGETKIND = MFCC_E_D_A\n")
    os.makedirs("hmmrp", exist_ok=True)
    assert herest.run(["-C", "cfg2", "-r", "-p", "0",
                       "-H", "hmm1/hmmdefs", "-M", "hmmrp",
                       "monophones", "acc1/HER1.acc",
                       "acc2/HER2.acc"]) == 0
    hr = load_mmf("hmmrp/hmmdefs")
    assert hr.vec_size == 39
