"""Condensed end-to-end pipeline test through the tool entry points.

A fast (in-process) version of recipes/demo/run_demo.sh: synthesize a
tiny corpus of realistic speech (Klatt-resonator source-filter synthesis
with formant transitions and variable phone durations — tests/_synth),
run HCopy -> HCompV -> HERest x2 -> HBuild -> HVite -> HResults via each
tool's run() and assert perfect recognition. Guards the whole tool
surface against wiring regressions on every pytest run.
"""

import os

import numpy as np
import pytest

from htk_jax.tools import hbuild, hcompv, hcopy, herest, hresults, hvite

from _synth import synth_utterance, write_wav  # noqa: F401


def synth(phs, rng):
    """Realistic source-filter synthesis (kept under the old name for
    the sibling e2e modules that build extra utterances)."""
    return synth_utterance(phs, rng)


@pytest.fixture
def corpus(tmp_path, monkeypatch):
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
    open("copy.scp", "w").write(
        "\n".join(f"u{i}.wav u{i}.mfc" for i in range(6))
    )
    open("train.scp", "w").write("\n".join(f"u{i}.mfc" for i in range(6)))
    open("monophones", "w").write("aa\niy\nsil\n")
    open("dict", "w").write("A  aa\nI  iy\nSIL [] sil\n")
    open("wlist", "w").write("A\nI\nSIL\n")
    open("cfg_wav", "w").write("SOURCEFORMAT = WAV\nTARGETKIND = MFCC_E_D_A\n")
    open("cfg", "w").write("TARGETKIND = MFCC_E_D_A\n")

    from htk_jax.io.mmf import save_mmf
    from htk_jax.models.proto import make_proto

    save_mmf(make_proto(nstates=5, dim=39, parm_kind="MFCC_E_D_A"), "proto")
    return tmp_path


def test_full_pipeline(corpus, capsys):
    assert hcopy.run(["-C", "cfg_wav", "-S", "copy.scp"]) == 0
    assert hcompv.run(
        ["-C", "cfg", "-f", "0.01", "-m", "-M", "hmm0", "-S", "train.scp",
         "proto"]
    ) == 0
    from htk_jax.io.mmf import load_mmf, save_mmf
    from htk_jax.models.proto import clone_proto

    hs = load_mmf("hmm0/proto")
    cl = clone_proto(hs, "proto", ["aa", "iy", "sil"])
    cl.macros["v"]["varFloor1"] = load_mmf("hmm0/vFloors").macros["v"][
        "varFloor1"
    ]
    save_mmf(cl, "hmm0/hmmdefs")

    for it in (1, 2):
        os.makedirs(f"hmm{it}", exist_ok=True)
        assert herest.run(
            ["-C", "cfg", "-I", "phones.mlf", "-H", f"hmm{it - 1}/hmmdefs",
             "-M", f"hmm{it}", "-S", "train.scp", "monophones"]
        ) == 0

    # -t is REAL FB beam pruning (beta-beam + retry ladder); a wide
    # ladder never bites, so the reestimated MMF is byte-identical
    os.makedirs("hmmt", exist_ok=True)
    assert herest.run(
        ["-C", "cfg", "-I", "phones.mlf", "-H", "hmm1/hmmdefs", "-M",
         "hmmt", "-S", "train.scp", "-t", "2000.0", "100.0", "4000.0",
         "monophones"]
    ) == 0
    assert open("hmmt/hmmdefs").read() == open("hmm2/hmmdefs").read()

    assert hbuild.run(["wlist", "wdnet.slf"]) == 0
    assert hvite.run(
        ["-w", "wdnet.slf", "-p", "-10", "-i", "rec.mlf", "-H",
         "hmm2/hmmdefs", "-S", "train.scp", "dict", "monophones"]
    ) == 0
    assert hresults.run(["-I", "words.mlf", "monophones", "rec.mlf"]) == 0
    out = capsys.readouterr().out
    assert "WORD: %Corr=100.00, Acc=100.00" in out

    # HTKTPU: PRECISION = default relaxes the matmul precision for the
    # OutP path (TF32 on an H100; no-op on CPU); recognition stays
    # correct
    open("cfg_fast", "w").write(
        "TARGETKIND = MFCC_E_D_A\nHTKTPU: PRECISION = default\n")
    assert hvite.run(
        ["-C", "cfg_fast", "-w", "wdnet.slf", "-p", "-10", "-i",
         "recf.mlf", "-H", "hmm2/hmmdefs", "-S", "train.scp", "dict",
         "monophones"]
    ) == 0
    assert hresults.run(["-I", "words.mlf", "monophones", "recf.mlf"]) == 0
    out = capsys.readouterr().out
    assert "WORD: %Corr=100.00, Acc=100.00" in out

    # -t genBeam / -u maxActive are REAL pruning now (HRec semantics:
    # tokens below best-beam die per frame; beam/max_active semantics
    # themselves are unit-tested in test_lvdecode). Wide settings are
    # lossless through the tool; a hopeless beam still emits the greedy
    # path (the frame-best always survives its own beam)
    assert hvite.run(
        ["-t", "500.0", "-u", "64", "-w", "wdnet.slf", "-p", "-10", "-i",
         "recb.mlf", "-H", "hmm2/hmmdefs", "-S", "train.scp", "dict",
         "monophones"]
    ) == 0
    assert hresults.run(["-I", "words.mlf", "monophones", "recb.mlf"]) == 0
    out = capsys.readouterr().out
    assert "WORD: %Corr=100.00, Acc=100.00" in out
    assert hvite.run(
        ["-t", "0.5", "-w", "wdnet.slf", "-p", "-10", "-i", "rect.mlf",
         "-H", "hmm2/hmmdefs", "-S", "train.scp", "dict", "monophones"]
    ) == 0
    assert os.path.exists("rect.mlf")

    # live mode (SOURCEKIND = HAUDIO, no -S): replay u0.wav through the
    # streaming frontend + decoder; the energy feature is mismatched
    # (training used ENORMALISE, live mode cannot), so assert the chain
    # runs and emits a transcription rather than exact accuracy
    open("cfg_live", "w").write(
        "SOURCEFORMAT = WAV\nTARGETKIND = MFCC_E_D_A\nENORMALISE = F\n"
        "SOURCEKIND = HAUDIO\nHAUDIO: AUDIOSOURCE = u0.wav\n")
    assert hvite.run(
        ["-C", "cfg_live", "-T", "2", "-w", "wdnet.slf", "-p", "-10",
         "-i", "live.mlf", "-H", "hmm2/hmmdefs", "dict", "monophones"]
    ) == 0
    live_out = capsys.readouterr().out
    assert "live:" in live_out
    assert os.path.exists("live.mlf")


def test_hvite_output_format_flags(corpus, capsys):
    """HVite -m alignment output: word tags on first phones, scores by
    default; -o S/T/W suppress scores/times/word tags (HVite.c -o)."""
    assert hcopy.run(["-C", "cfg_wav", "-S", "copy.scp"]) == 0
    assert hcompv.run(["-C", "cfg", "-f", "0.01", "-m", "-M", "hmm0",
                       "-S", "train.scp", "proto"]) == 0
    from htk_jax.io.mmf import load_mmf, save_mmf
    from htk_jax.models.proto import clone_proto

    hs = load_mmf("hmm0/proto")
    cl = clone_proto(hs, "proto", ["aa", "iy", "sil"])
    cl.macros["v"]["varFloor1"] = \
        load_mmf("hmm0/vFloors").macros["v"]["varFloor1"]
    save_mmf(cl, "hmm0/hmmdefs")
    os.makedirs("hmm1", exist_ok=True)
    assert herest.run(["-C", "cfg", "-I", "phones.mlf",
                       "-H", "hmm0/hmmdefs", "-M", "hmm1",
                       "-S", "train.scp", "monophones"]) == 0

    args = ["-C", "cfg", "-a", "-m", "-I", "words.mlf", "-b", "SIL",
            "-H", "hmm1/hmmdefs", "-S", "train.scp", "dict", "monophones"]
    assert hvite.run(args + ["-i", "al.mlf"]) == 0
    text = open("al.mlf").read()
    body = [l for l in text.splitlines()[2:] if l not in (".",)][0]
    parts = body.split()
    # start end phone score word  (first phone of the first word)
    assert len(parts) == 5 and parts[0].isdigit() and parts[1].isdigit()
    float(parts[3])  # score
    assert parts[4] in ("SIL", "A", "I")

    assert hvite.run(args + ["-i", "al2.mlf", "-o", "STW"]) == 0
    body2 = [l for l in open("al2.mlf").read().splitlines()[2:]
             if l not in (".",)][0]
    assert body2.split() == [parts[2]]  # phone name only


def test_herest_preload_compressed_equals_uncompressed(corpus, capsys):
    """Training from a _C-compressed corpus (the native preload path)
    produces the same model as training from the uncompressed corpus up
    to the _C quantisation itself: compare against training on features
    read back from the SAME compressed files via the per-file reader."""
    from htk_jax.io.mmf import load_mmf

    from htk_jax.io.mmf import save_mmf
    from htk_jax.models.proto import clone_proto

    assert hcopy.run(["-C", "cfg_wav", "-S", "copy.scp"]) == 0
    assert hcompv.run(["-C", "cfg", "-f", "0.01", "-m", "-M", "hmm0",
                       "-S", "train.scp", "proto"]) == 0
    hs0 = load_mmf("hmm0/proto")
    cl = clone_proto(hs0, "proto", ["aa", "iy", "sil"])
    cl.macros["v"]["varFloor1"] = load_mmf("hmm0/vFloors").macros["v"][
        "varFloor1"]
    os.makedirs("hmm_base", exist_ok=True)
    save_mmf(cl, "hmm_base/hmmdefs")
    # compressed copies of the corpus
    open("cfg_c", "w").write(
        "TARGETKIND = MFCC_E_D_A\nHPARM: SAVECOMPRESSED = T\n"
        "HPARM: SAVEWITHCRC = T\n")
    open("copy2.scp", "w").write(
        "\n".join(f"u{i}.mfc u{i}.cmp" for i in range(6)))
    assert hcopy.run(["-C", "cfg_c", "-S", "copy2.scp"]) == 0
    open("train_c.scp", "w").write("\n".join(f"u{i}.cmp" for i in range(6)))

    import shutil

    for out, env in (("hmm_native", "0"), ("hmm_python", "1")):
        os.makedirs(out, exist_ok=True)
        shutil.copy("hmm_base/hmmdefs", "hmmdefs")
        os.environ["HTKTPU_NO_NATIVE"] = env
        try:
            assert herest.run(["-C", "cfg", "-I", "phones.mlf",
                               "-H", "hmmdefs", "-M", out,
                               "-S", "train_c.scp", "monophones"]) == 0
        finally:
            os.environ.pop("HTKTPU_NO_NATIVE", None)
    a = load_mmf("hmm_native/hmmdefs")
    b = load_mmf("hmm_python/hmmdefs")
    for name in a.hmms:
        for sa, sb in zip(a.hmms[name].states, b.hmms[name].states):
            ma = sa.streams[0].mixes[0]
            mb = sb.streams[0].mixes[0]
            np.testing.assert_allclose(ma.mean, mb.mean, atol=2e-4)
            np.testing.assert_allclose(ma.var, mb.var, rtol=2e-3)
