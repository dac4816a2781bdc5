"""In-process e2e for the lattice-era tools: HVite -z, HLRescore, HMMIRest."""

import os

import numpy as np
import pytest

from htk_jax.tools import hlrescore, hmmirest, hresults, hvite

from test_e2e import corpus  # fixture: tiny trained-ready corpus workdir
from test_e2e import synth, write_wav  # noqa: F401


@pytest.fixture
def trained(corpus):
    """Train 2 quick iterations so decode/lattices are meaningful."""
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


def test_lattice_rescore_mmi_chain(trained, capsys):
    os.makedirs("lats", exist_ok=True)
    assert hvite.run(
        ["-w", "wdnet.slf", "-p", "-8", "-z", "lat", "-l", "lats",
         "-i", "rec.mlf", "-H", "hmm2/hmmdefs", "-S", "train.scp",
         "dict", "monophones"]
    ) == 0
    lats = sorted(os.listdir("lats"))
    assert len(lats) == 6 and lats[0].endswith(".lat")

    # HLRescore best path must agree with 1-best decode
    assert hlrescore.run(
        ["-f", "-i", "resc.mlf", "dict"] + [f"lats/{l}" for l in lats]
    ) == 0
    assert hresults.run(["-I", "words.mlf", "monophones", "resc.mlf"]) == 0
    out = capsys.readouterr().out
    assert "WORD: %Corr=100.00" in out

    # MMI iteration keeps the model decodable at 100%
    os.makedirs("mmi", exist_ok=True)
    assert hmmirest.run(
        ["-I", "phones.mlf", "-r", "lats", "-d", "dict",
         "-H", "hmm2/hmmdefs", "-M", "mmi", "-S", "train.scp",
         "monophones"]
    ) == 0
    assert hvite.run(
        ["-w", "wdnet.slf", "-p", "-8", "-i", "recmmi.mlf",
         "-H", "mmi/hmmdefs", "-S", "train.scp", "dict", "monophones"]
    ) == 0
    assert hresults.run(["-I", "words.mlf", "monophones", "recmmi.mlf"]) == 0
    out = capsys.readouterr().out
    assert "WORD: %Corr=100.00" in out


def test_mpe_and_numlat_modes(trained, capsys):
    """ADVICE r4 (medium): the MPE path (timed reference) and the -q
    numerator-lattice path run end-to-end and keep the model decodable.

    With -q pointing at the SAME lattices as -r, EBW's numerator and
    denominator statistics cancel exactly, so the updated means must
    stay (numerically) where they were — a strong wiring invariant."""
    import numpy as np

    from htk_jax.io.mmf import load_mmf
    from htk_jax.models.hmmset import compile_hmmset

    os.makedirs("lats", exist_ok=True)
    # -z decode gives both the lattices and a TIMED word-level MLF
    # (the HVite -a style timing MPE's reference needs)
    assert hvite.run(
        ["-w", "wdnet.slf", "-p", "-8", "-z", "lat", "-l", "lats",
         "-i", "rec.mlf", "-H", "hmm2/hmmdefs", "-S", "train.scp",
         "dict", "monophones"]) == 0

    # MPE: accuracy-weighted occupancies from the same lattices
    open("cfg_mpe", "w").write(
        "TARGETKIND = MFCC_E_D_A\nHMMIREST: DISCRMODE = MPE\n")
    os.makedirs("mpe", exist_ok=True)
    assert hmmirest.run(
        ["-C", "cfg_mpe", "-I", "rec.mlf", "-X", "rec", "-r", "lats",
         "-d", "dict", "-H", "hmm2/hmmdefs", "-M", "mpe", "-S",
         "train.scp", "monophones"]) == 0
    assert hvite.run(
        ["-w", "wdnet.slf", "-p", "-8", "-i", "recmpe.mlf",
         "-H", "mpe/hmmdefs", "-S", "train.scp", "dict", "monophones"]) == 0
    assert hresults.run(["-I", "words.mlf", "monophones", "recmpe.mlf"]) == 0
    assert "WORD: %Corr=100.00" in capsys.readouterr().out

    # -q numerator lattices: num == den -> EBW is an exact no-op on the
    # Gaussians (mu = (x - x + D mu0)/(0 + D) = mu0)
    os.makedirs("qmmi", exist_ok=True)
    assert hmmirest.run(
        ["-q", "lats", "-r", "lats", "-d", "dict",
         "-H", "hmm2/hmmdefs", "-M", "qmmi", "-S", "train.scp",
         "monophones"]) == 0
    c0 = compile_hmmset(load_mmf("hmm2/hmmdefs"))
    c1 = compile_hmmset(load_mmf("qmmi/hmmdefs"))
    np.testing.assert_allclose(c1.means, c0.means, rtol=0, atol=1e-4)
    np.testing.assert_allclose(c1.variances, c0.variances,
                               rtol=1e-4, atol=1e-4)


def test_mmi_criterion_rises(trained, capsys):
    """The lattice-MMI objective (kappa-scaled numerator logP minus
    denominator lattice logP, lattices FIXED) must increase across
    HMMIRest iterations — the domain-independent proof the EBW update
    moves the model the right way (HFBLat.c role; the full recipe's
    WER stages can move either way on mismatched test speakers)."""
    import re

    os.makedirs("lats", exist_ok=True)
    assert hvite.run(
        ["-w", "wdnet.slf", "-p", "-8", "-z", "lat", "-l", "lats",
         "-i", "rec.mlf", "-H", "hmm2/hmmdefs", "-S", "train.scp",
         "dict", "monophones"]) == 0
    capsys.readouterr()

    tail = ["-I", "phones.mlf", "-r", "lats", "-d", "dict",
            "-S", "train.scp", "monophones"]
    crits = []
    src = "hmm2/hmmdefs"
    for it in ("ita", "itb", "itc"):
        os.makedirs(it, exist_ok=True)
        assert hmmirest.run(["-T", "1", "-H", src, "-M", it] + tail) == 0
        m = re.search(r"MMI criterion (-?[0-9.]+)",
                      capsys.readouterr().out)
        assert m, "criterion line missing under -T 1"
        crits.append(float(m.group(1)))
        src = f"{it}/hmmdefs"
    # each iteration's printed criterion scores the INPUT model, so
    # crits[i+1] > crits[i] says iteration i's update helped
    assert crits[1] > crits[0] and crits[2] > crits[1], crits


def test_z_retry_ladder_writes_lattice(trained, monkeypatch, capsys):
    """ADVICE r4: a pruned-out utterance recovered by the retry ladder
    must get its .lat file too — downstream HMMIRest -r fails on a
    missing lattice. Force the prune-out by making the batched pass
    return nothing, so every utterance goes through the ladder."""
    from htk_jax.algo import decode as dmod

    real_batch = dmod.generate_lattice_batch

    def all_pruned(net, comp, feats_list, *a, **kw):
        if kw.get("want_results"):
            return [(None, None)] * len(feats_list)
        return [None] * len(feats_list)

    monkeypatch.setattr(dmod, "generate_lattice_batch", all_pruned)
    os.makedirs("rlats", exist_ok=True)
    assert hvite.run(
        ["-w", "wdnet.slf", "-p", "-8", "-t", "400.0", "-z", "lat",
         "-l", "rlats", "-i", "recr.mlf", "-H", "hmm2/hmmdefs",
         "-S", "train.scp", "dict", "monophones"]) == 0
    monkeypatch.setattr(dmod, "generate_lattice_batch", real_batch)
    lats = sorted(os.listdir("rlats"))
    assert len(lats) == 6, f"retry ladder lost lattices: {lats}"
    assert hresults.run(["-I", "words.mlf", "monophones", "recr.mlf"]) == 0
    assert "WORD: %Corr=100.00" in capsys.readouterr().out
    # the recovered lattices feed HMMIRest exactly like first-pass ones
    os.makedirs("rmmi", exist_ok=True)
    assert hmmirest.run(
        ["-I", "phones.mlf", "-r", "rlats", "-d", "dict",
         "-H", "hmm2/hmmdefs", "-M", "rmmi", "-S", "train.scp",
         "monophones"]) == 0


def test_nbest_to_hresults_d(trained, capsys):
    """HVite -n N-best MLF (/// alternatives) -> HResults -d oracle
    scoring consumes it; oracle %Corr >= 1-best %Corr."""
    assert hvite.run(
        ["-w", "wdnet.slf", "-p", "-8", "-n", "2", "4",
         "-i", "recn.mlf", "-H", "hmm2/hmmdefs", "-S", "train.scp",
         "dict", "monophones"]) == 0
    text = open("recn.mlf").read()
    assert "///" in text  # multiple alternatives written

    def corr(args):
        assert hresults.run(args) == 0
        out = capsys.readouterr().out
        for tok in out.split():
            if tok.startswith("%Corr="):
                return float(tok.split("=")[1].rstrip(","))
        return -1.0

    c1 = corr(["-I", "words.mlf", "monophones", "recn.mlf"])
    cd = corr(["-I", "words.mlf", "-d", "4", "monophones", "recn.mlf"])
    assert cd >= c1
    assert cd == 100.0
