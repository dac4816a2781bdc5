"""HERest -J/-a input transforms: fMLLR-SAT accumulation."""

import os

import numpy as np
import pytest

from htk_jax.algo.adapt import Transform, save_tmf
from htk_jax.io import parmkind as pk
from htk_jax.io.htkfeat import write_htk_file
from htk_jax.io.mmf import load_mmf, save_mmf
from htk_jax.models.proto import clone_proto, make_proto
from htk_jax.tools import herest

DIM = 4
CENTERS = {"aa": 4.0, "iy": -4.0}
BIAS = {"spkA": 2.0, "spkB": 1.0}


@pytest.fixture
def sat_corpus(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    hs = make_proto(nstates=5, dim=DIM, parm_kind="USER")
    cl = clone_proto(hs, "proto", ["aa", "iy"])
    for nm, h in cl.hmms.items():
        for k, si in enumerate(h.states):
            mp = si.streams[0].mixes[0]
            mp.mean = np.full(DIM, CENTERS[nm] + 0.2 * k, np.float32)
            mp.var = np.full(DIM, 0.5, np.float32)
            mp.fix_gconst()
    save_mmf(cl, "hmmdefs")

    rng = np.random.default_rng(0)
    kind = pk.str2parmkind("USER")
    scp, mlf = [], ["#!MLF!#"]
    os.makedirs("xfin", exist_ok=True)
    for spk, bias in BIAS.items():
        # per-speaker CMLLR input transform removes the bias exactly
        save_tmf(f"xfin/{spk}.tmf", spk,
                 Transform(kind="CMLLR", A=np.eye(DIM),
                           b=np.full(DIM, -bias)))
        for i in range(4):
            frames = []
            for ph in ("aa", "iy"):
                mu = CENTERS[ph] + 0.2 * np.arange(3).repeat(4).reshape(3, 4)
                seg = np.repeat(mu, 4, axis=0)  # 12 frames over the states
                frames.append(seg)
            x = (np.concatenate(frames) + bias
                 + 0.1 * rng.normal(size=(24, DIM))).astype(np.float32)
            fn = f"{spk}_{i}.usr"
            write_htk_file(fn, x, 100000, kind)
            scp.append(fn)
            mlf += [f'"*/{spk}_{i}.lab"', "aa", "iy", "."]
    open("train.scp", "w").write("\n".join(scp))
    open("phones.mlf", "w").write("\n".join(mlf) + "\n")
    open("phonelist", "w").write("aa\niy\n")
    return tmp_path


def _mean0(path):
    hs = load_mmf(path)
    return hs.hmms["aa"].states[0].streams[0].mixes[0].mean.copy()


def test_sat_input_transforms_cancel_bias(sat_corpus):
    base = _mean0("hmmdefs")

    # without input transforms, biased data drags the means
    os.makedirs("plain", exist_ok=True)
    assert herest.run(["-u", "m", "-I", "phones.mlf", "-H", "hmmdefs",
                       "-M", "plain", "-S", "train.scp", "phonelist"]) == 0
    drift_plain = np.abs(_mean0("plain/hmmdefs") - base).mean()

    # with -J/-a fMLLR input transforms, the bias cancels
    os.makedirs("sat", exist_ok=True)
    assert herest.run(["-u", "m", "-a", "-J", "xfin", "-h", "%%%%*",
                       "-I", "phones.mlf", "-H", "hmmdefs",
                       "-M", "sat", "-S", "train.scp", "phonelist"]) == 0
    drift_sat = np.abs(_mean0("sat/hmmdefs") - base).mean()

    assert drift_plain > 1.0  # ~ the 1-2 bias shows up in the update
    assert drift_sat < 0.2  # SAT keeps the canonical means


def test_sat_model_space_mllr_group(sat_corpus):
    """MLLRMEAN input transforms accumulate per speaker group against
    adapted means; with transforms matching the bias, the canonical
    means survive the update (stats stay in feature space, so the
    canonical update lands on the feature-space average — here we only
    check the grouped path runs and keeps the model finite)."""
    for spk, bias in BIAS.items():
        save_tmf(f"xfin/{spk}.tmf", spk,
                 Transform(kind="MLLRMEAN", A=np.eye(DIM),
                           b=np.full(DIM, bias)))
    os.makedirs("satm", exist_ok=True)
    assert herest.run(["-u", "m", "-a", "-J", "xfin", "-h", "%%%%*",
                       "-I", "phones.mlf", "-H", "hmmdefs",
                       "-M", "satm", "-S", "train.scp", "phonelist"]) == 0
    m = _mean0("satm/hmmdefs")
    assert np.all(np.isfinite(m))
    # adapted-model alignment puts each speaker's frames on the right
    # states, so the update is the biased feature average (~ +1.5)
    assert 0.8 < float((m - _mean0("hmmdefs")).mean()) < 2.2


def test_hvite_parent_transform_composition(sat_corpus):
    """Global MLLR parent + per-speaker CMLLR children compose in HVite."""
    from htk_jax.tools import hbuild, hresults, hvite

    # shift all data up by a further global offset the CMLLR inputs
    # don't know about; a global parent MLLR on the means absorbs it
    G = 3.0
    import numpy as np
    from htk_jax.io.htkfeat import read_htk_file, write_htk_file
    from htk_jax.io import parmkind as pk

    kind = pk.str2parmkind("USER")
    for fn in open("train.scp").read().split():
        ff = read_htk_file(fn)
        write_htk_file(fn, ff.data + G, 100000, kind)

    os.makedirs("xfout", exist_ok=True)
    save_tmf("xfout/global.tmf", "global",
             Transform(kind="MLLRMEAN", A=np.eye(DIM), b=np.full(DIM, G)))

    open("dict", "w").write("A  aa\nI  iy\n")
    open("wlist", "w").write("A\nI\n")
    open("words.mlf", "w").write(
        "#!MLF!#\n" + "".join(
            f'"*/{fn.split(".")[0]}.lab"\nA\nI\n.\n'
            for fn in open("train.scp").read().split()))
    assert hbuild.run(["wlist", "wdnet.slf"]) == 0

    # children only: means are off by G ~ 4 sigma -> decode degrades
    assert hvite.run(["-w", "wdnet.slf", "-J", "xfin", "-h", "%%%%*",
                      "-i", "rec1.mlf", "-H", "hmmdefs",
                      "-S", "train.scp", "dict", "phonelist"]) == 0
    # parent + children: bias and offset both handled -> 100%
    assert hvite.run(["-w", "wdnet.slf", "-J", "xfout", "-J", "xfin",
                      "-h", "%%%%*", "-i", "rec2.mlf", "-H", "hmmdefs",
                      "-S", "train.scp", "dict", "phonelist"]) == 0

    import io
    from contextlib import redirect_stdout

    def corr(mlf):
        buf = io.StringIO()
        with redirect_stdout(buf):
            hresults.run(["-I", "words.mlf", "phonelist", mlf])
        out = buf.getvalue()
        for tok in out.split():
            if tok.startswith("%Corr="):
                return float(tok.split("=")[1].rstrip(","))
        return -1.0

    assert corr("rec2.mlf") == 100.0
    assert corr("rec2.mlf") >= corr("rec1.mlf")


def test_herest_mllrcov_to_hvite(sat_corpus):
    """TRANSKIND=MLLRCOV: HERest estimates full variance transforms,
    HVite applies them via the full-covariance scorer."""
    from htk_jax.tools import hbuild, hresults, hvite

    open("cfgcov", "w").write("HADAPT: TRANSKIND = MLLRCOV\n")
    os.makedirs("xfc", exist_ok=True)
    assert herest.run(["-C", "cfgcov", "-a", "-J", "xfin", "-h", "%%%%*",
                       "-I", "phones.mlf", "-H", "hmmdefs", "-K", "xfc",
                       "-S", "train.scp", "phonelist"]) == 0
    tmfs = sorted(os.listdir("xfc"))
    assert tmfs == ["spkA.tmf", "spkB.tmf"]
    assert "MLLRCOV" in open("xfc/spkA.tmf").read()

    open("dict", "w").write("A  aa\nI  iy\n")
    open("wlist", "w").write("A\nI\n")
    open("words.mlf", "w").write(
        "#!MLF!#\n" + "".join(
            f'"*/{fn.split(".")[0]}.lab"\nA\nI\n.\n'
            for fn in open("train.scp").read().split()))
    assert hbuild.run(["wlist", "wdnet.slf"]) == 0
    # chain: per-speaker CMLLR input (bias) + per-speaker MLLRCOV
    assert hvite.run(["-w", "wdnet.slf", "-J", "xfin", "-J", "xfc",
                      "-h", "%%%%*", "-i", "reccov.mlf", "-H", "hmmdefs",
                      "-S", "train.scp", "dict", "phonelist"]) == 0
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        hresults.run(["-I", "words.mlf", "phonelist", "reccov.mlf"])
    assert "%Corr=100.00" in buf.getvalue()


def test_herest_cmllr_classes_to_hvite(sat_corpus):
    """TRANSKIND=CMLLR with NUMREGCLASSES>1: base-class constrained
    transforms, applied in HVite through the full-covariance scorer."""
    from htk_jax.tools import hbuild, hresults, hvite

    open("cfgcc", "w").write(
        "HADAPT: TRANSKIND = CMLLR\n"
        "HADAPT: NUMREGCLASSES = 2\n"
        "HADAPT: OCCTHRESH = 10.0\n")
    os.makedirs("xfcc", exist_ok=True)
    assert herest.run(["-C", "cfgcc", "-h", "%%%%*",
                       "-I", "phones.mlf", "-H", "hmmdefs", "-K", "xfcc",
                       "-S", "train.scp", "phonelist"]) == 0
    assert sorted(os.listdir("xfcc")) == ["spkA.tmf", "spkB.tmf"]
    assert "CMLLRCLASSES" in open("xfcc/spkA.tmf").read()

    open("dict", "w").write("A  aa\nI  iy\n")
    open("wlist", "w").write("A\nI\n")
    open("words.mlf", "w").write(
        "#!MLF!#\n" + "".join(
            f'"*/{fn.split(".")[0]}.lab"\nA\nI\n.\n'
            for fn in open("train.scp").read().split()))
    assert hbuild.run(["wlist", "wdnet.slf"]) == 0
    assert hvite.run(["-w", "wdnet.slf", "-J", "xfcc", "-h", "%%%%*",
                      "-i", "reccc.mlf", "-H", "hmmdefs",
                      "-S", "train.scp", "dict", "phonelist"]) == 0
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        hresults.run(["-I", "words.mlf", "phonelist", "reccc.mlf"])
    assert "%Corr=100.00" in buf.getvalue()
