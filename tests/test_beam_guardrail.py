"""Beam-cliff guardrails (VERDICT r3 item #8).

benchmarks/lattice_quality.py's sweep measured a search-error cliff below
genBeam ~300-400: pruning losses are whole utterances, unrecoverable by
rescoring. Two defences, both tested here:
  * HDecode warns (numbered 8524) when -t is below HREC: GENBEAMKNEE;
  * a pruned-out utterance retries with a widened beam, then unpruned
    (HFB.c's escalation ladder, numbered 8525), in HDecode and HVite.
"""

import pytest

from test_e2e import corpus, synth, write_wav  # noqa: F401
from test_e2e_xword import trained  # noqa: F401


def _make_lm(run_lbuild=True):
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
    from htk_jax.tools import lbuild

    assert lbuild.run(["-n", "2", "wlist", "lm2.arpa", "words.txt"]) == 0


def _tri_clone():
    from htk_jax.tools import hhed

    ctx = ["aa", "iy", "sil"]
    tris = [f"{l}-{p}+{r}" for p in ("aa", "iy") for l in ctx for r in ctx]
    open("trilist", "w").write("\n".join(["aa", "iy", "sil"] + tris) + "\n")
    open("cl.hed", "w").write("CL trilist\n")
    assert hhed.run(["-H", "hmm2/hmmdefs", "-M", "tri0",
                     "cl.hed", "monophones"]) == 0


def test_hdecode_warns_below_knee(trained, capsys):
    from htk_jax.tools import hdecode, hresults

    _tri_clone()
    _make_lm()
    open("cfglv", "w").write(
        "TARGETKIND = MFCC_E_D_A\nHNET: FORCECXTEXP = T\n"
        "HTKTPU: LVDECODE = T\n")
    # 300 < default knee 400 -> numbered warning; tiny corpus still
    # decodes fine at that beam
    assert hdecode.run(["-C", "cfglv", "-w", "lm2.arpa", "-p", "-8",
                        "-t", "300.0", "-i", "reckn.mlf",
                        "-H", "tri0/hmmdefs", "-S", "train.scp",
                        "dict", "trilist"]) == 0
    err = capsys.readouterr().err
    assert "WARNING [-8524]" in err and "knee" in err

    # GENBEAMKNEE = 0 silences it
    open("cfglv0", "w").write(
        "TARGETKIND = MFCC_E_D_A\nHNET: FORCECXTEXP = T\n"
        "HTKTPU: LVDECODE = T\nHREC: GENBEAMKNEE = 0\n")
    assert hdecode.run(["-C", "cfglv0", "-w", "lm2.arpa", "-p", "-8",
                        "-t", "300.0", "-i", "reckn0.mlf",
                        "-H", "tri0/hmmdefs", "-S", "train.scp",
                        "dict", "trilist"]) == 0
    assert "WARNING [-8524]" not in capsys.readouterr().err


def test_hdecode_retry_ladder_recovers(trained, capsys, monkeypatch):
    """A pass-1 that returns no path under pruning self-recovers through
    the widened-beam ladder instead of emitting an empty transcript."""
    from htk_jax.algo import decode as dmod
    from htk_jax.tools import hdecode, hresults

    _tri_clone()
    _make_lm()

    # simulate the cliff: the batched pass-1 loses every utterance
    monkeypatch.setattr(
        dmod, "generate_lattice_batch",
        lambda net, comp, featl, *a, **k: [None] * len(featl))

    open("cfglv", "w").write(
        "TARGETKIND = MFCC_E_D_A\nHNET: FORCECXTEXP = T\n"
        "HTKTPU: LVDECODE = T\nHREC: GENBEAMKNEE = 0\n")
    assert hdecode.run(["-C", "cfglv", "-w", "lm2.arpa", "-p", "-8",
                        "-t", "450.0", "-u", "8", "-i", "recrt.mlf",
                        "-H", "tri0/hmmdefs", "-S", "train.scp",
                        "dict", "trilist"]) == 0
    err = capsys.readouterr().err
    assert "WARNING [-8525]" in err and "retrying" in err
    assert hresults.run(["-I", "words.mlf", "monophones",
                         "recrt.mlf"]) == 0
    assert "WORD: %Corr=100.00" in capsys.readouterr().out


def test_hvite_retry_ladder_recovers(trained, capsys, monkeypatch):
    from htk_jax.algo import decode as dmod
    from htk_jax.tools import hvite, hresults

    monkeypatch.setattr(
        dmod, "decode_batch",
        lambda net, comp, featl, *a, **k: [None] * len(featl))

    assert hvite.run(["-C", "cfg", "-w", "wdnet.slf", "-p", "-8",
                      "-t", "450.0", "-i", "recvt.mlf",
                      "-H", "hmm2/hmmdefs", "-S", "train.scp",
                      "dict", "monophones"]) == 0
    err = capsys.readouterr().err
    assert "WARNING [-8525]" in err
    assert hresults.run(["-I", "words.mlf", "monophones",
                         "recvt.mlf"]) == 0
    assert "WORD: %Corr=100.00" in capsys.readouterr().out
