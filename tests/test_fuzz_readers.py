"""Corrupt-input robustness for every file reader.

`HShell.c` tools die with a numbered `ERROR [+NNNN]` on malformed input,
never a raw crash. This harness builds one small valid artifact per
format, then feeds each reader (a) truncated prefixes at byte
boundaries spread over the file and (b) single-byte corruptions at
deterministic offsets, asserting the outcome is always either a clean
parse or an `HTKError` — any other exception type is a crash path a
user can hit from the command line with a damaged file.
"""

import gzip
import os

import numpy as np
import pytest

from htk_jax.utils.errors import HTKError


def _mutations(blob: bytes, n_trunc=12, n_flip=24, seed=0):
    """Deterministic corpus of damaged variants of `blob`."""
    rng = np.random.default_rng(seed)
    out = []
    n = len(blob)
    for k in range(n_trunc):
        cut = int(round((k + 1) * n / (n_trunc + 1)))
        out.append(blob[:cut])
    for off in sorted(rng.integers(0, max(n, 1), n_flip).tolist()):
        b = bytearray(blob)
        b[off] ^= 0xFF
        out.append(bytes(b))
    out.append(b"")
    out.append(b"\x00" * 64)
    out.append(b"garbage not in any format\n" * 4)
    return out


def _assert_reader_contained(reader, blob, tmp_path, name):
    """Run `reader` over every mutation; only clean results or HTKError
    (or OSError surfaced as HTKError upstream) are acceptable."""
    p = str(tmp_path / name)
    failures = []
    for i, mut in enumerate(_mutations(blob)):
        with open(p, "wb") as f:
            f.write(mut)
        try:
            reader(p)
        except HTKError:
            pass
        except Exception as e:  # noqa: BLE001 — the point of the test
            failures.append((i, type(e).__name__, str(e)[:90]))
    assert not failures, (
        f"{name}: non-HTKError crash paths on corrupt input: {failures}")


def test_fuzz_htk_feature_file(tmp_path):
    from htk_jax.io.htkfeat import read_htk_file, write_htk_file
    from htk_jax.io.parmkind import str2parmkind

    x = np.random.default_rng(0).normal(size=(20, 6)).astype(np.float32)
    p = str(tmp_path / "a.mfc")
    write_htk_file(p, x, 100000, str2parmkind("USER_E"))
    _assert_reader_contained(read_htk_file, open(p, "rb").read(),
                             tmp_path, "feat.mfc")


def test_fuzz_htk_feature_file_compressed(tmp_path):
    from htk_jax.io.htkfeat import read_htk_file, write_htk_file
    from htk_jax.io.parmkind import str2parmkind

    x = (np.random.default_rng(1).normal(size=(30, 4)) * 4).astype(
        np.float32)
    p = str(tmp_path / "c.mfc")
    write_htk_file(p, x, 100000, str2parmkind("USER_C_K"))
    _assert_reader_contained(read_htk_file, open(p, "rb").read(),
                             tmp_path, "featc.mfc")


def test_fuzz_mlf(tmp_path):
    from htk_jax.io.mlf import MLF

    blob = (b'#!MLF!#\n"*/u0.lab"\n0 1000000 aa -1.5\nsil\n.\n'
            b'"*/u1.lab"\nbb\ncc\n.\n')
    _assert_reader_contained(lambda p: MLF.load(p), blob, tmp_path,
                             "l.mlf")


def test_fuzz_arpa_and_binary_lm(tmp_path):
    from htk_jax.io import lm as lmmod

    arpa = (b"\\data\\\nngram 1=3\nngram 2=2\n\n\\1-grams:\n"
            b"-1 a -0.3\n-1 b -0.2\n-2 c\n\n\\2-grams:\n"
            b"-0.5 a b\n-0.4 b c\n\n\\end\\\n")
    _assert_reader_contained(lambda p: lmmod.read_lm(p), arpa, tmp_path,
                             "lm.arpa")
    # same fuzz against the pure-Python twin (the native codec falls
    # back to it precisely on damaged input)
    os.environ["HTKTPU_NO_NATIVE"] = "1"
    try:
        _assert_reader_contained(lambda p: lmmod.read_lm(p), arpa,
                                 tmp_path, "lm2.arpa")
    finally:
        del os.environ["HTKTPU_NO_NATIVE"]

    src = str(tmp_path / "src.arpa")
    open(src, "wb").write(arpa)
    binp = str(tmp_path / "lm.bin")
    lmmod.write_binary_lm(lmmod.read_lm(src), binp)
    _assert_reader_contained(lambda p: lmmod.read_lm(p),
                             open(binp, "rb").read(), tmp_path, "b.bin")


def test_fuzz_matrix_bigram(tmp_path):
    from htk_jax.io import lm as lmmod

    lm = lmmod.NGramLM(order=2)
    lm.unigrams = {"a": (-1.0, 0.0), "b": (-1.0, 0.0)}
    lm.bigrams = {("a", "b"): (-0.5, 0.0)}
    p = str(tmp_path / "m.bg")
    lmmod.write_matrix_bigram(lm, ["a", "b"], p)
    _assert_reader_contained(lambda q: lmmod.read_lm(q),
                             open(p, "rb").read(), tmp_path, "m2.bg")


def test_fuzz_dictionary(tmp_path):
    from htk_jax.io.dictionary import read_dict

    blob = (b"a  [A] 0.9 aa ax\nb  b iy\nc  [C] c aa c\n")
    _assert_reader_contained(read_dict, blob, tmp_path, "d.dict")


def test_fuzz_slf(tmp_path):
    from htk_jax.io.slf import read_slf

    blob = (b"VERSION=1.0\nN=3 L=2\n"
            b"I=0 t=0.0\nI=1 t=0.5 W=hello\nI=2 t=1.0 W=world\n"
            b"J=0 S=0 E=1 a=-5.0 l=-1.0\nJ=1 S=1 E=2 a=-6.0 l=-2.0\n")
    _assert_reader_contained(read_slf, blob, tmp_path, "l.slf")


def test_fuzz_mmf_text_and_binary(tmp_path):
    from htk_jax.io.mmf import load_mmf, save_mmf
    from htk_jax.models.proto import clone_proto, make_proto

    hs = make_proto(nstates=4, dim=3, parm_kind="USER")
    cl = clone_proto(hs, "proto", ["aa", "bb"])
    pt = str(tmp_path / "mmf.txt")
    save_mmf(cl, pt)
    _assert_reader_contained(lambda p: load_mmf([p]),
                             open(pt, "rb").read(), tmp_path, "m.mmf")
    pb = str(tmp_path / "mmf.bin")
    save_mmf(cl, pb, binary=True)
    _assert_reader_contained(lambda p: load_mmf([p]),
                             open(pb, "rb").read(), tmp_path, "mb.mmf")


def test_fuzz_wave(tmp_path):
    from htk_jax.io.wavefile import Waveform, read_wave, write_wave

    x = (np.random.default_rng(2).normal(size=400) * 3000).astype(
        np.int16)
    wf = Waveform(samples=x, samp_period=625)
    p = str(tmp_path / "a.wav")
    write_wave(p, wf, fmt="WAV")
    _assert_reader_contained(lambda q: read_wave(q, fmt="WAV"),
                             open(p, "rb").read(), tmp_path, "w.wav")
    ph = str(tmp_path / "a.htk")
    write_wave(ph, wf, fmt="HTK")
    _assert_reader_contained(lambda q: read_wave(q, fmt="HTK"),
                             open(ph, "rb").read(), tmp_path, "wh.htk")


def test_fuzz_hmm_list(tmp_path):
    from htk_jax.io.mmf import load_hmm_list

    blob = b"aa\nbb phys\ncc\n"
    _assert_reader_contained(load_hmm_list, blob, tmp_path, "list")


def test_fuzz_vq_table(tmp_path):
    from htk_jax.io.vq import VQTable, load_vq, save_vq

    rng = np.random.default_rng(7)
    vq = VQTable(codebooks=[rng.normal(size=(8, 4)).astype(np.float32)])
    p = str(tmp_path / "t.vq")
    save_vq(vq, p)
    _assert_reader_contained(load_vq, open(p, "rb").read(), tmp_path,
                             "f.vq")


def test_fuzz_gram_file(tmp_path):
    from htk_jax.tools.lgram import read_gram, write_gram

    try:
        from collections import Counter

        c = Counter({("a", "b"): 3, ("b", "c"): 1, ("a", "c"): 2})
        p = str(tmp_path / "g.gram")
        write_gram(p, 2, c)
    except Exception:
        pytest.skip("gram writer signature differs")
    _assert_reader_contained(read_gram, open(p, "rb").read(), tmp_path,
                             "f.gram")


def test_fuzz_tmf(tmp_path):
    from htk_jax.algo.adapt import Transform, load_tmf, save_tmf

    p = str(tmp_path / "t.tmf")
    save_tmf(p, "spk01", Transform(kind="MLLRMEAN", A=np.eye(3),
                                   b=np.zeros(3)))
    _assert_reader_contained(load_tmf, open(p, "rb").read(), tmp_path,
                             "f.tmf")


def test_fuzz_baseclass(tmp_path):
    from htk_jax.algo.adapt import load_baseclass

    blob = (b"~b \"global\"\n<MMFIDMASK> *\n<PARAMETERS> MIXBASE\n"
            b"<NUMCLASSES> 1\n<CLASS> 1 {*.state[2-4].mix[1-8]}\n")
    _assert_reader_contained(load_baseclass, blob, tmp_path, "f.base")
