"""Native codec tests (skipped when no C++ toolchain is available)."""

import numpy as np
import pytest

from htk_jax.io import parmkind as pk
from htk_jax.io.htkfeat import _crc16, read_htk_file, write_htk_file
from htk_jax.native import get_htkio, load_corpus_batch

needs_native = pytest.mark.skipif(get_htkio() is None,
                                  reason="no C++ toolchain")


@needs_native
class TestNative:
    def test_crc_matches_python(self):
        lib = get_htkio()
        for blob in (b"", b"x", b"hello world", bytes(range(256))):
            assert lib.htkio_crc16(blob, len(blob)) == _crc16(blob)

    def test_batch_load_uncompressed(self, tmp_path):
        rng = np.random.default_rng(0)
        paths = []
        refs = []
        for i in range(4):
            x = rng.normal(size=(30 + i, 7)).astype(np.float32)
            p = str(tmp_path / f"u{i}.mfc")
            write_htk_file(p, x, 100000, pk.str2parmkind("USER_E"))
            paths.append(p)
            refs.append(x)
        arena, frames, periods, kinds = load_corpus_batch(paths, 40, 7)
        for i in range(4):
            assert frames[i] == 30 + i
            assert periods[i] == 100000
            np.testing.assert_array_equal(arena[i, : 30 + i], refs[i])

    def test_batch_load_compressed(self, tmp_path):
        rng = np.random.default_rng(1)
        x = (rng.normal(size=(50, 13)) * 8).astype(np.float32)
        p = str(tmp_path / "c.mfc")
        write_htk_file(p, x, 100000, pk.str2parmkind("MFCC_E_C"))
        arena, frames, _periods, kinds = load_corpus_batch([p], 64, 13)
        assert frames[0] == 50
        ref = read_htk_file(p)
        np.testing.assert_allclose(arena[0, :50], ref.data, atol=1e-5)

    def test_missing_file_reports_error(self, tmp_path):
        arena, frames, _p, _k = load_corpus_batch(
            [str(tmp_path / "nothere.mfc")], 10, 4
        )
        assert frames[0] < 0


class TestMLFMarks:
    def test_native_mlf_equals_pure(self, tmp_path):
        """The C MLF scanner fast path produces identical entries to the
        pure-Python reader (which it silently replaces when available)."""
        import htk_jax.native as N
        from htk_jax.io.mlf import MLF

        p = tmp_path / "big.mlf"
        with open(p, "w") as f:
            f.write("#!MLF!#\n")
            for i in range(200):
                f.write(f'"*/u{i}.lab"\n')
                f.write("0 1000000 aa -12.5\n///\nsil\n.\n")
        m1 = MLF.load(str(p))
        saved = N.get_htkio
        try:
            N.get_htkio = lambda: None
            m2 = MLF.load(str(p))
        finally:
            N.get_htkio = saved
        assert len(m1.entries) == len(m2.entries) == 200
        for (pa, ta), (pb, tb) in zip(m1.entries, m2.entries):
            assert pa == pb
            assert len(ta.alternatives) == len(tb.alternatives) == 2
            la = [(l.name, l.start, l.end, l.score) for l in ta.labels]
            lb = [(l.name, l.start, l.end, l.score) for l in tb.labels]
            assert la == lb


# ---------------------------------------------------------------------------
# ARPA n-gram codec (htknative.cpp) vs the pure-Python reader in io/lm.py.
# Same dicts, same floats (both parse decimal literals to correctly-rounded
# f64 and scale by the same LN10), same skipped-line rules.
# `HTKLib/HLM.c : ReadLModel` anchor per SURVEY.md §2.1.

import math
import os

from htk_jax.io import lm as lmmod
from htk_jax.io.lm import NGramLM, PackedNGramLM, read_arpa


import math
import os

import numpy as np
import pytest

from htk_jax.io import lm as lmmod
from htk_jax.io.lm import NGramLM, PackedNGramLM, read_arpa

ARPA = """\

\\data\\
ngram 1=5
ngram 2=4
ngram 3=3

\\1-grams:
-1.0000 a -0.3010
-1.3010 b
-1.5 c -0.25
-2 d -0
-99 e

\\2-grams:
-0.5 a b -0.1
-0.75 b c
-1.25 c a -0.0000
-0.9 a e

\\3-grams:
-0.25 a b c 0.0000
-0.33 b c a
-0.125 c a b -0.05

\\end\\
trailing garbage after end is ignored
"""


def _write(tmp_path, text, name="t.arpa"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _read_py(path):
    os.environ["HTKTPU_NO_NATIVE"] = "1"
    try:
        out = read_arpa(path)
    finally:
        del os.environ["HTKTPU_NO_NATIVE"]
    assert type(out) is NGramLM
    return out


def _read_native(path):
    out = read_arpa(path)
    if not isinstance(out, PackedNGramLM):
        pytest.skip("native codec unavailable (no toolchain)")
    return out


def assert_lm_equal(a, b):
    assert a.order == b.order
    assert a.vocab == b.vocab
    assert a.unigrams == b.unigrams
    assert a.bigrams == b.bigrams
    assert a.trigrams == b.trigrams
    assert a.tri_bo == b.tri_bo
    assert a.fourgrams == b.fourgrams


def test_arpa_native_matches_python(tmp_path):
    path = _write(tmp_path, ARPA)
    ref = _read_py(path)
    nat = _read_native(path)
    assert_lm_equal(ref, nat)
    # exact key contents, not just equality of empties
    assert ref.unigrams["a"] == (-1.0 * math.log(10), -0.3010 * math.log(10))
    assert ref.tri_bo[("c", "a", "b")] == pytest.approx(
        -0.05 * math.log(10))
    assert ("a", "b", "c") in ref.tri_bo  # explicit 0.0000 bo is present
    assert ("b", "c", "a") not in ref.tri_bo


def test_arpa_native_fourgram_and_edge_lines(tmp_path):
    text = """\\data\\
\\1-grams:
-1 a
-1 b
\\2-grams:
-0.5 a b
\\3-grams:
-0.4 a b a
\\4-grams:
-0.3 a b a b
-0.2 b a b a -0.9
short
\\end\\
"""
    path = _write(tmp_path, text)
    ref = _read_py(path)
    nat = _read_native(path)
    assert_lm_equal(ref, nat)
    assert ref.order == 4
    assert ref.fourgrams[("a", "b", "a", "b")] == -0.3 * math.log(10)
    # 5th 4-gram field (back-off) ignored, like the Python reader
    assert ref.fourgrams[("b", "a", "b", "a")] == -0.2 * math.log(10)


def test_arpa_native_empty_sections_and_order(tmp_path):
    text = "\\data\\\n\\1-grams:\n-1 x\n\\2-grams:\n\\end\\\n"
    path = _write(tmp_path, text)
    ref = _read_py(path)
    nat = _read_native(path)
    assert_lm_equal(ref, nat)
    assert nat.order == 2 and not nat.bigrams


def test_arpa_native_no_unigrams_error(tmp_path):
    from htk_jax.utils.errors import HTKError
    path = _write(tmp_path, "\\data\\\n\\1-grams:\n\\end\\\n")
    with pytest.raises(HTKError):
        read_arpa(path)


def test_bigram_arrays_packed_matches_dict(tmp_path):
    path = _write(tmp_path, ARPA)
    ref = _read_py(path)
    nat = _read_native(path)
    words = ["b", "a", "c", "zz"]
    for extra in ((), ("e",)):
        ri, rj, rp = ref.bigram_arrays(words, extra)
        ni, nj, npp = nat.bigram_arrays(words, extra)
        np.testing.assert_array_equal(ri, ni)
        np.testing.assert_array_equal(rj, nj)
        np.testing.assert_array_equal(rp, npp)


def test_bigram_arrays_respects_dict_edits(tmp_path):
    path = _write(tmp_path, ARPA)
    nat = _read_native(path)
    nat.bigrams[("a", "c")] = (-0.111, 0.0)
    i, j, p = nat.bigram_arrays(["a", "c"])
    assert len(i) == 2  # (c, a) from the file plus the edited (a, c)
    assert -0.111 in p.tolist()


def test_packed_lazy_dicts_cached_and_writable(tmp_path):
    path = _write(tmp_path, ARPA)
    nat = _read_native(path)
    d1 = nat.bigrams
    assert nat.bigrams is d1
    nat.unigrams = {"q": (0.0, 0.0)}
    assert nat.vocab == ["q"]


def test_binary_roundtrip_packed(tmp_path):
    path = _write(tmp_path, ARPA)
    ref = _read_py(path)
    b1 = str(tmp_path / "lm.bin")
    b2 = str(tmp_path / "lm2.bin")
    lmmod.write_binary_lm(ref, b1)
    back = lmmod.read_binary_lm(b1)
    assert isinstance(back, PackedNGramLM)
    lmmod.write_binary_lm(back, b2)
    assert open(b1, "rb").read() == open(b2, "rb").read()
    # dict views identical to the ARPA-read model up to f32 rounding
    for k, (p, bo) in back.bigrams.items():
        rp, rbo = ref.bigrams[k]
        assert p == pytest.approx(rp, abs=1e-6)
        assert bo == pytest.approx(rbo, abs=1e-6)


def test_arpa_unsupported_order_numbered_error(tmp_path):
    """\\5-grams: must raise HError 8153 on BOTH readers (the native
    codec fails the parse and the Python fallback reports it), not
    silently drop the section or misparse its lines."""
    from htk_jax.utils.errors import HTKError

    text = ("\\data\\\n\\1-grams:\n-1 a\n-1 b\n"
            "\\5-grams:\n-0.1 a b a b a\n\\end\\\n")
    path = _write(tmp_path, text)
    with pytest.raises(HTKError, match="8153"):
        read_arpa(path)
    os.environ["HTKTPU_NO_NATIVE"] = "1"
    try:
        with pytest.raises(HTKError, match="8153"):
            read_arpa(path)
    finally:
        del os.environ["HTKTPU_NO_NATIVE"]


def test_arpa_bad_number_numbered_error(tmp_path):
    """A malformed prob/back-off field raises HError 8154 on both
    readers instead of a raw ValueError (Python) or a silent skip
    (native)."""
    from htk_jax.utils.errors import HTKError

    for bad in ("\\data\\\n\\1-grams:\nxx a\n\\end\\\n",
                "\\data\\\n\\1-grams:\n-1 a notanumber\n\\end\\\n"):
        path = _write(tmp_path, bad, name="bad.arpa")
        with pytest.raises(HTKError, match="815[04]"):
            read_arpa(path)
        os.environ["HTKTPU_NO_NATIVE"] = "1"
        try:
            with pytest.raises(HTKError, match="815[04]"):
                read_arpa(path)
        finally:
            del os.environ["HTKTPU_NO_NATIVE"]


def test_read_lm_filtered_matrix_bigram(tmp_path):
    """read_lm sniffs through HLANGMODFILTER and the matrix-bigram
    reader must read through the SAME filter (it used to open the raw
    gzipped bytes and crash)."""
    import gzip

    from htk_jax.utils.config import Config

    words = ["a", "b"]
    lm = lmmod.NGramLM(order=2)
    lm.unigrams = {"a": (-1.0, 0.0), "b": (-1.0, 0.0)}
    lm.bigrams = {("a", "b"): (-0.5, 0.0), ("b", "a"): (-0.7, 0.0)}
    p = str(tmp_path / "mat.bg")
    lmmod.write_matrix_bigram(lm, words, p)
    gz = p + ".gz"
    gzip.open(gz, "wb").write(open(p, "rb").read())
    cfg = Config()
    cfg.set("HLANGMODFILTER", "gunzip -c $")
    back = lmmod.read_lm(gz, cfg=cfg, words=words)
    plain = lmmod.read_lm(p, words=words)
    assert back.bigrams == plain.bigrams


def test_preload_corpus_matches_open_speech_file(tmp_path):
    """The native corpus preload returns exactly what open_speech_file
    returns per file for _C(_K) feature corpora, and declines files it
    must not cover (uncompressed, segment-sliced)."""
    from htk_jax.io import parmkind as pkm
    from htk_jax.io.htkfeat import write_htk_file
    from htk_jax.tools._common import open_speech_file, preload_corpus
    from htk_jax.utils.config import Config

    rng = np.random.default_rng(4)
    cfg = Config()
    entries = []
    for i, (n, kind) in enumerate([(30, "USER_C"), (45, "USER_C_K"),
                                   (20, "USER")]):
        x = (rng.normal(size=(n, 7)) * 4).astype(np.float32)
        p = str(tmp_path / f"c{i}.usr")
        write_htk_file(p, x, 100000, pkm.str2parmkind(kind))
        entries.append(p)
    entries.append(entries[0] + "[3,10]")  # segment-sliced: not covered
    pre = preload_corpus(entries, cfg)
    if not pre:
        pytest.skip("native codec unavailable (no toolchain)")
    assert entries[0] in pre and entries[1] in pre
    assert entries[2] not in pre  # uncompressed: numpy path wins
    assert entries[3] not in pre  # sliced
    for ent in entries[:2]:
        data, period, kind, e = pre[ent]
        d2, p2, k2, e2 = open_speech_file(ent, cfg)
        np.testing.assert_allclose(data, d2, atol=1e-5)
        assert period == p2 and kind == k2 and e.logical == e2.logical
