"""Format round-trip tests (SURVEY.md §4: read→write→read identity)."""

import numpy as np
import pytest

from htk_jax.io import parmkind as pk
from htk_jax.io.htkfeat import read_htk_file, write_htk_file
from htk_jax.io.wavefile import Waveform, read_wave, write_wave
from htk_jax.utils.errors import HTKError


class TestParmKind:
    def test_roundtrip(self):
        # canonical qualifier order is E D N A T C K Z 0 V (HParm.c)
        for s in ["MFCC_E_D_A", "MFCC_D_A_Z_0", "FBANK", "PLP_E_D_A_T",
                  "WAVEFORM", "MFCC_E_D_A_C_K", "USER", "DISCRETE_V"]:
            assert pk.parmkind2str(pk.str2parmkind(s)) == s
        # non-canonical input canonicalises
        assert pk.parmkind2str(pk.str2parmkind("MFCC_0_D_A_Z")) == "MFCC_D_A_Z_0"

    def test_codes(self):
        assert pk.str2parmkind("MFCC") == 6
        assert pk.str2parmkind("MFCC_E") == 6 | 0x40
        assert pk.str2parmkind("MFCC_E_D_A") == 6 | 0x40 | 0x100 | 0x200
        assert pk.str2parmkind("mfcc_e") == pk.str2parmkind("MFCC_E")

    def test_bad_kind(self):
        with pytest.raises(HTKError):
            pk.str2parmkind("NOTAKIND")
        with pytest.raises(HTKError):
            pk.str2parmkind("MFCC_Q")


class TestHTKFeatureFile:
    def test_float_roundtrip(self, tmp_path):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(50, 39)).astype(np.float32)
        p = str(tmp_path / "a.mfc")
        kind = pk.str2parmkind("MFCC_E_D_A")
        write_htk_file(p, x, 100000, kind)
        ff = read_htk_file(p)
        assert ff.samp_period == 100000
        assert ff.parm_kind == kind
        assert ff.kind_str == "MFCC_E_D_A"
        np.testing.assert_array_equal(ff.data, x)

    def test_header_is_big_endian(self, tmp_path):
        p = str(tmp_path / "b.mfc")
        write_htk_file(p, np.zeros((3, 2), np.float32), 100000, pk.str2parmkind("USER"))
        raw = open(p, "rb").read()
        n = np.frombuffer(raw[:4], dtype=">i4")[0]
        assert n == 3
        assert len(raw) == 12 + 3 * 2 * 4

    def test_compressed_roundtrip(self, tmp_path):
        rng = np.random.default_rng(2)
        x = (rng.normal(size=(40, 13)) * 10).astype(np.float32)
        p = str(tmp_path / "c.mfc")
        kind = pk.str2parmkind("MFCC_E_C")
        write_htk_file(p, x, 100000, kind)
        raw = open(p, "rb").read()
        n_hdr = np.frombuffer(raw[:4], dtype=">i4")[0]
        samp_size = np.frombuffer(raw[8:10], dtype=">i2")[0]
        assert n_hdr == 44  # +4 rows for A/B vectors
        assert samp_size == 26  # int16 per column
        ff = read_htk_file(p)
        assert ff.data.shape == (40, 13)
        # quantisation error bounded by half a step: range/(2*32767)
        step = (x.max(0) - x.min(0)) / (2 * 32767.0)
        assert np.all(np.abs(ff.data - x) <= step + 1e-6)

    def test_crc_roundtrip_and_corruption(self, tmp_path):
        x = np.ones((5, 4), np.float32)
        p = str(tmp_path / "d.mfc")
        kind = pk.str2parmkind("USER_K")
        write_htk_file(p, x, 100000, kind)
        ff = read_htk_file(p)
        np.testing.assert_array_equal(ff.data, x)
        # corrupt one payload byte -> warning (recoverable), data still parsed
        raw = bytearray(open(p, "rb").read())
        raw[20] ^= 0xFF
        open(p, "wb").write(bytes(raw))
        read_htk_file(p)  # must not raise

    def test_compressed_with_crc(self, tmp_path):
        rng = np.random.default_rng(3)
        x = rng.normal(size=(20, 13)).astype(np.float32)
        p = str(tmp_path / "e.mfc")
        write_htk_file(p, x, 100000, pk.str2parmkind("MFCC_E_C_K"))
        ff = read_htk_file(p)
        assert ff.data.shape == (20, 13)
        assert "_C_K" in ff.kind_str


class TestWave:
    def test_wav_roundtrip(self, tmp_path):
        rng = np.random.default_rng(4)
        s = (rng.normal(size=16000) * 1000).astype(np.int16)
        p = str(tmp_path / "a.wav")
        write_wave(p, Waveform(s, 625), fmt="WAV")
        w = read_wave(p, fmt="WAV")
        assert w.samp_period == 625
        np.testing.assert_array_equal(w.samples, s)

    def test_htk_waveform_roundtrip(self, tmp_path):
        s = np.arange(-100, 100, dtype=np.int16)
        p = str(tmp_path / "a.htk")
        write_wave(p, Waveform(s, 625), fmt="HTK")
        w = read_wave(p, fmt="HTK")
        np.testing.assert_array_equal(w.samples, s)
        assert w.samp_period == 625

    def test_nist(self, tmp_path):
        s = np.arange(0, 50, dtype="<i2")
        hdr = b"NIST_1A\n   1024\n"
        body = (
            "sample_rate -i 16000\nsample_n_bytes -i 2\n"
            "sample_byte_format -s2 01\nsample_coding -s3 pcm\nend_head\n"
        ).encode()
        raw = hdr + body + b" " * (1024 - len(hdr) - len(body)) + s.tobytes()
        p = str(tmp_path / "a.sph")
        open(p, "wb").write(raw)
        w = read_wave(p, fmt="NIST")
        assert w.samp_period == 625
        np.testing.assert_array_equal(w.samples, np.arange(0, 50))

    def test_nohead_needs_rate(self, tmp_path):
        p = str(tmp_path / "raw")
        open(p, "wb").write(b"\x00\x01" * 10)
        with pytest.raises(HTKError):
            read_wave(p, fmt="NOHEAD")
        w = read_wave(p, fmt="NOHEAD", source_rate=625)
        assert len(w.samples) == 10

    def test_multichannel_wav_takes_channel0(self, tmp_path):
        import struct
        rate = 8000
        left = np.arange(10, dtype="<i2")
        right = -np.arange(10, dtype="<i2")
        inter = np.empty(20, dtype="<i2")
        inter[0::2] = left
        inter[1::2] = right
        data = inter.tobytes()
        hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
        hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 2, rate, rate * 4, 4, 16)
        hdr += b"data" + struct.pack("<I", len(data))
        p = str(tmp_path / "st.wav")
        open(p, "wb").write(hdr + data)
        w = read_wave(p, fmt="WAV")
        np.testing.assert_array_equal(w.samples, left)


class TestLegacyWaveFormats:
    def _pcm(self, n=64, seed=0):
        rng = np.random.default_rng(seed)
        return (rng.integers(-3000, 3000, size=n)).astype(np.int16)

    def test_scribe_headerless(self, tmp_path):
        from htk_jax.io.wavefile import read_wave

        x = self._pcm()
        p = str(tmp_path / "a.scr")
        open(p, "wb").write(x.astype(">i2").tobytes())
        w = read_wave(p, fmt="SCRIBE", source_rate=625)
        np.testing.assert_array_equal(w.samples, x)
        assert w.samp_period == 625

    def test_timit_and_ogi_headers(self, tmp_path):
        import struct

        from htk_jax.io.wavefile import read_wave

        x = self._pcm(48)
        for fmt, e in (("TIMIT", "<"), ("OGI", ">")):
            hdr = struct.pack(e + "4h", 12, 1, 1, 62) + struct.pack(
                e + "i", len(x))
            p = str(tmp_path / f"a.{fmt.lower()}")
            open(p, "wb").write(hdr + x.astype(e + "i2").tobytes()
                                + b"\x00\x00")  # trailing junk ignored
            w = read_wave(p, fmt=fmt)
            np.testing.assert_array_equal(w.samples, x)

    def test_sdes1_header_skip(self, tmp_path):
        from htk_jax.io.wavefile import read_wave

        x = self._pcm(32)
        p = str(tmp_path / "a.sd")
        open(p, "wb").write(b"\x00" * 1336 + x.astype(">i2").tobytes())
        w = read_wave(p, fmt="SDES1", source_rate=1250)
        np.testing.assert_array_equal(w.samples, x)
        assert w.samp_period == 1250


class TestEsig:
    """ESIG (Entropic Esignal) container: io/esignal.py (esignal.c role)."""

    def test_roundtrip_archs(self, tmp_path):
        from htk_jax.io.esignal import read_esig, write_esig

        rng = np.random.default_rng(0)
        feats = rng.normal(size=(20, 13)).astype(np.float32)
        for arch in ("EDR1", "NATIVE", "ASCII"):
            p = str(tmp_path / f"f_{arch}.esig")
            write_esig(p, feats, record_freq=100.0, arch=arch)
            ef = read_esig(p)
            assert ef.record_freq == pytest.approx(100.0)
            assert ef.samp_period == 100000
            np.testing.assert_allclose(ef.data, feats, rtol=1e-6)

    def test_waveform_short(self, tmp_path):
        from htk_jax.io.esignal import read_esig, write_esig
        from htk_jax.io.wavefile import read_wave

        x = (np.sin(np.arange(400) / 5.0) * 8000).astype(np.int16)
        p = str(tmp_path / "w.esig")
        write_esig(p, x, record_freq=16000.0)
        ef = read_esig(p)
        assert ef.dtype_name == "SHORT"
        np.testing.assert_array_equal(ef.data.reshape(-1), x)
        wv = read_wave(p, fmt="ESIG")
        assert wv.samp_period == 625
        np.testing.assert_array_equal(wv.samples, x)

    def test_hlist_prints_esig(self, tmp_path, capsys, monkeypatch):
        from htk_jax.io.esignal import write_esig
        from htk_jax.tools import hlist

        monkeypatch.chdir(tmp_path)
        rng = np.random.default_rng(1)
        write_esig("f.esig", rng.normal(size=(5, 4)).astype(np.float32),
                   record_freq=100.0)
        open("cfge", "w").write(
            "SOURCEFORMAT = ESIG\nSOURCEKIND = USER\n")
        assert hlist.run(["-C", "cfge", "-h", "f.esig"]) == 0
        out = capsys.readouterr().out
        assert "ESIG" in out and "FLOAT" in out and "Num Samples:          5" in out


class TestIOFilters:
    """HShell xxFILTER channels (utils/filters.py)."""

    def _cfg(self, **kv):
        from htk_jax.utils.config import Config

        c = Config()
        for k, v in kv.items():
            c.set(k, v)
        return c

    def test_parm_filter_decompresses(self, tmp_path, monkeypatch):
        import gzip

        from htk_jax.tools._common import open_speech_file

        monkeypatch.chdir(tmp_path)
        x = np.random.default_rng(0).normal(size=(12, 5)).astype(np.float32)
        write_htk_file("a.usr", x, 100000, pk.str2parmkind("USER"))
        gzip.open("a.usr.gz", "wb").write(open("a.usr", "rb").read())
        cfg = self._cfg(HPARMFILTER="gunzip -c $", TARGETKIND="USER")
        data, period, kind, _e = open_speech_file("a.usr.gz", cfg)
        np.testing.assert_allclose(data, x, rtol=1e-6)
        assert period == 100000

    def test_wave_filter_and_stdin_form(self, tmp_path, monkeypatch):
        import gzip

        from htk_jax.tools._common import open_speech_file

        monkeypatch.chdir(tmp_path)
        rng = np.random.default_rng(1)
        s = (rng.normal(size=4000) * 1000).astype(np.int16)
        write_wave("a.wav", Waveform(samples=s, samp_period=625), fmt="WAV")
        gzip.open("a.wav.gz", "wb").write(open("a.wav", "rb").read())
        # no '$' in the command: the file arrives on stdin
        cfg = self._cfg(HWAVEFILTER="gunzip -c",
                        SOURCEFORMAT="WAV", SOURCEKIND="WAVEFORM",
                        TARGETKIND="MFCC_E")
        data, _p, _k, _e = open_speech_file("a.wav.gz", cfg)
        cfg2 = self._cfg(SOURCEFORMAT="WAV", SOURCEKIND="WAVEFORM",
                         TARGETKIND="MFCC_E")
        want, _p2, _k2, _e2 = open_speech_file("a.wav", cfg2)
        np.testing.assert_allclose(data, want, rtol=1e-6)

    def test_label_filter_on_mlf(self, tmp_path, monkeypatch):
        import gzip

        from htk_jax.io.mlf import MLF

        monkeypatch.chdir(tmp_path)
        gzip.open("l.mlf.gz", "wt").write(
            '#!MLF!#\n"*/u1.lab"\naa\niy\n.\n')
        m = MLF.load("l.mlf.gz", self._cfg(HLABELFILTER="gunzip -c $"))
        pats = [pat for pat, _tr in m.entries]
        assert pats == ["*/u1.lab"]

    def test_filter_failure_is_numbered(self, tmp_path, monkeypatch):
        from htk_jax.utils.filters import maybe_filter

        monkeypatch.chdir(tmp_path)
        open("x", "w").write("hi")
        with pytest.raises(HTKError) as ei:
            maybe_filter("x", "HPARMFILTER",
                         self._cfg(HPARMFILTER="false"))
        assert "+1013" in str(ei.value) or "1013" in str(ei.value)

    def test_no_filter_is_identity(self, tmp_path):
        from htk_jax.utils.filters import maybe_filter

        p = str(tmp_path / "y")
        open(p, "w").write("z")
        path, tmp = maybe_filter(p, "HPARMFILTER", self._cfg())
        assert path == p and tmp is None

    def test_output_filter_roundtrip(self, tmp_path, monkeypatch):
        """HPARMOFILTER compresses what HCopy writes; HPARMFILTER reads
        it back bit-identically."""
        import gzip

        from htk_jax.tools import hcopy
        from htk_jax.tools._common import open_speech_file

        monkeypatch.chdir(tmp_path)
        x = np.random.default_rng(2).normal(size=(9, 6)).astype(np.float32)
        write_htk_file("in.usr", x, 100000, pk.str2parmkind("USER"))
        open("cfgo", "w").write(
            "TARGETKIND = USER\nHPARMOFILTER = gzip -c > $\n")
        assert hcopy.run(["-C", "cfgo", "in.usr", "out.usr.gz"]) == 0
        assert gzip.open("out.usr.gz", "rb").read(1)  # really gzipped
        cfg = self._cfg(HPARMFILTER="gunzip -c $", TARGETKIND="USER")
        data, _p, _k, _e = open_speech_file("out.usr.gz", cfg)
        np.testing.assert_allclose(data, x, rtol=1e-6)

    def test_label_output_filter(self, tmp_path, monkeypatch):
        import gzip

        from htk_jax.io.mlf import MLF, Label, Transcription

        monkeypatch.chdir(tmp_path)
        m = MLF()
        m.entries.append(("*/u.lab", Transcription(
            alternatives=[[Label(name="aa")]])))
        m.save("o.mlf.gz", with_times=False,
               cfg=self._cfg(HLABELOFILTER="gzip -c > $"))
        txt = gzip.open("o.mlf.gz", "rt").read()
        assert txt.startswith("#!MLF!#") and "aa" in txt
