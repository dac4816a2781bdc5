"""Tests for L1 runtime: logmath (LAdd semantics), config parser, CLI, scp."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from htk_jax.utils import logmath
from htk_jax.utils.config import Config
from htk_jax.utils.cli import Option, parse_args, read_scp
from htk_jax.utils.errors import HTKError
from htk_jax.io.scp import parse_scp_entry


def ladd_ref(x, y):
    """Literal transcription of HMath.c LAdd for scalar reference."""
    if x < y:
        x, y = y, x
    diff = y - x
    if diff < logmath.MINLOGEXP:
        return x if x > logmath.LSMALL else logmath.LZERO
    return x + math.log(1.0 + math.exp(diff))


class TestLogMath:
    def test_ladd_matches_reference_scalar(self):
        cases = [
            (-1.0, -2.0),
            (-100.0, -100.0),
            (-1.0, -50.0),
            (logmath.LZERO, -5.0),
            (logmath.LZERO, logmath.LZERO),
            (-0.6e10, -0.7e10),  # both below LSMALL -> LZERO
            (0.0, 0.0),
            (-30.0, -5.0),
        ]
        for x, y in cases:
            got = float(logmath.ladd(jnp.float64(x) if False else jnp.array(x), jnp.array(y)))
            want = ladd_ref(x, y)
            assert got == pytest.approx(want, rel=1e-5, abs=1e-5), (x, y)

    def test_ladd_lzero_identity(self):
        x = jnp.array([-3.0, -700.0, logmath.LZERO])
        out = logmath.ladd(x, jnp.full_like(x, logmath.LZERO))
        np.testing.assert_allclose(out[:2], x[:2], rtol=1e-6)
        assert float(out[2]) == logmath.LZERO

    def test_ladd_reduce_matches_fold(self):
        rng = np.random.default_rng(0)
        a = rng.uniform(-50, 0, size=(4, 7)).astype(np.float32)
        a[1, 3] = logmath.LZERO
        a[2, :] = logmath.LZERO
        got = logmath.ladd_reduce(jnp.array(a), axis=-1)
        for i in range(4):
            acc = logmath.LZERO
            for v in a[i]:
                acc = ladd_ref(acc, float(v))
            assert float(got[i]) == pytest.approx(acc, rel=1e-5, abs=1e-4), i

    def test_lsub(self):
        x, y = -2.0, -3.0
        want = math.log(math.exp(x) - math.exp(y))
        assert float(logmath.lsub(jnp.array(x), jnp.array(y))) == pytest.approx(want, rel=1e-4)
        # equal args -> LZERO (complete cancellation)
        assert float(logmath.lsub(jnp.array(-2.0), jnp.array(-2.0))) == logmath.LZERO

    def test_jit_and_vmap(self):
        f = jax.jit(logmath.ladd)
        assert float(f(jnp.array(-1.0), jnp.array(-1.0))) == pytest.approx(
            -1.0 + math.log(2.0), rel=1e-6
        )


class TestConfig:
    def test_parse_and_precedence(self):
        c = Config()
        c.read_string(
            """
            # comment
            TARGETKIND = MFCC_E_D_A
            HPARM: TARGETKIND = PLP_0
            SOURCERATE = 625
            ENORMALISE = F
            HPARM: SAVEWITHCRC = T   # trailing comment
            WINDOWSIZE = 250000.0
            """
        )
        assert c.str_("TARGETKIND") == "MFCC_E_D_A"
        assert c.str_("TARGETKIND", module="HPARM") == "PLP_0"
        assert c.str_("TARGETKIND", module="HWAVE") == "MFCC_E_D_A"
        assert c.int_("SOURCERATE") == 625
        assert c.bool_("ENORMALISE") is False
        assert c.bool_("SAVEWITHCRC", module="HPARM") is True
        assert c.flt_("WINDOWSIZE") == 250000.0
        assert c.str_("NOSUCH", "dflt") == "dflt"

    def test_case_insensitive(self):
        c = Config()
        c.read_string("hparm: targetkind = MFCC")
        assert c.str_("TargetKind", module="HParm") == "MFCC"

    def test_bad_line_raises(self):
        c = Config()
        with pytest.raises(HTKError):
            c.read_string("THIS IS NOT = = VALID %%")

    def test_config_file_and_set(self, tmp_path):
        p = tmp_path / "cfg"
        p.write_text("NUMCEPS = 12\n")
        c = Config.load([str(p)], use_env=False)
        assert c.int_("NUMCEPS") == 12
        c.set("NUMCEPS", "13")
        assert c.int_("NUMCEPS") == 13


class TestCli:
    def test_std_and_tool_opts(self, tmp_path):
        cfg = tmp_path / "c1"
        cfg.write_text("TARGETKIND = MFCC_E\n")
        scp = tmp_path / "s.scp"
        scp.write_text("a.wav b.wav\nc.wav\n# cmt\n")
        ta = parse_args(
            "HCopy",
            ["-C", str(cfg), "-T", "1", "-S", str(scp), "src.wav", "tgt.mfc"],
            {"n": Option("n", 1, "nbest", typ=int)},
            min_args=0,
        )
        assert ta.trace == 1
        assert ta.script == ["a.wav", "b.wav", "c.wav"]
        assert ta.args == ["src.wav", "tgt.mfc"]
        assert ta.config.str_("TARGETKIND") == "MFCC_E"

    def test_negative_number_positional(self):
        ta = parse_args("HVite", ["-p", "-4.0", "-s", "5.0"],
                        {"p": Option("p", 1, "word pen", typ=float),
                         "s": Option("s", 1, "lm scale", typ=float)})
        assert ta.get("p") == -4.0
        assert ta.get("s") == 5.0

    def test_multi_value_option(self):
        ta = parse_args(
            "HERest",
            ["-t", "250.0", "150.0", "1000.0"],
            {"t": Option("t", 3, "beams", typ=float)},
        )
        assert ta.get("t") == (250.0, 150.0, 1000.0)

    def test_unknown_option_raises(self):
        with pytest.raises(HTKError):
            parse_args("HFoo", ["-Q"], {})


class TestScp:
    def test_plain(self):
        e = parse_scp_entry("/data/x.wav")
        assert e.logical == e.physical == "/data/x.wav"
        assert e.start is None

    def test_alias_and_segment(self):
        e = parse_scp_entry("utt1=/data/x.wav[100,299]")
        assert e.logical == "utt1"
        assert e.physical == "/data/x.wav"
        assert (e.start, e.end) == (100, 299)

    def test_segment_only(self):
        e = parse_scp_entry("/d/y.mfc[0,9]")
        assert e.logical == "/d/y.mfc"
        assert e.physical == "/d/y.mfc"
        assert (e.start, e.end) == (0, 9)


class TestMetrics:
    def test_emit_and_profile_noop(self, tmp_path):
        import json

        from htk_jax.utils.config import Config
        from htk_jax.utils.metrics import emit_metric, maybe_profile

        cfg = Config()
        emit_metric(cfg, "X", a=1)  # no METRICS configured: no-op
        with maybe_profile(cfg, "X"):
            pass

        mfile = tmp_path / "m.jsonl"
        cfg.set("METRICS", str(mfile), module="HTKTPU")
        emit_metric(cfg, "HERest", logp_per_frame=-50.0, frames=100)
        emit_metric(cfg, "HResults", corr=100.0)
        recs = [json.loads(l) for l in open(mfile)]
        assert recs[0]["tool"] == "HERest"
        assert recs[0]["logp_per_frame"] == -50.0
        assert recs[1]["corr"] == 100.0

    def test_metrics_through_tools(self, tmp_path, monkeypatch):
        """HTKTPU: METRICS captures HERest + HResults milestones."""
        # covered structurally; the e2e corpora exercise the tools —
        # here just confirm the config key routes through HResults
        import json

        from htk_jax.tools import hresults

        monkeypatch.chdir(tmp_path)
        open("ref.mlf", "w").write('#!MLF!#\n"*/u0.lab"\na\nb\n.\n')
        open("rec.mlf", "w").write('#!MLF!#\n"*/u0.rec"\na\nb\n.\n')
        open("cfg", "w").write(f"HTKTPU: METRICS = m.jsonl\n")
        open("wl", "w").write("a\nb\n")
        assert hresults.run(["-C", "cfg", "-I", "ref.mlf", "wl",
                             "rec.mlf"]) == 0
        rec = json.loads(open("m.jsonl").readline())
        assert rec["tool"] == "HResults" and rec["corr"] == 100.0


class TestLabelFormats:
    def test_timit_labels_convert(self, tmp_path, monkeypatch):
        """HLEd -G TIMIT converts sample-count labels into an HTK MLF
        (the TIMIT .phn recipe entry point)."""
        from htk_jax.io.mlf import MLF
        from htk_jax.tools import hled

        monkeypatch.chdir(tmp_path)
        open("u1.phn", "w").write("0 1600 sil\n1600 9600 aa\n9600 12800 sil\n")
        open("noop.led", "w").write("\n")
        assert hled.run(["-G", "TIMIT", "-i", "out.mlf",
                         "noop.led", "u1.phn"]) == 0
        m = MLF.load("out.mlf")
        tr = m.entries[0][1]
        assert [l.name for l in tr.labels] == ["sil", "aa", "sil"]

    def test_timit_times_scale_by_625(self):
        from htk_jax.io.mlf import load_label_file
        import os, tempfile

        d = tempfile.mkdtemp()
        p = os.path.join(d, "x.phn")
        open(p, "w").write("0 16000 aa\n")
        tr = load_label_file(p, "TIMIT")
        assert tr.labels[0].start == 0
        assert tr.labels[0].end == 16000 * 625  # 1 s at 16 kHz

    def test_esps_labels(self, tmp_path):
        from htk_jax.io.mlf import load_label_file

        p = str(tmp_path / "x.lab")
        open(p, "w").write(
            "signal x\nnfields 1\n#\n  0.50 121 aa\n  1.25 121 iy\n")
        tr = load_label_file(p, "ESPS")
        assert [l.name for l in tr.labels] == ["aa", "iy"]
        assert tr.labels[0].start == 0 and tr.labels[0].end == 5000000
        assert tr.labels[1].start == 5000000 and tr.labels[1].end == 12500000

    def test_scribe_sam_labels(self, tmp_path):
        from htk_jax.io.mlf import load_label_file
        from htk_jax.utils.config import Config

        p = str(tmp_path / "x.sam")
        open(p, "w").write(
            "LHD: SAM, 5.10\n"          # other SAM keys are skipped
            "SRC: corpus\n"
            "LBA: 0, 8000, 16000, aa\n"
            "LBB: 16000, , 32000, vowel\n"
            "UTS: 0, , 32000, hello world\n"
            "ELF:\n")
        tr = load_label_file(p, "SCRIBE")
        assert [l.name for l in tr.labels] == ["aa", "vowel", "hello world"]
        # sample counts scale by SOURCERATE (default 625 = 16 kHz)
        assert tr.labels[0].start == 0
        assert tr.labels[0].end == 16000 * 625
        assert tr.labels[1].end == 32000 * 625
        # SOURCERATE config overrides the scale
        cfg = Config.load([], use_env=False)
        cfg.set("SOURCERATE", "1250", module="HWAVE")
        tr2 = load_label_file(p, "SCRIBE", cfg)
        assert tr2.labels[0].end == 16000 * 1250

    def test_unknown_format_rejected(self, tmp_path):
        import pytest as _pytest

        from htk_jax.io.mlf import load_label_file
        from htk_jax.utils.errors import HTKError

        p = str(tmp_path / "y.lab")
        open(p, "w").write("x\n")
        with _pytest.raises(HTKError):
            load_label_file(p, "SPHERE")


class TestOutpPrecision:
    """HTKTPU: PRECISION maps onto jax matmul precision for OutP paths."""

    def test_values_and_default(self):
        from htk_jax.tools._common import outp_precision

        cfg = Config.load([], use_env=False)
        assert outp_precision(cfg) == "highest"
        for v in ("default", "high", "highest", "DEFAULT"):
            cfg.set("PRECISION", v, module="HTKTPU")
            assert outp_precision(cfg) == v.lower()

    def test_bad_value_rejected(self):
        from htk_jax.tools._common import outp_precision

        cfg = Config.load([], use_env=False)
        cfg.set("PRECISION", "bf16", module="HTKTPU")
        with pytest.raises(HTKError):
            outp_precision(cfg)
