"""Model core tests: MMF round-trip, SoA compilation, batched OutP."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from htk_jax.io.mmf import HMMSet, load_mmf, save_mmf, MixPDF
from htk_jax.models.hmmset import compile_hmmset, write_back
from htk_jax.models.proto import clone_proto, make_proto, left_to_right_transp
from htk_jax.ops.outp import all_state_outp
from htk_jax.utils.logmath import LZERO

MMF_TEXT = """~o
<STREAMINFO> 1 4
<VECSIZE> 4<NULLD><MFCC_E><DIAGC>
~v "varFloor1"
<VARIANCE> 4
 1.0e-02 1.0e-02 1.0e-02 1.0e-02
~s "shared2"
<NUMMIXES> 2
<MIXTURE> 1 6.0e-01
<MEAN> 4
 1.0 2.0 3.0 4.0
<VARIANCE> 4
 1.0 1.0 2.0 2.0
<MIXTURE> 2 4.0e-01
<MEAN> 4
 -1.0 -2.0 -3.0 -4.0
<VARIANCE> 4
 0.5 0.5 0.5 0.5
~h "ax"
<BEGINHMM>
<NUMSTATES> 4
<STATE> 2
<MEAN> 4
 0.0 0.0 0.0 0.0
<VARIANCE> 4
 1.0 1.0 1.0 1.0
<STATE> 3
~s "shared2"
<TRANSP> 4
 0.0 1.0 0.0 0.0
 0.0 0.6 0.4 0.0
 0.0 0.0 0.7 0.3
 0.0 0.0 0.0 0.0
<ENDHMM>
~h "eh"
<BEGINHMM>
<NUMSTATES> 4
<STATE> 2
~s "shared2"
<STATE> 3
<MEAN> 4
 5.0 5.0 5.0 5.0
<VARIANCE> 4
 2.0 2.0 2.0 2.0
<TRANSP> 4
 0.0 1.0 0.0 0.0
 0.0 0.5 0.5 0.0
 0.0 0.0 0.5 0.5
 0.0 0.0 0.0 0.0
<ENDHMM>
"""


@pytest.fixture
def hset(tmp_path):
    p = tmp_path / "test.mmf"
    p.write_text(MMF_TEXT)
    return load_mmf(str(p))


class TestMMF:
    def test_parse(self, hset):
        assert hset.vec_size == 4
        assert hset.parm_kind_str == "MFCC_E"
        assert set(hset.hmms) == {"ax", "eh"}
        ax = hset.hmms["ax"]
        assert ax.nstates == 4
        assert len(ax.states) == 2
        # state 3 of ax IS the shared macro object used by eh state 2
        assert hset.hmms["ax"].states[1] is hset.hmms["eh"].states[0]
        assert hset.macros["s"]["shared2"] is ax.states[1]
        np.testing.assert_allclose(ax.transp[1], [0, 0.6, 0.4, 0])
        # gconst computed at load
        mp = ax.states[0].streams[0].mixes[0]
        want = 4 * math.log(2 * math.pi) + 0.0
        assert mp.gconst == pytest.approx(want, rel=1e-6)

    def test_roundtrip(self, hset, tmp_path):
        out = tmp_path / "out.mmf"
        save_mmf(hset, str(out))
        h2 = load_mmf(str(out))
        assert set(h2.hmms) == {"ax", "eh"}
        # sharing preserved through write/read
        assert h2.hmms["ax"].states[1] is h2.hmms["eh"].states[0]
        a1 = hset.hmms["ax"].states[1].streams[0].mixes[0]
        a2 = h2.hmms["ax"].states[1].streams[0].mixes[0]
        np.testing.assert_allclose(a1.mean, a2.mean, rtol=1e-6)
        np.testing.assert_allclose(a1.var, a2.var, rtol=1e-6)
        np.testing.assert_allclose(
            hset.hmms["eh"].transp, h2.hmms["eh"].transp, rtol=1e-6
        )
        # second rewrite is byte-stable
        out2 = tmp_path / "out2.mmf"
        save_mmf(h2, str(out2))
        assert out.read_text() == out2.read_text()

    def test_varfloor_macro(self, hset):
        np.testing.assert_allclose(hset.macros["v"]["varFloor1"], [0.01] * 4)

    def test_hmm_duration_roundtrip(self, hset, tmp_path):
        """Model-level <DURATION> after <TRANSP> survives a round trip."""
        text = MMF_TEXT.replace(
            "<ENDHMM>\n~h \"eh\"",
            "<DURATION> 2\n 3.5 1.25\n<ENDHMM>\n~h \"eh\"")
        p = tmp_path / "dur.mmf"
        p.write_text(text)
        h1 = load_mmf(str(p))
        np.testing.assert_allclose(h1.hmms["ax"].dur, [3.5, 1.25])
        out = tmp_path / "dur_out.mmf"
        save_mmf(h1, str(out))
        h2 = load_mmf(str(out))
        np.testing.assert_allclose(h2.hmms["ax"].dur, [3.5, 1.25])
        assert h2.hmms["eh"].dur is None


class TestCompile:
    def test_compile_shapes_and_tying(self, hset):
        c = compile_hmmset(hset)
        # states: ax.s2, shared2, eh.s3 -> 3 physical states
        assert c.n_states == 3
        # mixes: ax.s2 (1) + shared2 (2) + eh.s3 (1) = 4
        assert c.n_mix == 4
        assert c.max_mix == 2
        assert c.n_models == 2
        assert c.nmax == 4
        ax_id = c.model_id("ax")
        eh_id = c.model_id("eh")
        # shared state appears in both models' state lists
        shared_sid = c.model_states[ax_id][1]
        assert c.model_states[eh_id][0] == shared_sid
        # log transp correct
        np.testing.assert_allclose(
            np.exp(c.log_transp[c.model_transp[ax_id], 1, 1]), 0.6, rtol=1e-5
        )
        assert c.log_transp[c.model_transp[ax_id], 0, 2] == LZERO

    def test_outp_matches_naive(self, hset):
        c = compile_hmmset(hset)
        rng = np.random.default_rng(0)
        x = rng.normal(size=(10, 4)).astype(np.float32)
        logb, mix_lp = all_state_outp(
            jnp.asarray(x),
            jnp.asarray(c.means),
            jnp.asarray(c.variances),
            jnp.asarray(c.gconsts),
            jnp.asarray(c.state_mix),
            jnp.asarray(c.state_logw),
        )
        logb = np.asarray(logb)
        # naive per-frame per-state computation
        for t in range(10):
            for s_idx in range(c.n_states):
                acc = None
                for j in range(c.max_mix):
                    m = c.state_mix[s_idx, j]
                    if m < 0:
                        continue
                    mean, var = c.means[m], c.variances[m]
                    g = c.gconsts[m]
                    lp = -0.5 * (g + np.sum((x[t] - mean) ** 2 / var))
                    lw = c.state_logw[s_idx, j] + lp
                    acc = lw if acc is None else np.logaddexp(acc, lw)
                assert logb[t, s_idx] == pytest.approx(acc, rel=1e-4, abs=1e-3)

    def test_write_back_roundtrip(self, hset):
        c = compile_hmmset(hset)
        new_means = c.means + 1.0
        new_vars = c.variances * 2.0
        hs = write_back(c, means=new_means, variances=new_vars)
        c2 = compile_hmmset(hs)
        np.testing.assert_allclose(c2.means, new_means, rtol=1e-6)
        np.testing.assert_allclose(c2.variances, new_vars, rtol=1e-6)
        # gconsts recomputed
        d = c.dim
        want = d * math.log(2 * math.pi) + np.sum(np.log(new_vars), axis=1)
        np.testing.assert_allclose(c2.gconsts, want, rtol=1e-5)


class TestProto:
    def test_make_and_clone(self):
        hs = make_proto(nstates=5, dim=6, parm_kind="MFCC_E", nmix=2)
        assert hs.hmms["proto"].nstates == 5
        cl = clone_proto(hs, "proto", ["ax", "eh", "sil"])
        assert set(cl.hmms) == {"ax", "eh", "sil"}
        # clones are independent objects
        cl.hmms["ax"].states[0].streams[0].mixes[0].mean[0] = 9.0
        assert cl.hmms["eh"].states[0].streams[0].mixes[0].mean[0] == 0.0

    def test_transp_rows_sum_to_one(self):
        tp = left_to_right_transp(5)
        np.testing.assert_allclose(tp[:-1].sum(axis=1), 1.0, rtol=1e-6)


class TestBinaryMMF:
    """HTK ':'-code binary MMFs (HModel.c SaveHMMSet binary mode)."""

    def _assert_equiv_text(self, h1, h2, tmp_path):
        """Both sets must re-serialise to bit-identical text."""
        p1, p2 = tmp_path / "a.mmf", tmp_path / "b.mmf"
        save_mmf(h1, str(p1))
        save_mmf(h2, str(p2))
        assert p1.read_text() == p2.read_text()

    def test_binary_roundtrip_with_macros(self, hset, tmp_path):
        pb = tmp_path / "bin.mmf"
        save_mmf(hset, str(pb), binary=True)
        raw = pb.read_bytes()
        assert raw.startswith(b"~o :")  # ':'-code symbols, not pickle
        h2 = load_mmf(str(pb))
        # tying preserved through the binary form
        assert h2.hmms["ax"].states[1] is h2.hmms["eh"].states[0]
        self._assert_equiv_text(hset, h2, tmp_path)

    def test_binary_multimix_gconst(self, tmp_path):
        cl = clone_proto(make_proto(nstates=4, dim=5, parm_kind="MFCC_E",
                                    nmix=3), "proto", ["aa", "iy"])
        rng = np.random.default_rng(0)
        for h in cl.hmms.values():
            for si in h.states:
                for mp in si.streams[0].mixes:
                    mp.mean = rng.normal(size=5).astype(np.float32)
                    mp.var = (0.5 + rng.random(5)).astype(np.float32)
                    mp.fix_gconst()
        pb = tmp_path / "m.mmf"
        save_mmf(cl, str(pb), binary=True)
        h2 = load_mmf(str(pb))
        m1 = cl.hmms["aa"].states[0].streams[0].mixes[2]
        m2 = h2.hmms["aa"].states[0].streams[0].mixes[2]
        np.testing.assert_allclose(m1.mean, m2.mean, rtol=1e-6)
        assert m2.gconst == pytest.approx(m1.gconst, rel=1e-6)
        w1 = cl.hmms["aa"].states[0].streams[0].weights
        w2 = h2.hmms["aa"].states[0].streams[0].weights
        np.testing.assert_allclose(w1, w2, rtol=1e-6)

    def test_binary_discrete_dprobs(self, tmp_path):
        from htk_jax.models.proto import make_discrete_proto

        cl = clone_proto(make_discrete_proto(nstates=4, codebook_sizes=[8]),
                         "proto", ["dd"])
        pb = tmp_path / "d.mmf"
        save_mmf(cl, str(pb), binary=True)
        h2 = load_mmf(str(pb))
        s1 = cl.hmms["dd"].states[0].streams[0].dprobs
        s2 = h2.hmms["dd"].states[0].streams[0].dprobs
        np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))

    def test_old_pickle_format_rejected(self, tmp_path):
        from htk_jax.utils.errors import HTKError

        p = tmp_path / "evil.mmf"
        p.write_bytes(b"#!HTK-TPU-BMMF!#" + b"\x80\x04whatever")
        with pytest.raises(HTKError):
            load_mmf(str(p))
