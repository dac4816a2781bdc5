"""Adaptive-exact top-A cross-word (decode._topa_mode, negative
max_active): top-A speed with a per-frame soundness certificate and an
exact bucket-leg fallback under lax.cond — scores equal the exact
decode on EVERY frame, including frames where plain top-A loses paths.
"""

import numpy as np
import pytest

from htk_jax.algo.decode import decode
from htk_jax.algo.lvnet import compile_lv_loop
from htk_jax.utils.errors import HTKError

from test_decode import emit_frames, separable_set
from test_lvdecode import TestFactoredCrossWord, make_lm, make_vocab


def _fixture():
    comp, v, words, lm, lex = TestFactoredCrossWord._big_fixture()
    net = compile_lv_loop(words, v, comp, lm=lm, factored=True)
    assert net.xw_backoff["succ_j"] is not None
    assert net.xw_backoff["marg"] is not None
    return comp, net


class TestAdaptiveExact:
    def test_certificate_catches_excluded_winner(self):
        """Hand-built scan where the exact cross-word winner comes from
        a source OUTSIDE top-1: plain top-1 mis-scores the entry, the
        certificate trips and the adaptive result equals exact
        bit-for-bit."""
        import jax.numpy as jnp

        from htk_jax.algo.decode import decode_scan_uniform_batch

        C, S = 4, 1
        LZ = -1.0e10
        band = jnp.zeros((1, C), jnp.float32)  # free self-loops
        a0 = jnp.zeros(C, jnp.float32)
        aE = jnp.zeros(C, jnp.float32)
        bonus = jnp.zeros(C, jnp.float32)
        start = jnp.asarray([0.0, -1.0, -50.0, -50.0], jnp.float32)
        # explicit bigrams: 1 -> 2 (p = 5, the exact winner at t = 1,
        # from the SECOND-best word end) and 0 -> 3 (p = 0.1)
        preds = np.zeros((C, 4), np.int32)
        scores = np.full((C, 4), LZ, np.float32)
        preds[2, 0] = 1
        scores[2, 0] = 5.0
        preds[3, 0] = 0
        scores[3, 0] = 0.1
        uni = np.full(C, -1.0, np.float32)
        marg = np.full(C, LZ, np.float32)
        marg[1] = 5.0 - (-1.0)
        marg[0] = 0.1 - (-1.0)
        succ_j = np.full((C, 1), C, np.int32)
        succ_p = np.full((C, 1), LZ, np.float32)
        succ_j[1, 0] = 2
        succ_p[1, 0] = 5.0
        succ_j[0, 0] = 3
        succ_p[0, 0] = 0.1
        xw = {
            "bow": jnp.full(C, -1.0, jnp.float32),
            "uni": jnp.asarray(uni),
            "buckets": [(jnp.asarray(preds), jnp.asarray(scores))],
            "inv": jnp.arange(C, dtype=jnp.int32),
            "succ_j": jnp.asarray(succ_j),
            "succ_p": jnp.asarray(succ_p),
            "marg": jnp.asarray(marg),
        }
        outp = jnp.zeros((1, 3, C), jnp.float32)
        args = (band, a0, aE, S, bonus, jnp.zeros((0, 0), jnp.float32),
                start, 0.0)

        def run(ma):
            (v, wn, _wt), _ = decode_scan_uniform_batch(
                outp, *args, max_active=ma, xw=xw)
            return np.asarray(v[0]), np.asarray(wn[0])

        v_ex, wn_ex = run(None)
        v_p1, wn_p1 = run(1)
        v_ad, wn_ad = run(-1)
        # exact: row 2 carries the 1 -> 2 bigram (score -1 + 5 + 0s)
        assert v_ex[2] == pytest.approx(4.0)
        assert wn_ex[2] == 1
        # plain top-1 (row 0 is the only expanded source) misses it
        assert v_p1[2] < v_ex[2]
        # adaptive: certificate trips (WE[1] + marg[1] = 5 > bo_best),
        # bucket fallback recovers the exact value bit-for-bit
        np.testing.assert_array_equal(v_ad, v_ex)
        np.testing.assert_array_equal(wn_ad, wn_ex)

    def test_adaptive_equals_exact_on_decodes(self):
        """End-to-end decodes: adaptive-exact equals the exact decode
        bit-for-bit whether or not A binds."""
        comp, net = _fixture()
        for seed, seq in ((3, ["aa", "iy", "aa", "iy", "aa"]),
                          (9, ["sil", "aa", "iy", "sil"])):
            feats = emit_frames(seq, seed=seed)
            r0 = decode(net, comp, feats, lm_scale=2.0, word_pen=-1.0)
            for ma in (-1, -6):
                ra = decode(net, comp, feats, lm_scale=2.0,
                            word_pen=-1.0, max_active=ma)
                assert ra.words == r0.words
                assert ra.times == r0.times
                assert ra.score == r0.score

    def test_equals_exact_when_safe(self):
        """A big enough that the certificate holds every frame: the
        fast path is taken and still equals exact."""
        comp, net = _fixture()
        feats = emit_frames(["aa", "iy", "sil"], seed=7)
        r0 = decode(net, comp, feats, lm_scale=2.0, word_pen=-1.0)
        ra = decode(net, comp, feats, lm_scale=2.0, word_pen=-1.0,
                    max_active=-net.n_chains)
        assert ra.words == r0.words and ra.score == r0.score

    def test_batch_and_lattice_paths(self):
        from htk_jax.algo.decode import decode_batch, generate_lattice

        comp, net = _fixture()
        seqs = [["aa", "iy", "aa"], ["sil", "aa", "iy"]]
        feats = [emit_frames(s, seed=i + 1) for i, s in enumerate(seqs)]
        rb = decode_batch(net, comp, feats, pad_to=16, max_active=-2)
        for f, r in zip(feats, rb):
            r0 = decode(net, comp, f)
            assert r.words == r0.words and r.score == r0.score
        lat = generate_lattice(net, comp, feats[0], lattice_beam=300.0,
                               max_active=-2)
        lat0 = generate_lattice(net, comp, feats[0], lattice_beam=300.0)
        assert lat is not None and len(lat.arcs) == len(lat0.arcs)

    def test_rejects_unsupported_combos(self):
        comp = separable_set()
        v = make_vocab()
        net_d = compile_lv_loop(["A", "I", "S"], v, comp, lm=make_lm(),
                                factored=False)
        feats = emit_frames(["aa", "iy"], seed=3)
        with pytest.raises(HTKError, match="8526"):
            decode(net_d, comp, feats, max_active=-2)
