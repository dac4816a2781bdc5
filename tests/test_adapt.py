"""Adaptation tests: MLLR mean recovery, CMLLR, MAP, TMF round-trip."""

import numpy as np
import pytest

from htk_jax.algo.adapt import (Transform, cmllr_stats_from_gammas,
                                estimate_cmllr, estimate_mllr_mean, load_tmf,
                                map_update, save_tmf)
from htk_jax.algo.fb import Accumulators
from htk_jax.algo.trainer import Trainer, prepare_utterance

from test_fb import small_set


def accs_for_shift(comp, shift, occ_per_mix=50.0):
    """Synthetic accumulators as if all data were means+shift."""
    M, D = comp.n_mix, comp.dim
    S, mm = comp.state_mix.shape
    occ = np.full(M, occ_per_mix, np.float32)
    target = comp.means + shift
    return Accumulators(
        occ=occ,
        sum_x=(occ[:, None] * target).astype(np.float32),
        sum_xx=(occ[:, None] * (target**2 + comp.variances)).astype(np.float32),
        wt_occ=np.full((S, mm), occ_per_mix, np.float32),
        tr=np.zeros(comp.log_transp.size, np.float32),
        total_logp=np.float32(0.0),
        total_frames=np.float32(occ_per_mix * M),
        n_utts=np.float32(1.0),
    )


class TestMLLR:
    def test_recovers_bias_shift(self):
        comp = small_set(nmix=1, seed=10)
        shift = np.array([1.0, -2.0, 0.5], np.float32)
        accs = accs_for_shift(comp, shift)
        xf = estimate_mllr_mean(comp, accs)
        # transform should map old means onto shifted ones
        got = xf.apply_to_means(comp.means)
        np.testing.assert_allclose(got, comp.means + shift, atol=1e-3)

    def test_recovers_linear_transform(self):
        comp = small_set(nmix=2, seed=11)
        A = np.array([[1.1, 0.1, 0.0], [0.0, 0.9, -0.1], [0.05, 0.0, 1.05]])
        b = np.array([0.3, -0.2, 0.1])
        target = comp.means @ A.T + b
        M = comp.n_mix
        occ = np.full(M, 30.0, np.float32)
        S, mm = comp.state_mix.shape
        accs = Accumulators(
            occ=occ,
            sum_x=(occ[:, None] * target).astype(np.float32),
            sum_xx=(occ[:, None] * (target**2 + comp.variances)).astype(np.float32),
            wt_occ=np.full((S, mm), 30.0, np.float32),
            tr=np.zeros(comp.log_transp.size, np.float32),
            total_logp=np.float32(0), total_frames=np.float32(0),
            n_utts=np.float32(1),
        )
        xf = estimate_mllr_mean(comp, accs)
        np.testing.assert_allclose(xf.A, A, atol=5e-2)
        np.testing.assert_allclose(xf.b, b, atol=5e-2)

    def test_tmf_roundtrip(self, tmp_path):
        xf = Transform(kind="MLLRMEAN",
                       A=np.eye(3, dtype=np.float64) * 1.1,
                       b=np.array([0.1, 0.2, 0.3]))
        p = str(tmp_path / "g.tmf")
        save_tmf(p, "global", xf)
        name, xf2 = load_tmf(p)
        assert name == "global"
        assert xf2.kind == "MLLRMEAN"
        np.testing.assert_allclose(xf2.A, xf.A, rtol=1e-5)
        np.testing.assert_allclose(xf2.b, xf.b, rtol=1e-5)


class TestCMLLR:
    def test_recovers_feature_shift(self):
        """Model-dispersed data shifted by a known offset: CMLLR finds
        A ~ I and b ~ -offset. (Needs more Gaussians than the D*(D+1)
        transform parameters, and noise matched to the model variances —
        under-dispersed data makes CMLLR legitimately scale A up, since
        the log|A| term implements variance adaptation.)"""
        comp = small_set(nmix=3, seed=12)  # 12 Gaussians > 12 params
        rng = np.random.default_rng(0)
        offset = np.array([0.8, -0.5, 0.3])
        T = 1200
        M = comp.n_mix
        gamma = np.zeros((T, M))
        feats = np.zeros((T, comp.dim))
        for t in range(T):
            m = t % M
            gamma[t, m] = 1.0
            feats[t] = (
                comp.means[m] + offset
                + np.sqrt(comp.variances[m]) * rng.normal(size=comp.dim)
            )
        stats = cmllr_stats_from_gammas(feats, gamma, comp.means, comp.variances)
        xf = estimate_cmllr(stats, n_iter=50)
        np.testing.assert_allclose(xf.A, np.eye(3), atol=0.15)
        np.testing.assert_allclose(xf.b, -offset, atol=0.25)


class TestMAP:
    def test_map_interpolates(self):
        comp = small_set(nmix=1, seed=13)
        shift = 2.0
        accs = accs_for_shift(comp, shift, occ_per_mix=10.0)
        m_small_tau = map_update(comp, accs, tau=1.0)
        m_big_tau = map_update(comp, accs, tau=1000.0)
        # small tau ~ ML (full shift); big tau ~ prior (no shift)
        assert np.abs(m_small_tau - (comp.means + shift)).mean() < 0.3
        assert np.abs(m_big_tau - comp.means).mean() < 0.1
        # exact formula check
        occ = 10.0
        want = (5.0 * comp.means + occ * (comp.means + shift)) / (5.0 + occ)
        np.testing.assert_allclose(map_update(comp, accs, 5.0), want, atol=1e-4)


class TestSpeakerMask:
    def test_mask_capture(self):
        from htk_jax.algo.adapt import speaker_from_mask

        assert speaker_from_mask("%%_*", "sA_u3.mfc") == "sA"
        assert speaker_from_mask("*/%%%_*.mfc", "data/abc_001.mfc") == "abc"
        assert speaker_from_mask("%%%*", "spk1utt.mfc") == "spk"
        # non-matching mask falls back to the stem
        assert speaker_from_mask("zz%%", "sA_u3.mfc") == "sA_u3"


class TestMLLRVarAndTree:
    def test_var_scale_recovery(self):
        from htk_jax.algo.adapt import estimate_mllr_var

        comp = small_set(nmix=1, seed=12)
        M = comp.n_mix
        S, mm = comp.state_mix.shape
        occ = np.full(M, 80.0, np.float32)
        scale = np.array([2.0, 0.5, 1.5])
        accs = Accumulators(
            occ=occ,
            sum_x=(occ[:, None] * comp.means).astype(np.float32),
            sum_xx=(occ[:, None] * (comp.means**2
                                    + scale[None, :] * comp.variances)
                    ).astype(np.float32),
            wt_occ=np.full((S, mm), 80.0, np.float32),
            tr=np.zeros(comp.log_transp.size, np.float32),
            total_logp=np.float32(0), total_frames=np.float32(0),
            n_utts=np.float32(1))
        H = estimate_mllr_var(comp, accs, comp.means)
        np.testing.assert_allclose(H, scale, rtol=1e-3)

    def test_tmf_var_roundtrip(self, tmp_path):
        xf = Transform(kind="MLLRMEAN", A=np.eye(3), b=np.zeros(3),
                       var_scale=np.array([1.5, 0.7, 2.0]))
        p = str(tmp_path / "t.tmf")
        save_tmf(p, "spk", xf)
        _n, xf2 = load_tmf(p)
        np.testing.assert_allclose(xf2.var_scale, xf.var_scale, rtol=1e-5)
        np.testing.assert_allclose(xf2.apply_to_vars(np.ones((4, 3)))[0],
                                   xf.var_scale, rtol=1e-5)

    def test_tree_backoff(self):
        from htk_jax.algo.adapt import (build_regression_tree,
                                        estimate_mllr_tree)

        comp = small_set(nmix=2, seed=13)
        classes, parent, leaf = build_regression_tree(comp, 3)
        assert len(leaf) == 3 and parent[0] == -1
        assert set(np.unique(classes)) == {0, 1, 2}
        shift = np.array([1.0, -1.0, 0.5], np.float32)
        accs = accs_for_shift(comp, shift, occ_per_mix=50.0)
        # huge threshold: everything backs off to the root transform
        xfs, c2x = estimate_mllr_tree(comp, accs, classes, parent, leaf,
                                      occ_thresh=1e9)
        assert len(xfs) == 1 and set(np.asarray(c2x)) == {0}
        # tiny threshold: every leaf earns its own transform
        xfs2, c2x2 = estimate_mllr_tree(comp, accs, classes, parent, leaf,
                                        occ_thresh=1.0)
        assert len(set(np.asarray(c2x2))) == 3
        for c in range(3):
            xf = xfs2[int(c2x2[c])]
            sel = classes == c
            np.testing.assert_allclose(xf.apply_to_means(comp.means)[sel],
                                       (comp.means + shift)[sel], atol=1e-2)


class TestMLLRCov:
    def test_recovers_covariance_rotation(self):
        from htk_jax.algo.adapt import (estimate_mllrcov,
                                        mllrcov_stats_from_gammas)

        rng = np.random.default_rng(5)
        comp = small_set(nmix=1, seed=5)
        M, D = comp.n_mix, comp.dim
        th = 0.7
        H0 = np.eye(D)
        H0[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
        H0[2, 2] = 1.6

        T = 3000
        ms = rng.integers(0, M, size=T)
        eps = rng.normal(size=(T, D)) * np.sqrt(comp.variances[ms])
        feats = comp.means[ms] + eps @ H0.T
        gam = np.zeros((T, M))
        gam[np.arange(T), ms] = 1.0

        G, beta = mllrcov_stats_from_gammas(feats, gam, comp.means,
                                            comp.variances)
        xf = estimate_mllrcov(G, beta)
        assert xf.kind == "MLLRCOV" and xf.A.shape == (D, D)

        def avg_ll(H):
            tot = 0.0
            for m in range(M):
                sel = ms == m
                Sig = H @ np.diag(comp.variances[m].astype(np.float64)) @ H.T
                P = np.linalg.inv(Sig)
                d = feats[sel] - comp.means[m]
                q = np.einsum("td,de,te->t", d, P, d)
                tot += (-0.5 * (D * np.log(2 * np.pi)
                                + np.linalg.slogdet(Sig)[1] + q)).sum()
            return tot / T

        ll_id = avg_ll(np.eye(D))
        ll_est = avg_ll(xf.A)
        ll_true = avg_ll(H0)
        assert ll_est > ll_id + 0.1  # clearly better than no transform
        assert ll_est >= ll_true - 0.05  # near the generating transform

    def test_apply_matches_direct_scoring(self):
        import jax.numpy as jnp

        from htk_jax.algo.adapt import apply_mllrcov, estimate_mllrcov
        from htk_jax.ops.outp import full_cov_mix_scores

        rng = np.random.default_rng(6)
        comp = small_set(nmix=1, seed=6)
        M, D = comp.n_mix, comp.dim
        H = np.eye(D) + 0.2 * rng.normal(size=(D, D))
        xf = __import__("htk_jax.algo.adapt", fromlist=["Transform"]
                        ).Transform(kind="MLLRCOV", A=H, b=np.zeros(D))
        fc_proj, fc_mu, gc = apply_mllrcov(comp, xf)
        x = rng.normal(size=(4, D)).astype(np.float32)
        got = np.asarray(full_cov_mix_scores(
            jnp.asarray(x), jnp.asarray(fc_proj), jnp.asarray(fc_mu),
            jnp.asarray(gc)))
        for t in range(4):
            for m in range(M):
                Sig = H @ np.diag(comp.variances[m].astype(np.float64)) @ H.T
                P = np.linalg.inv(Sig)
                d = x[t] - comp.means[m]
                want = -0.5 * (D * np.log(2 * np.pi)
                               + np.linalg.slogdet(Sig)[1] + d @ P @ d)
                assert got[t, m] == pytest.approx(want, rel=2e-4, abs=2e-3)


class TestCMLLRClasses:
    def test_per_class_recovery_and_backoff(self):
        from htk_jax.algo.adapt import (cmllr_stats_from_gammas,
                                        estimate_cmllr_classes)

        rng = np.random.default_rng(9)
        comp = small_set(nmix=2, seed=9)
        M, D = comp.n_mix, comp.dim
        classes = (np.arange(M) % 2).astype(np.int32)
        shifts = {0: np.array([2.0, -1.0, 0.5]), 1: np.array([-1.5, 0.8, 2.0])}

        T = 1200
        ms = rng.integers(0, M, size=T)
        feats = (comp.means[ms]
                 + rng.normal(size=(T, D)) * np.sqrt(comp.variances[ms]))
        for c, sh in shifts.items():
            feats[classes[ms] == c] += sh
        gam = np.zeros((T, M))
        gam[np.arange(T), ms] = 1.0

        g_stats = cmllr_stats_from_gammas(feats, gam, comp.means,
                                          comp.variances)
        c_stats = []
        for c in (0, 1):
            gm = gam * (classes[None, :] == c)
            c_stats.append(cmllr_stats_from_gammas(
                feats, gm, comp.means, comp.variances))
        xfs, c2x = estimate_cmllr_classes(c_stats, g_stats, occ_thresh=10.0)
        assert len(xfs) == 3 and list(c2x) == [1, 2]
        for c in (0, 1):
            xf = xfs[c2x[c]]
            assert xf.kind == "CMLLR"
            np.testing.assert_allclose(xf.b, -shifts[c], atol=0.25)
            np.testing.assert_allclose(xf.A, np.eye(D), atol=0.15)
        # huge threshold: both classes back off to the global transform
        _xfs2, c2x2 = estimate_cmllr_classes(c_stats, g_stats,
                                             occ_thresh=1e9)
        assert set(np.asarray(c2x2)) == {0}

    def test_model_space_application_parity(self):
        import jax.numpy as jnp

        from htk_jax.algo.adapt import Transform, apply_cmllr_classes_fc
        from htk_jax.ops.outp import full_cov_mix_scores

        rng = np.random.default_rng(10)
        comp = small_set(nmix=1, seed=10)
        M, D = comp.n_mix, comp.dim
        A = np.eye(D) + 0.1 * rng.normal(size=(D, D))
        b = rng.normal(size=D)
        xf = Transform(kind="CMLLR", A=A, b=b)
        classes = np.zeros(M, np.int32)
        fc_proj, fc_mu, gc = apply_cmllr_classes_fc(
            comp, [xf], np.zeros(1, np.int32), classes)
        x = rng.normal(size=(3, D)).astype(np.float32)
        got = np.asarray(full_cov_mix_scores(
            jnp.asarray(x), jnp.asarray(fc_proj), jnp.asarray(fc_mu),
            jnp.asarray(gc)))
        logdetA = np.linalg.slogdet(A)[1]
        for t in range(3):
            xt = A @ x[t] + b
            for m in range(M):
                d = xt - comp.means[m]
                want = (-0.5 * (D * np.log(2 * np.pi)
                                + np.sum(np.log(comp.variances[m]))
                                + np.sum(d * d / comp.variances[m]))
                        + logdetA)
                assert got[t, m] == pytest.approx(want, rel=2e-4, abs=3e-3)


class TestBaseclassHTKForm:
    def test_itemlist_baseclass_resolves(self, tmp_path):
        """HTK ~b itemlist base classes (HTKBook adaptation chapter)
        resolve onto compiled Gaussians; save_baseclass's own form
        still loads without the model set."""
        from htk_jax.algo.adapt import load_baseclass

        comp = small_set(nmix=2, seed=3)
        hset = comp._hset
        p = str(tmp_path / "bc.base")
        open(p, "w").write(
            '~b "twoclass"\n<MMFIDMASK> *\n<PARAMETERS> MIXBASE\n'
            "<NUMCLASSES> 2\n"
            "  <CLASS> 1 {a.state[2-3].mix[1-2]}\n"
            "  <CLASS> 2 {b.state[2-3].mix[1-2]}\n")
        name, classes, tree = load_baseclass(p, hset=hset, comp=comp)
        assert name == "twoclass" and tree is None
        assert len(classes) == comp.n_mix
        # every Gaussian of model a in class 0, of model b in class 1
        ida = {id(mp) for si in hset.hmms["a"].states
               for mp in si.streams[0].mixes}
        for k, mp in enumerate(comp._mix_objs):
            want = 0 if id(mp) in ida else 1
            assert classes[k] == want

    def test_itemlist_baseclass_needs_model_set(self, tmp_path):
        from htk_jax.algo.adapt import load_baseclass
        from htk_jax.utils.errors import HTKError

        p = str(tmp_path / "bc2.base")
        open(p, "w").write(
            '~b "g"\n<NUMCLASSES> 1\n<CLASS> 1 {*.state[2].mix[1]}\n')
        with pytest.raises(HTKError, match="7460"):
            load_baseclass(p)


class TestBlockTransforms:
    """HADAPT: BLOCKS — block-diagonal MLLR/CMLLR (HAdapt BLOCKINFO)."""

    def test_cmllr_blocks_recover_shift_with_sparse_data(self):
        """With data far below the full-matrix parameter count, the
        block-diagonal CMLLR still recovers a feature shift where the
        full solve is under-determined; off-block entries are exactly
        zero."""
        from htk_jax.algo.adapt import block_ranges

        comp = small_set(nmix=3, seed=12)
        rng = np.random.default_rng(1)
        offset = np.array([0.8, -0.5, 0.3])
        T = 60  # << the 12 params of a full 3x4 transform per row set
        M = comp.n_mix
        gamma = np.zeros((T, M))
        feats = np.zeros((T, comp.dim))
        for t in range(T):
            m = t % M
            gamma[t, m] = 1.0
            feats[t] = (comp.means[m] + offset
                        + np.sqrt(comp.variances[m])
                        * rng.normal(size=comp.dim))
        stats = cmllr_stats_from_gammas(feats, gamma, comp.means,
                                        comp.variances)
        xf = estimate_cmllr(stats, n_iter=50, blocks=3)
        # 3 blocks on 3 dims = per-dim scale + bias: A is diagonal
        off = ~np.eye(3, dtype=bool)
        np.testing.assert_array_equal(xf.A[off], 0.0)
        np.testing.assert_allclose(np.diag(xf.A), 1.0, atol=0.3)
        np.testing.assert_allclose(xf.b, -offset, atol=0.4)
        assert block_ranges(39, 3) == [(0, 13), (13, 26), (26, 39)]

    def test_mllr_mean_blocks_structure(self):
        from test_fb import small_set as _ss

        comp = small_set(nmix=3, seed=5)
        shift = np.array([1.0, -0.7, 0.4])
        accs = accs_for_shift(comp, shift, occ_per_mix=4.0)
        xf = estimate_mllr_mean(comp, accs, blocks=3)
        off = ~np.eye(3, dtype=bool)
        np.testing.assert_array_equal(xf.A[off], 0.0)
        got = xf.apply_to_means(comp.means)
        np.testing.assert_allclose(got, comp.means + shift, atol=0.2)
