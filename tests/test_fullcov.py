"""Full-covariance (FULLC/LLTC) recognition path."""

import numpy as np
import pytest

from htk_jax.io.mmf import load_mmf, save_mmf
from htk_jax.models.hmmset import compile_hmmset
from htk_jax.models.proto import clone_proto, make_proto
from htk_jax.utils.errors import HTKError

from test_decode import emit_frames, separable_set

DIM = 3


def _diag_set():
    hs = make_proto(nstates=4, dim=DIM, parm_kind="USER")
    cl = clone_proto(hs, "proto", ["aa", "iy", "sil"])
    centers = {"aa": 5.0, "iy": -5.0, "sil": 0.0}
    for nm, h in cl.hmms.items():
        for k, si in enumerate(h.states):
            mp = si.streams[0].mixes[0]
            mp.mean = np.full(DIM, centers[nm], np.float32) + 0.3 * k
            mp.var = np.array([0.6, 0.8, 0.5], np.float32)
            mp.fix_gconst()
    return cl


def _to_fullc(hset, corr=0.0):
    """Convert every Gaussian to FULLC with precision diag(1/var) plus
    optional off-diagonal correlation structure."""
    for h in hset.hmms.values():
        for si in h.states:
            mp = si.streams[0].mixes[0]
            Sigma = np.diag(mp.var.astype(np.float64))
            if corr:
                for i in range(DIM):
                    for j in range(DIM):
                        if i != j:
                            Sigma[i, j] = corr * np.sqrt(
                                Sigma[i, i] * Sigma[j, j])
            mp.var = np.linalg.inv(Sigma).astype(np.float32)
            mp.cov_kind = "FULLC"
            mp.fix_gconst()
    return hset


def test_fullc_scores_match_f64_oracle():
    from htk_jax.ops.outp import full_cov_mix_scores
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    M, D, T = 4, DIM, 6
    mus = rng.normal(size=(M, D))
    Ps = []
    for _ in range(M):
        A = rng.normal(size=(D, D))
        Ps.append(A @ A.T + np.eye(D))
    x = rng.normal(size=(T, D))

    fc_proj = np.zeros((M, D, D), np.float32)
    fc_mu = np.zeros((M, D), np.float32)
    gc = np.zeros(M, np.float32)
    for m, P in enumerate(Ps):
        L = np.linalg.cholesky(P)
        fc_proj[m] = L
        fc_mu[m] = mus[m] @ L
        gc[m] = D * np.log(2 * np.pi) - np.linalg.slogdet(P)[1]
    got = np.asarray(full_cov_mix_scores(
        jnp.asarray(x, jnp.float32), jnp.asarray(fc_proj),
        jnp.asarray(fc_mu), jnp.asarray(gc)))
    for t in range(T):
        for m in range(M):
            d = x[t] - mus[m]
            want = -0.5 * (D * np.log(2 * np.pi)
                           - np.linalg.slogdet(Ps[m])[1] + d @ Ps[m] @ d)
            assert got[t, m] == pytest.approx(want, rel=2e-4, abs=2e-3)


def test_fullc_diag_precision_decodes_like_diagc():
    from htk_jax.algo.decode import decode
    from htk_jax.algo.net import compile_network
    from htk_jax.io.dictionary import Vocab
    from htk_jax.tools.hbuild import word_loop_lattice

    comp_d = compile_hmmset(_diag_set())
    comp_f = compile_hmmset(_to_fullc(_diag_set()))
    assert comp_f.full_cov and not comp_d.full_cov

    lat = word_loop_lattice(["A", "I", "S"])
    v = Vocab()
    v.add_pron("A", ["aa"])
    v.add_pron("I", ["iy"])
    v.add_pron("S", ["sil"], out_sym="")
    net_d = compile_network(lat, v, comp_d)
    net_f = compile_network(lat, v, comp_f)
    feats = emit_frames(["sil", "aa", "iy", "aa", "sil"], seed=3)
    r_d = decode(net_d, comp_d, feats)
    r_f = decode(net_f, comp_f, feats)
    assert r_f is not None
    assert r_f.words == r_d.words == ["A", "I", "A"]
    assert r_f.score == pytest.approx(r_d.score, rel=1e-5)


def test_fullc_mmf_roundtrip_and_align(tmp_path):
    from htk_jax.algo.composite import build_composite
    from htk_jax.algo.viterbi import align

    hs = _to_fullc(_diag_set(), corr=0.3)
    p = str(tmp_path / "hmmdefs")
    save_mmf(hs, p)
    assert "<INVCOVAR>" in open(p).read()
    hs2 = load_mmf(p)
    comp = compile_hmmset(hs2)
    assert comp.full_cov
    seq = ["sil", "aa", "sil"]
    feats = emit_frames(seq)
    hmm = build_composite(comp, [comp.model_id(s) for s in seq])
    res = align(comp, hmm, feats)
    assert len(res.model_seq) == 3
    assert np.isfinite(res.score)


def test_fullc_training_rejected():
    from htk_jax.algo.trainer import Trainer

    comp = compile_hmmset(_to_fullc(_diag_set()))
    with pytest.raises(HTKError):
        Trainer(comp)


class TestFullCovTraining:
    def _fullc_set(self, dim=3):
        """separable_set converted to FULLC (inverse-covariance full
        matrices seeded from the diagonal model)."""
        from test_decode import separable_set  # noqa: F401
        from htk_jax.models.proto import clone_proto, make_proto

        hs = make_proto(nstates=4, dim=dim, parm_kind="USER")
        cl = clone_proto(hs, "proto", ["a", "b"])
        rng = np.random.default_rng(0)
        for nm, h in cl.hmms.items():
            c = 4.0 if nm == "a" else -4.0
            for k, si in enumerate(h.states):
                mp = si.streams[0].mixes[0]
                mp.mean = (c + 0.3 * k + 0.1 * rng.normal(size=dim)).astype(
                    np.float32)
                mp.var = np.eye(dim, dtype=np.float32) * 1.2  # inv cov
                mp.cov_kind = "FULLC"
                mp.fix_gconst()
        cl.cov_kind = "FULLC"
        return cl

    def _corpus(self, n=8, dim=3, seed=1):
        """Correlated per-class emissions: x = A_c z + mu_c."""
        rng = np.random.default_rng(seed)
        A = {"a": np.array([[1.0, 0.8, 0.0], [0.0, 0.6, 0.0],
                            [0.0, 0.5, 0.9]]),
             "b": np.array([[0.7, 0.0, 0.0], [0.6, 1.0, 0.0],
                            [0.0, 0.0, 0.8]])}
        mu = {"a": 4.0, "b": -4.0}
        utts = []
        for i in range(n):
            seq = ["a", "b"] if i % 2 == 0 else ["b", "a"]
            frames = []
            for p in seq:
                z = rng.normal(size=(10, dim))
                frames.append(z @ A[p].T + mu[p])
            utts.append((f"u{i}", np.concatenate(frames).astype(np.float32),
                         seq))
        return utts

    def test_em_improves_and_learns_offdiagonals(self):
        from htk_jax.algo.fullcov_train import (fullcov_accumulate,
                                                fullcov_update)
        from htk_jax.algo.trainer import prepare_utterance
        from htk_jax.models.hmmset import compile_hmmset

        hs = self._fullc_set()
        comp = compile_hmmset(hs)
        assert comp.full_cov
        data = self._corpus()

        logps = []
        for it in range(3):
            utts = [prepare_utterance(comp, nm, f, seq)
                    for nm, f, seq in data]
            accs, xxT = fullcov_accumulate(comp, utts)
            logps.append(float(np.asarray(accs.total_logp)))
            comp, n_upd = fullcov_update(hs, comp, accs, xxT)
            assert n_upd > 0
        # EM monotonicity across full-covariance updates
        assert logps[1] > logps[0]
        assert logps[2] >= logps[1] - 1e-3
        # the learned precision is genuinely non-diagonal
        off = 0.0
        for mp in hs.hmms["a"].states[1].streams[0].mixes:
            v = np.asarray(mp.var)
            off = max(off, float(np.abs(v - np.diag(np.diag(v))).max()))
        assert off > 0.05

    def test_herest_tool_fullc_training(self, tmp_path, monkeypatch,
                                        capsys):
        from htk_jax.io.htkfeat import write_htk_file
        from htk_jax.io.mmf import load_mmf, save_mmf
        from htk_jax.io.parmkind import str2parmkind
        from htk_jax.tools import herest

        monkeypatch.chdir(tmp_path)
        hs = self._fullc_set()
        save_mmf(hs, "hmmdefs")
        data = self._corpus(n=6)
        with open("phones.mlf", "w") as f:
            f.write("#!MLF!#\n")
            for nm, feats, seq in data:
                write_htk_file(f"{nm}.usr", feats, 100000,
                               str2parmkind("USER"))
                f.write(f'"*/{nm}.lab"\n' + "\n".join(seq) + "\n.\n")
        open("train.scp", "w").write(
            "\n".join(f"{nm}.usr" for nm, _f, _s in data))
        open("list", "w").write("a\nb\n")
        open("cfg", "w").write("TARGETKIND = USER\n")
        import os
        os.makedirs("out", exist_ok=True)
        assert herest.run(["-C", "cfg", "-T", "1", "-I", "phones.mlf",
                           "-H", "hmmdefs", "-M", "out",
                           "-S", "train.scp", "list"]) == 0
        out = capsys.readouterr().out
        assert "FULLC update touched" in out
        h2 = load_mmf("out/hmmdefs")
        mp = h2.hmms["a"].states[0].streams[0].mixes[0]
        assert mp.cov_kind == "FULLC"
        v = np.asarray(mp.var)
        assert np.abs(v - np.diag(np.diag(v))).max() > 0.01


class TestFullCovAdaptation:
    """MLLR mean adaptation on FULLC sets (the exact coupled-row solve)."""

    def _accs_for_target(self, comp, target, occ_per_mix=50.0):
        from htk_jax.algo.fb import Accumulators

        M = comp.n_mix
        S, mm = comp.state_mix.shape
        occ = np.full(M, occ_per_mix, np.float32)
        return Accumulators(
            occ=occ,
            sum_x=(occ[:, None] * target).astype(np.float32),
            sum_xx=(occ[:, None]
                    * (target**2 + comp.variances)).astype(np.float32),
            wt_occ=np.full((S, mm), occ_per_mix, np.float32),
            tr=np.zeros(comp.log_transp.size, np.float32),
            total_logp=np.float32(0.0),
            total_frames=np.float32(occ_per_mix * M),
            n_utts=np.float32(1.0),
        )

    def test_matches_rowwise_solution_on_diagonal_precisions(self):
        """With diagonal precisions the coupled D(D+1) system decouples
        into HAdapt's row-wise solves — both paths must agree."""
        from htk_jax.algo.adapt import estimate_mllr_mean

        comp_d = compile_hmmset(_diag_set())
        comp_f = compile_hmmset(_to_fullc(_diag_set()))
        assert comp_f.full_cov and not comp_d.full_cov
        A = np.array([[1.1, 0.2, 0.0], [0.0, 0.9, -0.1], [0.1, 0.0, 1.0]])
        b = np.array([0.4, -0.3, 0.2])
        target = comp_d.means.astype(np.float64) @ A.T + b
        xf_d = estimate_mllr_mean(comp_d, self._accs_for_target(
            comp_d, target))
        xf_f = estimate_mllr_mean(comp_f, self._accs_for_target(
            comp_f, target))
        np.testing.assert_allclose(xf_f.A, xf_d.A, atol=1e-3)
        np.testing.assert_allclose(xf_f.b, xf_d.b, atol=1e-3)

    def test_exact_recovery_with_correlated_precisions(self):
        from htk_jax.algo.adapt import estimate_mllr_mean, estimate_mllr_var

        hs = _to_fullc(_diag_set(), corr=0.4)
        # _diag_set means are constant across dims, which makes A
        # unidentifiable (only W xi at the observed means is determined);
        # jitter per-dim so full recovery is well-posed
        rng = np.random.default_rng(5)
        for h in hs.hmms.values():
            for si in h.states:
                mp = si.streams[0].mixes[0]
                mp.mean = (mp.mean + rng.normal(size=DIM)).astype(np.float32)
        comp = compile_hmmset(hs)
        A = np.array([[0.95, 0.15, 0.0], [-0.1, 1.05, 0.1],
                      [0.0, 0.05, 0.9]])
        b = np.array([0.5, 0.0, -0.4])
        target = comp.means.astype(np.float64) @ A.T + b
        accs = self._accs_for_target(comp, target)
        xf = estimate_mllr_mean(comp, accs)
        np.testing.assert_allclose(xf.A, A, atol=1e-2)
        np.testing.assert_allclose(xf.b, b, atol=1e-2)
        # diagonal variance scaling is undefined on a full covariance
        with pytest.raises(HTKError):
            estimate_mllr_var(comp, accs, xf.apply_to_means(comp.means))

    def _fullc_decode_setup(self, shift):
        """FULLC models + word loop + a shifted test utterance on disk."""
        from htk_jax.io.htkfeat import write_htk_file
        from htk_jax.io.parmkind import str2parmkind
        from htk_jax.tools import hbuild

        save_mmf(_to_fullc(_diag_set(), corr=0.3), "hmmdefs")
        open("list", "w").write("aa\niy\nsil\n")
        open("dict", "w").write("A aa\nI iy\nS [] sil\n")
        open("wlist", "w").write("A\nI\nS\n")
        open("cfg", "w").write("TARGETKIND = USER\n")
        assert hbuild.run(["wlist", "wdnet.slf"]) == 0
        feats = emit_frames(["sil", "aa", "iy", "aa", "sil"], seed=7) + shift
        write_htk_file("test.usr", feats.astype(np.float32), 100000,
                       str2parmkind("USER"))

    def _rec_words(self, path):
        return [t[2] for t in (line.split() for line in open(path))
                if len(t) >= 3 and t[0].isdigit()]

    def test_herest_k_estimates_and_hvite_j_applies(self, tmp_path,
                                                    monkeypatch):
        """HERest -K on a FULLC set writes a MLLRMEAN TMF recovering the
        speaker shift; HVite -J decodes the shifted data with it."""
        from htk_jax.algo.adapt import load_tmf
        from htk_jax.io.htkfeat import write_htk_file
        from htk_jax.io.parmkind import str2parmkind
        from htk_jax.tools import herest, hvite

        monkeypatch.chdir(tmp_path)
        shift = np.array([1.5, -1.0, 0.8], np.float32)
        self._fullc_decode_setup(shift)
        with open("phones.mlf", "w") as f:
            f.write("#!MLF!#\n")
            for i in range(4):
                seq = ["sil", "aa", "iy", "sil"] if i % 2 == 0 else \
                    ["sil", "iy", "aa", "sil"]
                feats = emit_frames(seq, seed=20 + i) + shift
                write_htk_file(f"a{i}.usr", feats.astype(np.float32),
                               100000, str2parmkind("USER"))
                f.write(f'"*/a{i}.lab"\n' + "\n".join(seq) + "\n.\n")
        open("adapt.scp", "w").write("\n".join(f"a{i}.usr"
                                               for i in range(4)))
        assert herest.run(["-C", "cfg", "-I", "phones.mlf", "-H", "hmmdefs",
                           "-K", "xf", "-S", "adapt.scp", "list"]) == 0
        name, xf = load_tmf("xf/global.tmf")
        assert xf.kind == "MLLRMEAN"
        # the transform must move every mean by ~the speaker shift (A/b
        # individually are unidentifiable here: _diag_set means are
        # constant across dims, and that functional is what decode uses)
        comp = compile_hmmset(load_mmf("hmmdefs"))
        np.testing.assert_allclose(xf.apply_to_means(comp.means),
                                   comp.means + shift, atol=0.5)

        assert hvite.run(["-C", "cfg", "-w", "wdnet.slf", "-J", "xf",
                          "-i", "rec.mlf", "-H", "hmmdefs",
                          "dict", "list", "test.usr"]) == 0
        assert self._rec_words("rec.mlf") == ["A", "I", "A"]

    def test_hvite_identity_cmllr_keeps_fullc_scorer(self, tmp_path,
                                                     monkeypatch, capsys):
        """Regression: a feature-space CMLLR chain on a natively-FULLC
        set must NOT drop the full-covariance scorer (it used to clear
        fc_proj and decode against the placeholder diagonal variances).
        An identity CMLLR must reproduce the unadapted path score."""
        from htk_jax.algo.adapt import Transform, save_tmf
        from htk_jax.tools import hvite

        monkeypatch.chdir(tmp_path)
        self._fullc_decode_setup(shift=0.0)
        import os
        os.makedirs("xfc", exist_ok=True)
        save_tmf("xfc/global.tmf", "global",
                 Transform(kind="CMLLR", A=np.eye(DIM), b=np.zeros(DIM)))

        def score_of(args):
            assert hvite.run(args) == 0
            line = [l for l in capsys.readouterr().out.splitlines()
                    if "test" in l and "[" in l][-1]
            return float(line.rsplit("[", 1)[1].rstrip("]"))

        s0 = score_of(["-C", "cfg", "-T", "1", "-w", "wdnet.slf",
                       "-i", "rec0.mlf", "-H", "hmmdefs",
                       "dict", "list", "test.usr"])
        s1 = score_of(["-C", "cfg", "-T", "1", "-w", "wdnet.slf",
                       "-J", "xfc", "-i", "rec1.mlf", "-H", "hmmdefs",
                       "dict", "list", "test.usr"])
        assert self._rec_words("rec0.mlf") == \
            self._rec_words("rec1.mlf") == ["A", "I", "A"]
        assert s1 == pytest.approx(s0, abs=0.02)

    def test_hvite_rejects_mllrcov_on_fullc(self, tmp_path, monkeypatch):
        from htk_jax.algo.adapt import Transform, save_tmf
        from htk_jax.tools import hvite

        monkeypatch.chdir(tmp_path)
        self._fullc_decode_setup(shift=0.0)
        import os
        os.makedirs("xm", exist_ok=True)
        save_tmf("xm/global.tmf", "global",
                 Transform(kind="MLLRCOV", A=np.eye(DIM) * 1.1,
                           b=np.zeros(DIM)))
        with pytest.raises(HTKError):
            hvite.run(["-C", "cfg", "-w", "wdnet.slf", "-J", "xm",
                       "-i", "r.mlf", "-H", "hmmdefs",
                       "dict", "list", "test.usr"])
