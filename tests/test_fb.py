"""Baum-Welch correctness: device scans vs f64 numpy reference, EM property."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from htk_jax.algo.composite import build_composite
from htk_jax.algo.fb import fb_utterance, fb_batch, zero_accs
from htk_jax.algo.reestimate import UpdateFlags, reestimate
from htk_jax.algo.trainer import Trainer, UttData, pad_batch, prepare_utterance
from htk_jax.io.mmf import load_mmf
from htk_jax.models.hmmset import compile_hmmset, write_back
from htk_jax.models.proto import clone_proto, make_proto
from htk_jax.utils.logmath import LZERO


def logsumexp(a, axis=None):
    a = np.asarray(a, np.float64)
    hi = np.max(a, axis=axis, keepdims=True)
    hi = np.where(np.isfinite(hi), hi, 0.0)
    out = hi + np.log(np.sum(np.exp(a - hi), axis=axis, keepdims=True))
    out = np.squeeze(out, axis=axis) if axis is not None else out.reshape(())
    return np.where(np.isfinite(out), out, -np.inf)


def numpy_fb_reference(feats, comp, comp_set):
    """Float64 textbook forward-backward on the composite HMM."""
    T = feats.shape[0]
    Q = comp.n_states
    logA = np.where(comp.logA <= LZERO / 2, -np.inf, comp.logA.astype(np.float64))
    a0 = np.where(comp.a0 <= LZERO / 2, -np.inf, comp.a0.astype(np.float64))
    aE = np.where(comp.aE <= LZERO / 2, -np.inf, comp.aE.astype(np.float64))

    # state outp via naive per-mixture evaluation
    outp = np.zeros((T, Q))
    mixw = {}
    for t in range(T):
        for q in range(Q):
            s = comp.comp_state[q]
            terms = []
            for j in range(comp_set.max_mix):
                m = comp_set.state_mix[s, j]
                if m < 0:
                    continue
                mean = comp_set.means[m].astype(np.float64)
                var = comp_set.variances[m].astype(np.float64)
                g = comp_set.gconsts[m]
                lp = -0.5 * (g + np.sum((feats[t] - mean) ** 2 / var))
                terms.append(comp_set.state_logw[s, j] + lp)
            outp[t, q] = logsumexp(np.array(terms))

    alpha = np.full((T, Q), -np.inf)
    alpha[0] = a0 + outp[0]
    for t in range(1, T):
        for j in range(Q):
            alpha[t, j] = logsumexp(alpha[t - 1] + logA[:, j]) + outp[t, j]
    beta = np.full((T, Q), -np.inf)
    beta[T - 1] = aE
    for t in range(T - 2, -1, -1):
        for i in range(Q):
            beta[t, i] = logsumexp(logA[i] + outp[t + 1] + beta[t + 1])
    logp = logsumexp(alpha[T - 1] + aE)
    gamma = np.exp(alpha + beta - logp)
    xi = np.zeros((Q, Q))
    for t in range(T - 1):
        xi += np.exp(
            alpha[t][:, None] + logA + (outp[t + 1] + beta[t + 1])[None, :] - logp
        )
    return logp, gamma, xi, outp


def small_set(nmix=1, seed=0, dim=3, nstates=4):
    hs = make_proto(nstates=nstates, dim=dim, parm_kind="USER", nmix=nmix)
    cl = clone_proto(hs, "proto", ["a", "b"])
    rng = np.random.default_rng(seed)
    for h in cl.hmms.values():
        for si in h.states:
            for k, mp in enumerate(si.streams[0].mixes):
                mp.mean = rng.normal(size=dim).astype(np.float32) * 2
                mp.var = (0.5 + rng.random(dim)).astype(np.float32)
                mp.fix_gconst()
            if nmix > 1:
                w = rng.random(nmix) + 0.2
                si.streams[0].weights = list(w / w.sum())
    return compile_hmmset(cl)


def run_device_fb(comp_set, utt):
    tr = Trainer(comp_set)
    arrs = pad_batch([utt], comp_set.n_states)
    params = tr.params()
    logps, accs = tr._step_fn()(params, {k: jnp.asarray(v) for k, v in arrs.items()})
    return float(logps[0]), accs


class TestFBParity:
    @pytest.mark.parametrize("nmix", [1, 3])
    def test_logp_and_occ_match_reference(self, nmix):
        comp_set = small_set(nmix=nmix)
        rng = np.random.default_rng(1)
        T = 24
        feats = rng.normal(size=(T, 3)).astype(np.float32)
        utt = prepare_utterance(comp_set, "u0", feats, ["a", "b", "a"])
        logp_ref, gamma_ref, xi_ref, outp_ref = numpy_fb_reference(
            feats.astype(np.float64), utt.hmm, comp_set
        )
        logp, accs = run_device_fb(comp_set, utt)
        assert logp == pytest.approx(logp_ref, abs=2e-2, rel=1e-4)

        # state occupancies: sum gamma over time per physical state
        Q = utt.hmm.n_states
        occ_ref = np.zeros(comp_set.n_states)
        for q in range(Q):
            occ_ref[utt.hmm.comp_state[q]] += gamma_ref[:, q].sum()
        occ_got = np.asarray(accs.wt_occ).sum(axis=1)
        np.testing.assert_allclose(occ_got, occ_ref, rtol=2e-3, atol=2e-3)

        # mean accumulators
        sum_x_ref = np.zeros((comp_set.n_mix, 3))
        if nmix == 1:
            for q in range(Q):
                s = utt.hmm.comp_state[q]
                m = comp_set.state_mix[s, 0]
                sum_x_ref[m] += gamma_ref[:, q] @ feats.astype(np.float64)
            np.testing.assert_allclose(
                np.asarray(accs.sum_x), sum_x_ref, rtol=2e-3, atol=2e-3
            )

        # frame occupancy conservation: sum_q gamma_t = 1 for every t
        np.testing.assert_allclose(gamma_ref.sum(axis=1), 1.0, rtol=1e-8)

    def test_transition_accs_match_reference(self):
        comp_set = small_set(nmix=1)
        rng = np.random.default_rng(2)
        T = 16
        feats = rng.normal(size=(T, 3)).astype(np.float32)
        utt = prepare_utterance(comp_set, "u0", feats, ["a", "b"])
        logp_ref, gamma_ref, xi_ref, _ = numpy_fb_reference(
            feats.astype(np.float64), utt.hmm, comp_set
        )
        _, accs = run_device_fb(comp_set, utt)
        tn, nmax = comp_set.log_transp.shape[0], comp_set.nmax
        tr = np.asarray(accs.tr).reshape(tn, nmax, nmax)

        # model 'a' occupies composite states 0,1; within-block xi -> transP a
        tid_a = comp_set.model_transp[comp_set.model_id("a")]
        np.testing.assert_allclose(
            tr[tid_a, 1:3, 1:3], xi_ref[0:2, 0:2], rtol=2e-3, atol=2e-3
        )
        # entry of model a = gamma_0 of its states (reached only at t=0)
        np.testing.assert_allclose(
            tr[tid_a, 0, 1:3], gamma_ref[0, 0:2], rtol=2e-3, atol=2e-3
        )
        # cross transition a->b goes to a's exit column
        np.testing.assert_allclose(
            tr[tid_a, 1:3, 3], xi_ref[0:2, 2:4].sum(axis=1), rtol=2e-3, atol=2e-3
        )
        # row-occupancy consistency: sum_j TrAcc[i,j] == sum_t gamma[i]
        for li, q in [(0, 0), (1, 1)]:
            assert tr[tid_a, 1 + li].sum() == pytest.approx(
                gamma_ref[:, q].sum(), rel=3e-3, abs=3e-3
            )

    def test_padding_invariance(self):
        """Same utterance in different pad shapes -> identical accs."""
        comp_set = small_set(nmix=2)
        rng = np.random.default_rng(3)
        feats = rng.normal(size=(20, 3)).astype(np.float32)
        u = prepare_utterance(comp_set, "u", feats, ["a", "b"])
        logp1, accs1 = run_device_fb(comp_set, u)
        # batch it with a longer utterance to force bigger padding
        feats2 = rng.normal(size=(70, 3)).astype(np.float32)
        u2 = prepare_utterance(comp_set, "u2", feats2, ["b", "a", "b", "a", "b"])
        tr = Trainer(comp_set)
        arrs = pad_batch([u, u2], comp_set.n_states)
        logps, _ = tr._step_fn()(tr.params(), {k: jnp.asarray(v) for k, v in arrs.items()})
        assert float(logps[0]) == pytest.approx(logp1, rel=1e-5, abs=1e-2)

    def test_tee_model_skip(self):
        """A tee 'sp' between words allows skipping (logP finite both ways)."""
        hs = make_proto(nstates=5, dim=3, parm_kind="USER")
        cl = clone_proto(hs, "proto", ["a", "b"])
        # build a 3-state tee model: entry->exit prob 0.4
        sp = clone_proto(hs, "proto", ["sp"]).hmms["sp"]
        sp.nstates = 3
        sp.states = sp.states[:1]
        tp = np.zeros((3, 3), np.float32)
        tp[0, 1] = 0.6
        tp[0, 2] = 0.4
        tp[1, 1] = 0.5
        tp[1, 2] = 0.5
        sp.transp = tp
        cl.hmms["sp"] = sp
        cl.macros["h"]["sp"] = sp
        comp_set = compile_hmmset(cl)
        rng = np.random.default_rng(4)
        feats = rng.normal(size=(18, 3)).astype(np.float32)
        utt = prepare_utterance(comp_set, "u", feats, ["a", "sp", "b"])
        # composite: a=0..2, sp=3, b=4..6; skip link a.last -> b.first
        A = utt.hmm.logA
        assert utt.hmm.n_states == 7
        assert A[2, 4] > LZERO / 2
        logp_ref, *_ = numpy_fb_reference(feats.astype(np.float64), utt.hmm, comp_set)
        logp, _ = run_device_fb(comp_set, utt)
        assert logp == pytest.approx(logp_ref, abs=2e-2, rel=1e-4)


class TestEM:
    def test_em_monotonic(self):
        """Total logP increases across reestimation iterations (EM invariant)."""
        comp_set = small_set(nmix=2, seed=5)
        rng = np.random.default_rng(6)
        utts = []
        for i in range(6):
            T = int(rng.integers(15, 40))
            feats = (rng.normal(size=(T, 3)) + rng.normal(size=3)).astype(np.float32)
            seq = ["a", "b"] if i % 2 else ["b", "a", "b"]
            utts.append(prepare_utterance(comp_set, f"u{i}", feats, seq))

        logps = []
        for it in range(4):
            tr = Trainer(comp_set)
            accs = tr.accumulate(utts, batch_size=4)
            logps.append(float(accs.total_logp))
            m, v, w, t = reestimate(comp_set, accs, UpdateFlags.parse("tmvw"),
                                    min_var=1e-4)
            write_back(comp_set, means=m, variances=v, weights=w, transps=t)
            # rebuild composites with updated transition matrices
            utts = [
                prepare_utterance(comp_set, u.name, u.feats,
                                  [comp_set.names[i] for i in u.hmm.model_ids])
                for u in utts
            ]
        diffs = np.diff(logps)
        assert np.all(diffs > -1e-2), logps
        assert logps[-1] > logps[0]

class TestBeamPruning:
    """HERest -t: beta-beam FB pruning (HFB.c pruneSetting semantics)."""

    def _utt(self, comp_set):
        rng = np.random.default_rng(1)
        feats = rng.normal(size=(24, 3)).astype(np.float32)
        return prepare_utterance(comp_set, "u0", feats, ["a", "b", "a"])

    def _run(self, comp_set, utt, prune):
        tr = Trainer(comp_set, prune=prune)
        arrs = pad_batch([utt], comp_set.n_states)
        jb = {k: jnp.asarray(v) for k, v in arrs.items()}
        step, params = tr._step_fn(), tr.params()
        if prune is None:
            lp, accs = step(params, jb)
        else:
            lp, accs = step(params, jb, jnp.float32(prune[0]))
        return float(lp[0]), accs

    def test_wide_beam_bit_exact(self):
        comp_set = small_set(nmix=1)
        utt = self._utt(comp_set)
        lp0, a0 = self._run(comp_set, utt, None)
        lp1, a1 = self._run(comp_set, utt, (1e6, 0.0, 1e6))
        assert lp1 == lp0
        for x, y in zip(jax.tree.leaves(a0), jax.tree.leaves(a1)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    def test_tight_beam_binds_and_occupancy_stays_normalised(self):
        comp_set = small_set(nmix=1)
        utt = self._utt(comp_set)
        lp0, a0 = self._run(comp_set, utt, None)
        lp, accs = self._run(comp_set, utt, (1.0, 0.0, 1.0))
        # pruning drops mass: logP strictly below exact but a path survives
        assert lp < lp0 and lp > -1e9
        # per-frame occupancy still sums to one over the surviving band
        assert float(np.asarray(accs.occ).sum()) == pytest.approx(24.0, abs=1e-3)
        assert not np.allclose(np.asarray(accs.occ), np.asarray(a0.occ))

    def test_hopeless_beam_fails_utterance(self):
        # measured: beam 5.0 leaves no alpha-reachable band on this
        # fixture (band-relative pruning is non-monotone at tiny beams)
        comp_set = small_set(nmix=1)
        utt = self._utt(comp_set)
        lp, accs = self._run(comp_set, utt, (5.0, 0.0, 5.0))
        assert lp <= -1e9
        assert float(np.asarray(accs.occ).sum()) == 0.0  # zero contribution

    def test_retry_ladder_recovers(self, capsys):
        # accumulate() escalates 5.0 -> 10.0, where the utterance passes
        comp_set = small_set(nmix=1)
        utt = self._utt(comp_set)
        tr = Trainer(comp_set, prune=(5.0, 5.0, 20.0))
        accs = tr.accumulate([utt], batch_size=2, trace=1)
        out = capsys.readouterr()
        assert "retrying 1 utterance(s) at beam 10.0" in out.out
        assert float(np.asarray(accs.n_utts)) == 1.0
        lp0, _ = self._run(comp_set, utt, None)
        assert float(np.asarray(accs.total_logp)) == pytest.approx(
            lp0, abs=0.5)

    def test_retry_ladder_exhausts_and_skips(self, capsys):
        comp_set = small_set(nmix=1)
        utt = self._utt(comp_set)
        tr = Trainer(comp_set, prune=(5.0, 0.0, 5.0))  # no increment
        accs = tr.accumulate([utt], batch_size=2)
        err = capsys.readouterr().err
        assert "7323" in err and "7324" in err
        assert float(np.asarray(accs.n_utts)) == 0.0
