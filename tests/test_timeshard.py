"""Time-sharded FB (parallel/timeshard) vs the serial scans (SURVEY §5.7).

Runs on the 8-device virtual CPU mesh from conftest; the sharded α/β/ξ
must match algo/fb's serial forward/backward/xi scans to f32
re-association tolerance, for both an 8-way and a 2-way time split.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from htk_jax.algo.composite import build_composite
from htk_jax.algo.fb import backward_scan, forward_scan, xi_scan
from htk_jax.parallel.timeshard import fb_time_sharded
from htk_jax.utils.logmath import ladd_reduce

from test_fb import small_set


def _chain(seq=("a", "b", "a", "b")):
    comp = small_set(nmix=2, dim=3, nstates=5)
    ids = [comp.model_id(p) for p in seq]
    return comp, build_composite(comp, ids)


def _outp(hmm, T, seed=0):
    rng = np.random.default_rng(seed)
    Q = hmm.n_states
    # plausible log-likelihood magnitudes
    return (-5.0 - 3.0 * rng.random((T, Q))).astype(np.float32)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_matches_serial(n_dev):
    comp, hmm = _chain()
    T = 64
    outp = _outp(hmm, T)
    logA = np.asarray(hmm.logA, np.float32)
    a0 = np.asarray(hmm.a0, np.float32)
    aE = np.asarray(hmm.aE, np.float32)

    alphas_s = np.asarray(forward_scan(outp, logA, a0, T))
    betas_s = np.asarray(backward_scan(outp, logA, aE, T))
    logp_s = float(ladd_reduce(alphas_s[0] + betas_s[0], axis=0))
    xi_s = np.asarray(xi_scan(alphas_s, betas_s, outp, logA, logp_s, T))

    devs = np.array(jax.devices()[:n_dev]).reshape(n_dev)
    mesh = Mesh(devs, ("t",))
    alphas, betas, logp, xi = fb_time_sharded(outp, logA, a0, aE, mesh)

    # log-domain values live on wildly different scales; compare where
    # probability mass is non-negligible
    live = alphas_s > -1e9
    np.testing.assert_allclose(np.asarray(alphas)[live], alphas_s[live],
                               atol=2e-3, rtol=1e-5)
    live_b = betas_s > -1e9
    np.testing.assert_allclose(np.asarray(betas)[live_b], betas_s[live_b],
                               atol=2e-3, rtol=1e-5)
    assert float(logp) == pytest.approx(logp_s, abs=2e-3)
    # ξ entries are expectation counts up to O(T); re-association of the
    # f32 logP and β differences scale them by ~1e-4 relative
    np.testing.assert_allclose(np.asarray(xi), xi_s, atol=5e-3, rtol=5e-4)


def test_posteriors_normalise():
    comp, hmm = _chain(("a", "b"))
    T = 32
    outp = _outp(hmm, T, seed=3)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("t",))
    alphas, betas, logp, _xi = fb_time_sharded(
        outp, np.asarray(hmm.logA, np.float32),
        np.asarray(hmm.a0, np.float32), np.asarray(hmm.aE, np.float32),
        mesh)
    gamma = np.exp(np.asarray(alphas) + np.asarray(betas) - float(logp))
    np.testing.assert_allclose(gamma.sum(axis=1), 1.0, atol=1e-4)


def test_2d_dp_x_t_batch_matches_serial():
    """fb_time_sharded_batch on a (dp=2, t=4) mesh: every utterance in
    the dp-sharded batch must match the serial scans like the 1D form."""
    from htk_jax.parallel.timeshard import fb_time_sharded_batch

    comp, hmm = _chain()
    T, B = 32, 4
    logA = np.asarray(hmm.logA, np.float32)
    a0 = np.asarray(hmm.a0, np.float32)
    aE = np.asarray(hmm.aE, np.float32)
    outp = np.stack([_outp(hmm, T, seed=10 + b) for b in range(B)])

    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("d", "t"))
    alphas, betas, logp, xi = fb_time_sharded_batch(
        outp, logA, a0, aE, mesh)
    assert alphas.shape == (B, T, hmm.n_states)
    assert logp.shape == (B,) and xi.shape[0] == B

    for b in range(B):
        alphas_s = np.asarray(forward_scan(outp[b], logA, a0, T))
        betas_s = np.asarray(backward_scan(outp[b], logA, aE, T))
        logp_s = float(ladd_reduce(alphas_s[0] + betas_s[0], axis=0))
        xi_s = np.asarray(
            xi_scan(alphas_s, betas_s, outp[b], logA, logp_s, T))
        live = alphas_s > -1e9
        np.testing.assert_allclose(np.asarray(alphas[b])[live],
                                   alphas_s[live], atol=2e-3, rtol=1e-5)
        assert float(logp[b]) == pytest.approx(logp_s, abs=2e-3)
        np.testing.assert_allclose(np.asarray(xi[b]), xi_s,
                                   atol=5e-3, rtol=5e-4)
