"""PLP / LPC frontend tests against scalar float64 references."""

import math

import numpy as np
import pytest

from htk_jax.io import parmkind as pk
from htk_jax.ops import dsp
from htk_jax.ops.dsp import FrontendConfig, compute_features

from test_frontend import synth_wave


def durbin_ref(r, p):
    """Scalar Levinson-Durbin."""
    E = r[0]
    a = np.zeros(p + 1)
    for i in range(1, p + 1):
        acc = r[i] - sum(a[j] * r[i - j] for j in range(1, i))
        k = acc / E
        new_a = a.copy()
        new_a[i] = k
        for j in range(1, i):
            new_a[j] = a[j] - k * a[i - j]
        a = new_a
        E *= 1.0 - k * k
    return a[1:], E


def lpc2cep_ref(a, n_ceps):
    p = len(a)
    c = np.zeros(n_ceps + 1)
    for n in range(1, n_ceps + 1):
        acc = a[n - 1] if n <= p else 0.0
        for i in range(1, min(n, p + 1)):
            acc += ((n - i) / n) * a[i - 1] * c[n - i]
        c[n] = -acc
    return c[1:]


class TestDurbin:
    def test_matches_scalar(self):
        rng = np.random.default_rng(0)
        # autocorrelation of a real AR signal (positive definite)
        sig = rng.normal(size=1000)
        for i in range(1, 1000):
            sig[i] += 0.6 * sig[i - 1]
        r = np.array([np.dot(sig[: 1000 - k], sig[k:]) for k in range(13)])
        a_ref, e_ref = durbin_ref(r, 12)
        import jax.numpy as jnp

        a_got, e_got = dsp._durbin(jnp.asarray(r[None, :], jnp.float32), 12)
        np.testing.assert_allclose(np.asarray(a_got[0]), a_ref, atol=1e-3)
        assert float(e_got[0]) == pytest.approx(e_ref, rel=1e-3)
        # first reflection coefficient ~ 0.6 (AR coefficient)
        assert a_ref[0] == pytest.approx(0.6, abs=0.1)

    def test_lpc2cep_matches(self):
        a = np.array([0.5, -0.2, 0.1])
        import jax.numpy as jnp

        got = dsp._lpc_to_cepstra(jnp.asarray(a[None, :], jnp.float32), 6,
                                  jnp.ones(1))
        want = lpc2cep_ref(a, 6)
        np.testing.assert_allclose(np.asarray(got[0]), want, atol=1e-5)


class TestPLP:
    @pytest.mark.parametrize("kind", ["PLP_E_D_A", "PLP_0", "LPCEPSTRA_E",
                                      "LPC"])
    def test_shapes_and_finite(self, kind):
        cfg = FrontendConfig(target_kind=pk.str2parmkind(kind))
        w = synth_wave()
        feats = compute_features(w, cfg)
        assert feats.shape[1] == cfg.width()
        assert np.all(np.isfinite(feats))

    def test_plp_distinguishes_spectra(self):
        """Different spectral content -> clearly different PLP vectors."""
        cfg = FrontendConfig(target_kind=pk.str2parmkind("PLP"))
        t = np.arange(4000) / 16000.0
        w1 = (3000 * np.sin(2 * math.pi * 400 * t)).astype(np.float32)
        w2 = (3000 * np.sin(2 * math.pi * 2500 * t)).astype(np.float32)
        f1 = compute_features(w1, cfg).mean(axis=0)
        f2 = compute_features(w2, cfg).mean(axis=0)
        assert np.abs(f1 - f2).max() > 0.5

    def test_equal_loudness_shape(self):
        cfg = FrontendConfig()
        eql = dsp.equal_loudness(cfg)
        assert eql.shape == (cfg.num_chans,)
        # equal loudness rises from low freq then falls at very high freq;
        # mid channels dominate the lowest channel
        assert eql[len(eql) // 2] > eql[0]
