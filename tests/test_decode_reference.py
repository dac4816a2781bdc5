"""The decode recursions against plain float64 numpy references.

decode_scan (general networks) is checked against a per-frame token-
passing loop, and the exact explicit-bigram cross-word leg of the LV
decoder (decode.bucket_leg over lvnet's in-degree buckets) against a
per-bigram max.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from htk_jax.algo.decode import bucket_leg, decode_scan
from htk_jax.algo.lvnet import _factored_rows
from htk_jax.io.lm import NGramLM
from htk_jax.utils.logmath import LSMALL, LZERO


def random_net(seed=0, Ns=30, Nn=5, K=3, B=2, T=20):
    rng = np.random.default_rng(seed)
    node_of_state = np.sort(rng.integers(0, Nn, Ns)).astype(np.int32)
    outp = (rng.normal(size=(B, T, Ns)) * 2).astype(np.float32)
    band = np.where(
        rng.random((K, Ns)) < 0.7, -rng.random((K, Ns)), LZERO
    ).astype(np.float32)
    band[0] = -0.5
    a0 = np.where(rng.random(Ns) < 0.3, 0.0, LZERO).astype(np.float32)
    aE = np.where(rng.random(Ns) < 0.3, -0.2, LZERO).astype(np.float32)
    bonus = np.zeros(Ns, np.float32)
    trans = np.where(
        rng.random((Nn, Nn)) < 0.5, -rng.random((Nn, Nn)), LZERO
    ).astype(np.float32)
    start = np.where(rng.random(Nn) < 0.5, 0.0, LZERO).astype(np.float32)
    for n in range(Nn):
        sel = np.where(node_of_state == n)[0]
        a0[sel[0]] = 0.0
        aE[sel[-1]] = -0.1
    return node_of_state, outp, band, a0, aE, bonus, trans, start


def token_passing_f64(outp, band, a0, aE, nos, bonus, trans, start, wp):
    """One utterance, float64, one state and one node at a time."""
    T, Ns = outp.shape
    K, Nn = band.shape[0], trans.shape[0]
    v = np.full(Ns, LZERO)
    wn = np.full(Ns, -1)
    wt = np.full(Ns, -1)
    WEs, pwns, pwts = [], [], []
    for t in range(T):
        WE = np.full(Nn, LZERO)
        best = np.full(Nn, -1)
        for n in range(Nn):
            for s in np.flatnonzero(nos == n):  # first state on ties
                if best[n] < 0 or v[s] + aE[s] > WE[n]:
                    WE[n], best[n] = v[s] + aE[s], s
        ok = WE > LSMALL
        WEs.append(WE)
        pwns.append(np.where(ok, wn[best], -1))
        pwts.append(np.where(ok, wt[best], -1))
        entry = np.full(Nn, -np.inf)
        an = np.full(Nn, -1)
        for j in range(Nn):
            for i in range(Nn):  # first source on ties
                if WE[i] + trans[i, j] > entry[j]:
                    entry[j], an[j] = WE[i] + trans[i, j], i
        entry = entry + wp
        if t == 0:
            entry, an = start.astype(np.float64), np.full(Nn, -1)
        nv = np.empty(Ns)
        nwn = np.empty(Ns, int)
        nwt = np.empty(Ns, int)
        for s in range(Ns):
            within, src = -np.inf, s
            for k in range(K):  # first shift on ties
                prev = v[s - k] if s >= k else LZERO
                if prev + band[k, s] > within:
                    within, src = prev + band[k, s], s - k
            e = entry[nos[s]] + a0[s] + bonus[s]
            if e > within:
                nv[s], nwn[s], nwt[s] = e, an[nos[s]], t - 1
            else:
                nv[s] = within
                nwn[s] = wn[src] if src >= 0 else -1
                nwt[s] = wt[src] if src >= 0 else -1
            nv[s] += outp[t, s]
            if nv[s] <= LSMALL:
                nwn[s] = nwt[s] = -1
        v, wn, wt = nv, nwn, nwt
    return (v, wn, wt), (np.array(WEs), np.array(pwns), np.array(pwts))


@pytest.mark.parametrize("seed,shape", [
    (0, {}),
    (1, {}),
    (2, dict(Ns=80, Nn=9, T=16)),
    (3, dict(Ns=24, Nn=6, K=2, B=3, T=9)),
])
def test_decode_scan_matches_float64_reference(seed, shape):
    nos, outp, band, a0, aE, bonus, trans, start = random_net(seed, **shape)
    Nn = trans.shape[0]
    wp = np.full(Nn, -1.0, np.float32)
    got = jax.vmap(lambda o: decode_scan(
        o, jnp.asarray(band), jnp.asarray(a0), jnp.asarray(aE),
        jnp.asarray(nos), jnp.asarray(bonus), jnp.asarray(trans),
        jnp.asarray(start), jnp.asarray(wp), Nn))(jnp.asarray(outp))
    (vg, wng, wtg), (WEg, pwng, pwtg) = jax.tree.map(np.asarray, got)
    for b in range(outp.shape[0]):
        (v, wn, wt), (WE, pwn, pwt) = token_passing_f64(
            outp[b].astype(np.float64), band, a0, aE, nos, bonus, trans,
            start, wp)
        live = v > LSMALL
        np.testing.assert_allclose(vg[b][live], v[live], rtol=1e-5,
                                   atol=1e-4)
        assert np.all(vg[b][~live] <= LSMALL)
        np.testing.assert_array_equal(wng[b], wn)
        np.testing.assert_array_equal(wtg[b], wt)
        liveWE = WE > LSMALL
        np.testing.assert_allclose(WEg[b][liveWE], WE[liveWE], rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_array_equal(pwng[b], pwn)
        np.testing.assert_array_equal(pwtg[b], pwt)


def _bigram_graph(C, N, seed):
    """A C-word LM whose explicit bigrams are N random (unique) pairs."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(C)]
    lm = NGramLM(order=2)
    for w in words:
        lm.unigrams[w] = (-5.0, -1.0)
    src, tgt = rng.integers(0, C, N), rng.integers(0, C, N)
    _u, idx = np.unique(src * C + tgt, return_index=True)
    src, tgt = src[np.sort(idx)], tgt[np.sort(idx)]
    p = (rng.normal(size=len(src)) * 2.0).astype(np.float32)
    for a, b, q in zip(src, tgt, p):
        lm.bigrams[(words[a], words[b])] = (float(q), 0.0)
    return words, lm, src, tgt, p


def _buckets(words, lm, scale):
    x = _factored_rows(words, lm, np.arange(len(words)), None, None)
    return ([(jnp.asarray(pr), jnp.asarray(sc) * np.float32(scale))
             for pr, sc in x["buckets"]], jnp.asarray(x["inv"]))


@pytest.mark.parametrize("C,N,B", [(40, 200, 2), (300, 3000, 3),
                                   (513, 9000, 2)])
def test_bucket_leg_matches_float64_reference(C, N, B):
    words, lm, src, tgt, p = _bigram_graph(C, N, C + N)
    scale = 3.0
    WE = (np.random.default_rng(C).normal(size=(B, C)) * 10.0
          ).astype(np.float32)
    buckets, inv = _buckets(words, lm, scale)
    ev, ea = jax.jit(bucket_leg)(jnp.asarray(WE), buckets, inv)
    ev, ea = np.asarray(ev, np.float64), np.asarray(ea)
    ref = np.full((B, C), -np.inf)
    cand = WE[:, src].astype(np.float64) + p.astype(np.float64) * scale
    for b in range(B):
        np.maximum.at(ref[b], tgt, cand[b])
    has = np.isfinite(ref)
    np.testing.assert_allclose(ev[has], ref[has], rtol=1e-6, atol=1e-4)
    # the winning source scores the target's max
    win = WE[np.arange(B)[:, None], ea].astype(np.float64)
    assert np.all(ev[~has] <= LSMALL)
    for b in range(B):
        for j in np.flatnonzero(has[b]):
            k = np.flatnonzero((tgt == j) & (src == ea[b, j]))
            assert len(k) == 1
            assert win[b, j] + p[k[0]] * scale == pytest.approx(
                ref[b, j], abs=1e-4)


def test_bucket_leg_exact_f32_first_slot_ties():
    """With the candidates computed in the same f32 arithmetic, values
    are bit-identical and ties go to the first bigram in LM order."""
    C, N, B = 257, 4000, 2
    words, lm, src, tgt, p = _bigram_graph(C, N, 7)
    scale = np.float32(2.0)
    WE = (np.random.default_rng(7).normal(size=(B, C)) * 10.0
          ).astype(np.float32)
    WE[:, 1] = WE[:, 0]  # duplicate sources: exact ties
    buckets, inv = _buckets(words, lm, scale)
    ev, ea = jax.jit(bucket_leg)(jnp.asarray(WE), buckets, inv)
    p32 = p * scale
    v = np.full((B, C), 2.0 * np.float32(LZERO), np.float32)
    a = np.full((B, C), -1, np.int64)
    for k in np.argsort(tgt, kind="stable"):
        cand = WE[:, src[k]] + p32[k]
        for b in range(B):
            if cand[b] > v[b, tgt[k]]:
                v[b, tgt[k]] = cand[b]
                a[b, tgt[k]] = src[k]
    has = a >= 0
    np.testing.assert_array_equal(np.asarray(ev)[has], v[has])
    np.testing.assert_array_equal(np.asarray(ea)[has], a[has])
