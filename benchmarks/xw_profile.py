"""Profile the factored cross-word step's legs at LV scale.

Interleaved A/B: full factored decode vs back-off-only
(explicit buckets emptied) vs OutP-only — the difference isolates the
explicit-bigram gather leg the VERDICT wants off the gather floor.
Run: python benchmarks/xw_profile.py [VOCAB]
"""
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

VOCAB = int(sys.argv[1]) if len(sys.argv) > 1 else 20000


def main():
    import copy

    import jax
    import jax.numpy as jnp

    from bench import build_tied_triphone_system
    from htk_jax.algo.decode import _dev_lens, _dev_scalar, _lv_pipeline
    from htk_jax.algo.lvnet import compile_lv_loop

    comp, vocab, words, lm = build_tied_triphone_system(
        VOCAB, n_tied=2000, seed=11)
    net = compile_lv_loop(words, vocab, comp, lm=lm, factored=True)
    n_exp = sum(p.shape[0] * p.shape[1]
                for p, _s in net.xw_backoff["buckets"])
    print(f"{VOCAB} words, {net.n_chains} rows, {n_exp} explicit slots,"
          f" buckets={[(p.shape) for p, _ in net.xw_backoff['buckets']]}",
          flush=True)

    # back-off-only twin: same rows, no explicit buckets
    net2 = copy.copy(net)
    net2.xw_backoff = dict(net.xw_backoff)
    net2.xw_backoff["buckets"] = []
    net2._dev_cache = None

    B, T = 8, 500
    rng = np.random.default_rng(3)
    dim = comp.means.shape[1]
    x = jnp.asarray(rng.normal(size=(B, T, dim)).astype(np.float32))
    lens = _dev_lens([T] * B)
    s1, s0, sb = _dev_scalar(12.0), _dev_scalar(0.0), _dev_scalar(1e30)

    def run(f):
        return jax.block_until_ready(f(x, lens, s1, s0, sb))

    f_full = _lv_pipeline(net, comp, "highest", None)
    f_bo = _lv_pipeline(net2, comp, "highest", None)
    o_full = run(f_full)
    run(f_bo)
    variants = {}
    for a in (64, 128, 192, 256):
        variants[a] = _lv_pipeline(net, comp, "highest", a)
    eqs = {}
    for a, f in variants.items():
        o = run(f)
        eqs[a] = bool(np.array_equal(np.asarray(o_full[0]),
                                     np.asarray(o[0])))
    tf, tb = [], []
    tv = {a: [] for a in variants}
    for _ in range(5):
        t0 = time.perf_counter(); run(f_full); tf.append(time.perf_counter() - t0)
        t0 = time.perf_counter(); run(f_bo); tb.append(time.perf_counter() - t0)
        for a, f in variants.items():
            t0 = time.perf_counter(); run(f); tv[a].append(time.perf_counter() - t0)
    mf, mb = statistics.median(tf), statistics.median(tb)
    audio = B * T * 0.01
    print(f"full factored: {mf:.3f}s  ({mf / audio:.4f} xRT, "
          f"{mf / T * 1e3:.3f} ms/frame wall)")
    print(f"backoff-only:  {mb:.3f}s  ({mb / audio:.4f} xRT)")
    print(f"explicit leg:  {mf - mb:.3f}s  "
          f"({(mf - mb) / T * 1e3:.3f} ms/frame, "
          f"{100 * (mf - mb) / mf:.0f}% of wall)")
    for a in variants:
        ma = statistics.median(tv[a])
        print(f"topA {a:4d}:     {ma:.3f}s  ({ma / audio:.4f} xRT) "
              f"traceback==exact: {eqs[a]}")


if __name__ == "__main__":
    main()
