"""Where does the LV decode scan's time per frame go? (Is the per-frame
op chain's DEPTH, not its width, what sets the rate?)

Times jitted 128-frame scans whose bodies are successive subsets of
the real top-A factored step at 5k-vocab shapes:

  we_only      — word-end extraction (max/argmax over S + record unpack)
  we_topk      — + jax.lax.top_k(WE, A)
  we_topk_bo   — + back-off leg (bow/uni broadcast max)
  we_topk_ex   — + explicit leg (succ row gather + scatter-max + argmax
                  reconstruction)
  full         — the production step via decode_scan_uniform_batch
                 (adds within-word band, entry combine, beam prune)

Usage: python benchmarks/decode_step_ablation.py [A] [B]
Prints one JSON line of ms/frame per variant.
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(A=128, B=8, T=128):
    from bench import build_tied_triphone_system

    import jax
    import jax.numpy as jnp

    from htk_jax.algo.decode import LZERO, REC_TBITS, REC_TMASK
    from htk_jax.algo.lvnet import compile_lv_loop

    comp, vocab, words, lm = build_tied_triphone_system(5000, n_tied=2000,
                                                        seed=7)
    net = compile_lv_loop(words, vocab, comp, lm=lm, factored=True)
    S = net.uniform_width
    C = net.n_chains
    Ns = C * S
    xw = net.xw_backoff
    aE = jnp.asarray(net.aE, jnp.float32)
    bow = jnp.asarray(xw["bow"], jnp.float32)
    uni = jnp.asarray(xw["uni"], jnp.float32)
    succ_j = jnp.asarray(xw["succ_j"])
    succ_p = jnp.asarray(xw["succ_p"], jnp.float32)
    col = jnp.arange(S, dtype=jnp.int32)[None, None, :]

    rng = np.random.default_rng(0)
    xs = jnp.asarray(rng.normal(size=(T, B, Ns)).astype(np.float32))

    def we_part(v, rec):
        ev = (v + aE[None]).reshape(B, C, S)
        WE = jnp.max(ev, axis=2)
        best_s = jnp.argmax(ev, axis=2)
        onehot = best_s[..., None] == col
        ok = WE > LZERO / 2
        prec = jnp.max(jnp.where(onehot, rec.reshape(B, C, S), 0), axis=2)
        prec = jnp.where(ok, prec, 0)
        pwn = (prec >> REC_TBITS).astype(jnp.int32) - 1
        pwt = (prec & REC_TMASK).astype(jnp.int32) - 1
        return WE, pwn, pwt

    def mk(kind):
        def body(carry, x):
            v, rec = carry
            WE, pwn, pwt = we_part(v, rec)
            upd = x
            if kind != "we_only":
                vals, idxs = jax.lax.top_k(WE, A)
                upd = upd + jnp.max(vals)
            if kind in ("we_topk_bo", "we_topk_ex"):
                bo = WE + bow[None]
                bo_best = jnp.max(bo, axis=1)
                entry = bo_best[:, None] + uni[None]
                if kind == "we_topk_ex":
                    sj = succ_j[idxs]
                    sp = succ_p[idxs]
                    cand = vals[..., None] + sp
                    bidx = jnp.arange(B)[:, None, None]
                    ex = jnp.full((B, C + 1), 2.0 * LZERO, jnp.float32)
                    ex = ex.at[bidx, sj].max(cand,
                                             mode="promise_in_bounds")
                    exg = ex[bidx, sj]
                    src = jnp.broadcast_to(idxs[..., None], cand.shape)
                    win = jnp.where(cand >= exg, src, -1)
                    an = jnp.full((B, C + 1), -1, jnp.int32)
                    an = an.at[bidx, sj].max(win,
                                             mode="promise_in_bounds")
                    entry = jnp.maximum(entry, ex[:, :C])
                    upd = upd + jnp.max(an.astype(jnp.float32)) * 1e-30
                upd = upd + jnp.max(entry) * 1e-30
            nv = jnp.maximum(v * 0.999, upd)
            nr = rec + 1
            return (nv, nr), jnp.max(WE, axis=1)

        init = (jnp.full((B, Ns), LZERO, jnp.float32),
                jnp.zeros((B, Ns), jnp.uint32))

        @jax.jit
        def run(xs):
            (_v, _r), out = jax.lax.scan(body, init, xs)
            return out

        return run

    out = {"A": A, "B": B, "C": int(C), "S": int(S), "T": T}
    for kind in ("we_only", "we_topk", "we_topk_bo", "we_topk_ex"):
        f = mk(kind)
        r = f(xs)
        jax.block_until_ready(r)
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            r = f(xs)
            jax.block_until_ready(r)
            ts.append(time.perf_counter() - t0)
        out[kind + "_ms_per_frame"] = round(
            statistics.median(ts) / T * 1e3, 4)

    # the production pipeline (OutP + scan + traceback compaction) at
    # the same batch/pruning — the number the components must add up to
    from htk_jax.algo.decode import _BEAM_OFF, _lv_pipeline

    pipe = _lv_pipeline(net, comp, "highest", A, False)
    dim = comp.means.shape[1]
    x = jnp.asarray(rng.normal(size=(B, T, dim)).astype(np.float32))
    tr = jnp.asarray([T] * B, jnp.int32)
    args = (jnp.asarray(8.0, jnp.float32), jnp.asarray(-10.0, jnp.float32),
            jnp.asarray(_BEAM_OFF, jnp.float32))
    r = pipe(x, tr, *args)
    jax.block_until_ready(r[0])
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        r = pipe(x, tr, *args)
        jax.block_until_ready(r[0])
        ts.append(time.perf_counter() - t0)
    out["full_pipeline_ms_per_frame"] = round(
        statistics.median(ts) / T * 1e3, 4)
    out["backend"] = __import__("jax").default_backend()
    print(json.dumps(out))


if __name__ == "__main__":
    a = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    b = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    main(a, b)
