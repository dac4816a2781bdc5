"""20k-vocabulary LV decode feasibility (the factored cross-word path).

Above ~8k (word, pron) rows the dense (C, C) cross-word matrix stops
being viable (4·C² bytes = 1.6 GB at 20k), so compile_lv_loop
auto-switches to the ARPA-back-off-factored tables (O(#bigrams) per
frame). This harness proves the claim at 4x the auto-switch threshold:
builds a 20k-word back-off bigram system over 2k tied 8-mix triphone
states, decodes a batch on the current backend, and prints xRT.

Run on the accelerator: python benchmarks/lv20k.py
(~10 s host network build + one compile; sizes shrink with SMOKE=1).
VOCAB=50000 gives 800k network states; uint32 word-link records carry 17
row bits, so up to 131k (word, pron) rows.
"""
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

SMOKE = os.environ.get("SMOKE") == "1"
VOCAB = int(os.environ.get("VOCAB", "20000"))  # try 50000
TOPA = int(os.environ.get("TOPA", "0"))  # >0: top-A histogram pruning
CHECK = os.environ.get("CHECK") == "1"  # compare top-A traceback vs exact


def main():
    import jax

    from bench import build_tied_triphone_system
    from htk_jax.algo.decode import decode_batch
    from htk_jax.algo.lvnet import compile_lv_loop

    V = 2000 if SMOKE else VOCAB
    t0 = time.perf_counter()
    comp, vocab, words, lm = build_tied_triphone_system(
        V, n_tied=(200 if SMOKE else 2000), seed=11)
    print(f"system build: {time.perf_counter() - t0:.1f}s "
          f"({V} words, {comp.means.shape[0]} Gaussians)", flush=True)

    t0 = time.perf_counter()
    # SMOKE shrinks below the auto threshold; force factored there
    net = compile_lv_loop(words, vocab, comp, lm=lm,
                          factored=True if SMOKE else None)
    assert net.xw_backoff is not None, "factored path must auto-enable"
    n_exp = sum(p.shape[0] * p.shape[1]
                for p, _s in net.xw_backoff["buckets"])
    print(f"network compile: {time.perf_counter() - t0:.1f}s "
          f"({net.n_chains} rows, {net.n_states} states, "
          f"{n_exp} padded explicit-bigram slots; NO dense matrix)",
          flush=True)

    B, T = (2, 100) if SMOKE else (8, 500)
    rng = np.random.default_rng(3)
    dim = comp.means.shape[1]
    feats = [rng.normal(size=(T, dim)).astype(np.float32)
             for _ in range(B)]
    audio = B * T * 0.01
    ma = TOPA if TOPA > 0 else None
    out = decode_batch(net, comp, feats, lm_scale=8.0, word_pen=-10.0,
                       max_active=ma)
    assert any(r is not None for r in out)
    if CHECK and ma:
        exact = decode_batch(net, comp, feats, lm_scale=8.0,
                             word_pen=-10.0)
        same = sum(1 for a, b in zip(out, exact)
                   if (a.words if a else None) == (b.words if b else None))
        print(f"top-A={ma} traceback matches exact on {same}/{B} utts",
              flush=True)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        decode_batch(net, comp, feats, lm_scale=8.0, word_pen=-10.0,
                     max_active=ma)
        ts.append(time.perf_counter() - t0)
    xrt = statistics.median(ts) / audio
    print(f"{V}-vocab factored decode: {xrt:.4f} xRT "
          f"({jax.default_backend()}, B={B}, T={T}, "
          f"topA={ma or 'off'}, median of 3)")


if __name__ == "__main__":
    main()
