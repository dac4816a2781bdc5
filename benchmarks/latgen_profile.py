"""Decompose batched HVite -z / HDecode lattice generation (how much
more than a plain decode does it cost at 5k, and where does it go?).

Three legs:
  device_s — the jitted scan + top-K record compaction (operands
             resident, block_until_ready)
  fetch_s  — the stacked np.asarray of the compacted records
  host_s   — the per-utterance record walk building Lattice objects
             (total - device - fetch)

Usage: python benchmarks/latgen_profile.py [batch] [k_lat]
Prints one JSON line.
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(batch=16, k_lat=None, corpus="model"):
    from bench import build_tied_triphone_system, synth_corpus

    import jax
    import jax.numpy as jnp

    from htk_jax.algo import decode as dmod
    from htk_jax.algo.decode import LAT_TOPK, generate_lattice_batch
    from htk_jax.algo.lvnet import compile_lv_loop

    comp, vocab, words, lm = build_tied_triphone_system(5000, n_tied=2000,
                                                        seed=7)
    net = compile_lv_loop(words, vocab, comp, lm=lm)
    rng = np.random.default_rng(3)
    dim = comp.means.shape[1]
    if corpus == "noise":
        T = 500
        feats = [rng.normal(size=(T, dim)).astype(np.float32)
                 for _ in range(batch)]
    else:
        feats, _ = synth_corpus(comp, vocab, words, batch, 12, rng)
        feats = [f[:500] for f in feats]
        T = max(f.shape[0] for f in feats)
    audio = sum(f.shape[0] for f in feats) * 0.01
    K = k_lat or LAT_TOPK

    # full tool-level pass
    lats = generate_lattice_batch(net, comp, feats, lm_scale=8.0,
                                  lattice_beam=150.0, k_lat=K)  # compile
    out = {"batch": batch, "k_lat": K, "T": T,
           "arcs_per_utt": round(sum(len(l.arcs) for l in lats) / batch, 1),
           "nodes_per_utt": round(sum(len(l.nodes) for l in lats) / batch, 1)}
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        generate_lattice_batch(net, comp, feats, lm_scale=8.0,
                               lattice_beam=150.0, k_lat=K)
        ts.append(time.perf_counter() - t0)
    out["total_s"] = round(statistics.median(ts), 3)

    # device leg: the jitted pipeline with resident operands
    fn = dmod._lv_lattice_pipeline(net, comp, "highest", None,
                                   min(K, net.n_chains), False)
    Tp = ((T + 127) // 128) * 128
    fb = np.zeros((batch, Tp, dim), np.float32)
    for b, f in enumerate(feats):
        fb[b, : f.shape[0]] = f
    xb = jnp.asarray(fb)
    args = (xb, dmod._dev_lens([f.shape[0] for f in feats]),
            dmod._dev_scalar(8.0),
            dmod._dev_scalar(0.0), dmod._dev_scalar(dmod._BEAM_OFF),
            dmod._dev_scalar(150.0), None)
    compact, planes = fn(*args)
    jax.block_until_ready(compact)
    ds = []
    for _ in range(3):
        t0 = time.perf_counter()
        compact, planes = fn(*args)
        jax.block_until_ready(compact)
        ds.append(time.perf_counter() - t0)
    out["device_s"] = round(statistics.median(ds), 3)

    # fetch leg: stacked transfer of the compacted records
    fs = []
    for _ in range(3):
        t0 = time.perf_counter()
        _ = [np.asarray(a) for a in compact]
        fs.append(time.perf_counter() - t0)
    out["fetch_s"] = round(statistics.median(fs), 3)

    out["host_s"] = round(out["total_s"] - out["device_s"] - out["fetch_s"],
                          3)
    out["xrt"] = round(out["total_s"] / audio, 5)
    out["device_xrt"] = round(out["device_s"] / audio, 5)
    out["backend"] = jax.default_backend()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 16,
         int(sys.argv[2]) if len(sys.argv) > 2 else None)
