"""Host-side LM costs: ARPA parse + LV network LM-table build.

These are pure host (CPU) costs that gate every large-vocabulary decode
session start: read the ARPA file, then compile the factored cross-word
tables. Both were Python loops; round 3 adds the native C++ ARPA codec
(htk_jax/native/htknative.cpp) and vectorises the table builders.

Usage: python benchmarks/lm_host_costs.py [V] [NBI]
Writes a synthetic V-word ARPA with NBI bigram lines to /tmp and times
  - read_arpa with the native codec,
  - read_arpa with HTKTPU_NO_NATIVE=1 (the pure-Python twin),
  - _factored_rows on the resulting LM (packed fast path vs the
    materialised-dict path).
"""

import os
import sys
import time

import numpy as np


def gen(path, V, nbi, seed=0):
    # unique (i, j) pairs: duplicate ARPA lines resolve last-wins in the
    # dict reader but max-wins in the packed consumers, which would make
    # the equality check below fail for data reasons
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, V * V, int(nbi * 1.01) + 16))
    key = rng.permutation(key)[:nbi]
    nbi = len(key)
    i, j = key // V, key % V
    p = -rng.random(nbi) * 2 - 0.05
    with open(path, "w") as f:
        f.write("\\data\\\nngram 1=%d\nngram 2=%d\n\n\\1-grams:\n" % (V, nbi))
        f.write("-2.5 <s> -0.4\n-2.5 </s>\n")
        for k in range(V):
            f.write("-3.4567 w%06d -0.301\n" % k)
        f.write("\n\\2-grams:\n")
        for k in range(nbi):
            f.write("%.4f w%06d w%06d\n" % (p[k], i[k], j[k]))
        f.write("\n\\end\\\n")


def main():
    V = int(sys.argv[1]) if len(sys.argv) > 1 else 20000
    nbi = int(sys.argv[2]) if len(sys.argv) > 2 else 2_000_000
    path = f"/tmp/lmhost_{V}_{nbi}.arpa"
    if not os.path.exists(path):
        gen(path, V, nbi)
    sz = os.path.getsize(path) / 1e6

    from htk_jax.algo import lvnet
    from htk_jax.io.lm import read_arpa

    t0 = time.time()
    lm_nat = read_arpa(path)
    t_nat = time.time() - t0

    os.environ["HTKTPU_NO_NATIVE"] = "1"
    try:
        t0 = time.time()
        lm_py = read_arpa(path)
        t_py = time.time() - t0
    finally:
        del os.environ["HTKTPU_NO_NATIVE"]

    words = [f"w{k:06d}" for k in range(V)]
    row_word = list(range(V))  # one pron per word

    # warm both paths once (allocator + lazy dict materialisation), then
    # time the steady state — the cold call is ~2x slower for whichever
    # path runs first
    lvnet._factored_rows(words, lm_nat, row_word, None, None)
    lvnet._factored_rows(words, lm_py, row_word, None, None)

    t0 = time.time()
    fr_packed = lvnet._factored_rows(words, lm_nat, row_word, None, None)
    t_fr_packed = time.time() - t0

    t0 = time.time()
    fr_dict = lvnet._factored_rows(words, lm_py, row_word, None, None)
    t_fr_dict = time.time() - t0

    same = all(
        np.array_equal(a, b) for (a, _), (b, _) in
        zip(fr_packed["buckets"], fr_dict["buckets"])
    ) and np.array_equal(fr_packed["inv"], fr_dict["inv"])

    print(f"ARPA {sz:.1f} MB, V={V}, bigram lines={nbi}")
    print(f"read_arpa native : {t_nat:8.3f} s")
    print(f"read_arpa python : {t_py:8.3f} s   ({t_py / max(t_nat, 1e-9):.1f}x)")
    print(f"factored packed  : {t_fr_packed:8.3f} s")
    print(f"factored dicts   : {t_fr_dict:8.3f} s   "
          f"({t_fr_dict / max(t_fr_packed, 1e-9):.1f}x)  equal={same}")
    print(f"total packed     : {t_nat + t_fr_packed:8.3f} s")
    print(f"total python     : {t_py + t_fr_dict:8.3f} s   "
          f"({(t_py + t_fr_dict) / max(t_nat + t_fr_packed, 1e-9):.1f}x)")


if __name__ == "__main__":
    main()
