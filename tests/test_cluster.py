"""Cluster (HLM exchange word classes) tests."""

from collections import Counter

import numpy as np
import pytest

from htk_jax.tools.cluster import (_f, class_bigram_arpa, exchange_cluster,
                                   read_classmap, write_classmap)
from htk_jax.tools import cluster as cluster_tool
from htk_jax.tools.lbuild import ENTER, EXIT


def planted_corpus(rng, n=200):
    """x-words always followed by y-words: two latent classes."""
    X = ["x1", "x2", "x3"]
    Y = ["y1", "y2", "y3"]
    sents = []
    for _ in range(n):
        s = []
        for _ in range(int(rng.integers(2, 5))):
            s += [X[int(rng.integers(3))], Y[int(rng.integers(3))]]
        sents.append(s)
    return sents


def counts(sents):
    uni, bi = Counter(), Counter()
    for s in sents:
        seq = [ENTER] + s + [EXIT]
        for w in seq:
            uni[w] += 1
        for a, b in zip(seq, seq[1:]):
            bi[(a, b)] += 1
    return uni, bi


def class_likelihood(cls, bigrams, unigrams):
    Ncc, Nc = Counter(), Counter()
    for (w1, w2), n in bigrams.items():
        Ncc[(cls[w1], cls[w2])] += n
    for w, n in unigrams.items():
        Nc[cls[w]] += n
    return (sum(_f(v) for v in Ncc.values())
            - 2.0 * sum(_f(v) for v in Nc.values()))


class TestExchange:
    def test_recovers_planted_classes(self):
        rng = np.random.default_rng(0)
        uni, bi = counts(planted_corpus(rng))
        cls, total = exchange_cluster(bi, uni, 2, iters=4)
        xc = {cls[w] for w in ("x1", "x2", "x3")}
        yc = {cls[w] for w in ("y1", "y2", "y3")}
        assert len(xc) == 1 and len(yc) == 1 and xc != yc
        # pinned boundary tokens sit in their own singleton classes
        assert cls[ENTER] >= 2 and cls[EXIT] >= 2 and cls[ENTER] != cls[EXIT]

    def test_exchange_improves_likelihood(self):
        rng = np.random.default_rng(1)
        uni, bi = counts(planted_corpus(rng, n=80))
        cls0, _ = exchange_cluster(bi, uni, 3, iters=0)
        cls2, _ = exchange_cluster(bi, uni, 3, iters=3)
        assert (class_likelihood(cls2, bi, uni)
                >= class_likelihood(cls0, bi, uni) - 1e-6)

    def test_classmap_roundtrip(self, tmp_path):
        cls = {"a": 0, "b": 1, "c": 0}
        p = str(tmp_path / "cmap")
        write_classmap(p, cls)
        assert read_classmap(p) == cls


class TestTool:
    def test_tool_and_class_lm(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        rng = np.random.default_rng(2)
        with open("train.txt", "w") as f:
            for s in planted_corpus(rng, n=120):
                f.write(" ".join(s) + "\n")
        open("wmap", "w").write("x1\nx2\nx3\ny1\ny2\ny3\n")
        rc = cluster_tool.run(["-c", "2", "-i", "3", "-p", "class.arpa",
                               "wmap", "cmap", "train.txt"])
        assert rc == 0
        cls = read_classmap("cmap")
        assert len({cls[w] for w in ("x1", "x2", "x3")}) == 1

        # the expanded class LM is valid ARPA and scores y after x higher
        from htk_jax.io.lm import read_arpa
        lm = read_arpa("class.arpa")
        assert lm.order == 2
        p_xy = lm.bigrams.get(("x1", "y2"))
        assert p_xy is not None
        assert ("x1", "x2") not in lm.bigrams  # unseen class pair backs off

        # LPlex consumes it
        from htk_jax.tools import lplex
        assert lplex.run(["-n", "2", "class.arpa", "train.txt"]) == 0
