"""Exact 4-gram lattice rescoring (latops.best_path_4gram) — a
capability beyond the reference decoder (HLVRec rescores trigram at
most): arc-state DP with an exact 3-word history per state."""

import numpy as np
import pytest

from htk_jax.algo.latops import best_path_4gram, best_path_trigram
from htk_jax.io.lm import NGramLM
from htk_jax.io.slf import Lattice, LArc, LNode, NULL_WORD


def diamond_lattice():
    """!NULL -> A -> X -> {Y | W} -> Z -> !NULL, flat acoustics."""
    lat = Lattice(lmscale=1.0, wdpenalty=0.0)
    words = [NULL_WORD, "A", "X", "Y", "W", "Z", NULL_WORD]
    for i, w in enumerate(words):
        lat.nodes.append(LNode(id=i, time=0.1 * i, word=w))
    arcs = [(0, 1), (1, 2), (2, 3), (2, 4), (3, 5), (4, 5), (5, 6)]
    for k, (s, e) in enumerate(arcs):
        lat.arcs.append(LArc(id=k, start=s, end=e, aclike=0.0,
                             lmlike=0.0))
    return lat


def make_lm(order=3):
    lm = NGramLM(order=order)
    for w in ("A", "X", "Y", "W", "Z"):
        lm.unigrams[w] = (np.log(0.2), np.log(0.1))
    lm.unigrams["!ENTER"] = (-99.0, np.log(0.2))
    for w1 in ("A", "X", "Y", "W", "Z", "!ENTER"):
        for w2 in ("A", "X", "Y", "W", "Z"):
            lm.bigrams[(w1, w2)] = (np.log(0.2), np.log(0.5))
    # trigram slightly prefers ... X Y Z over ... X W Z
    lm.trigrams[("X", "Y", "Z")] = np.log(0.30)
    lm.trigrams[("X", "W", "Z")] = np.log(0.25)
    return lm


class Test4Gram:
    def test_matches_trigram_without_fourgrams(self):
        lat = diamond_lattice()
        lm = make_lm(order=3)
        s3, p3 = best_path_trigram(lat, lm, 2.0, -0.5)
        s4, p4 = best_path_4gram(lat, lm, 2.0, -0.5)
        assert [w for w, _ in p4] == [w for w, _ in p3]
        assert s4 == pytest.approx(s3, rel=1e-9)

    def test_fourgram_flips_the_path(self):
        lat = diamond_lattice()
        lm = make_lm(order=4)
        # the 4-gram context (A, X, W) makes Z far likelier than any
        # trigram path; only the 4-gram rescorer can see it
        lm.fourgrams[("A", "X", "W", "Z")] = np.log(0.95)
        s3, p3 = best_path_trigram(lat, lm, 4.0, 0.0)
        s4, p4 = best_path_4gram(lat, lm, 4.0, 0.0)
        assert [w for w, _ in p3] == ["A", "X", "Y", "Z"]
        assert [w for w, _ in p4] == ["A", "X", "W", "Z"]
        assert s4 > s3

    def test_tri_backoff_weight_applies(self):
        """Paths without explicit 4-grams score tri_bo + trigram."""
        lat = diamond_lattice()
        lm = make_lm(order=4)
        lm.tri_bo[("X", "Y", "Z")] = 0.0  # placeholder context entry
        lm.tri_bo[("A", "X", "Y")] = np.log(0.5)
        lm.tri_bo[("A", "X", "W")] = np.log(0.5)
        s4, p4 = best_path_4gram(lat, lm, 1.0, 0.0)
        # hand-computed best path A X Y Z:
        want = (lm.logp_4("!ENTER", "!ENTER", "!ENTER", "A")
                + lm.logp_4("!ENTER", "!ENTER", "A", "X")
                + lm.logp_4("!ENTER", "A", "X", "Y")
                + lm.logp_4("A", "X", "Y", "Z"))
        assert [w for w, _ in p4] == ["A", "X", "Y", "Z"]
        assert s4 == pytest.approx(want, rel=1e-9)
