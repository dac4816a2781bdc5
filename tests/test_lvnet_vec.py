"""Vectorised LV-network LM table builders vs the former Python loops.

algo/lvnet's lm_loop_matrices/_start_end_vectors/_factored_rows were
rewritten from per-bigram Python loops to one vectorised pass (the loops
were a multi-second host stall at 100k vocab / 2M bigrams). These tests
pin the new code bit-for-bit against reference copies of the loop
implementations, including bucket layouts and slot orders."""

import numpy as np
import pytest

from htk_jax.algo import lvnet
from htk_jax.io.lm import LN10, NGramLM

LZERO = -1.0e10


# --- reference copies of the former loop implementations -------------------

def _ref_lm_loop_matrices(words, lm, sent_start="!ENTER", sent_end="!EXIT"):
    W = len(words)
    idx = {w: k for k, w in enumerate(words)}
    uni = np.empty(W, np.float64)
    bow = np.empty(W, np.float64)
    for k, w in enumerate(words):
        uni[k], bow[k] = lm.unigrams[w]
    trans = bow[:, None] + uni[None, :]
    for (w1, w2), (p, _bo) in lm.bigrams.items():
        i = idx.get(w1)
        j = idx.get(w2)
        if i is not None and j is not None:
            trans[i, j] = max(trans[i, j], p)
    if sent_start in lm.unigrams:
        ss_bow = lm.unigrams[sent_start][1]
        start_entry = ss_bow + uni
        for (w1, w2), (p, _bo) in lm.bigrams.items():
            if w1 == sent_start and w2 in idx:
                j = idx[w2]
                start_entry[j] = max(start_entry[j], p)
    else:
        start_entry = uni.copy()
    if sent_end in lm.unigrams:
        end_exit = bow + lm.unigrams[sent_end][0]
        for (w1, w2), (p, _bo) in lm.bigrams.items():
            if w2 == sent_end and w1 in idx:
                i = idx[w1]
                end_exit[i] = max(end_exit[i], p)
    else:
        end_exit = np.zeros(W, np.float64)
    return trans, start_entry, end_exit


def _ref_start_end_vectors(words, lm, sent_start, sent_end):
    W = len(words)
    if sent_start in lm.unigrams:
        ss_bow = lm.unigrams[sent_start][1]
        w_start = np.array(
            [max(lm.logp_bi(sent_start, w), ss_bow + lm.logp_uni(w))
             for w in words])
    else:
        w_start = np.array([lm.logp_uni(w) for w in words])
    if sent_end in lm.unigrams:
        e_uni = lm.unigrams[sent_end][0]
        w_end = np.array(
            [max(lm.logp_bi(w, sent_end),
                 lm.unigrams[w][1] + e_uni if w in lm.unigrams else LZERO)
             for w in words])
    else:
        w_end = np.zeros(W, np.float64)
    return w_start, w_end


def _ref_factored_rows(words, lm, row_word, i_s, i_e):
    C = len(row_word)
    idx = {w: k for k, w in enumerate(words)}
    uni = np.empty(len(words))
    bow = np.empty(len(words))
    for k, w in enumerate(words):
        uni[k], bow[k] = lm.unigrams[w]
    uni_in = uni.copy()
    bow_out = bow.copy()
    if i_s is not None:
        uni_in[i_s] = LZERO
    if i_e is not None:
        bow_out[i_e] = LZERO
    rw = np.asarray(row_word)
    rows_of: dict = {}
    for r, wi in enumerate(row_word):
        rows_of.setdefault(wi, []).append(r)
    pred_lists = [[] for _ in range(C)]
    for (w1, w2), (p, _bo) in lm.bigrams.items():
        i = idx.get(w1)
        j = idx.get(w2)
        if i is None or j is None:
            continue
        if (i_s is not None and j == i_s) or (i_e is not None and i == i_e):
            continue
        for tr_ in rows_of.get(j, ()):
            for sr in rows_of.get(i, ()):
                pred_lists[tr_].append((sr, p))
    groups: dict = {}
    for r in range(C):
        fb = lvnet._bucket_width(len(pred_lists[r]))
        groups.setdefault(fb, []).append(r)
    buckets = []
    perm = []
    for fb in sorted(groups):
        rows = groups[fb]
        preds = np.zeros((len(rows), fb), np.int32)
        scores = np.full((len(rows), fb), LZERO, np.float32)
        for k, r in enumerate(rows):
            for q, (sr, p) in enumerate(pred_lists[r]):
                preds[k, q] = sr
                scores[k, q] = p
        buckets.append((preds, scores))
        perm.extend(rows)
    inv = np.empty(C, np.int32)
    inv[np.asarray(perm)] = np.arange(C, dtype=np.int32)
    succ_lists: dict = {}
    for tr_ in range(C):
        for sr, p in pred_lists[tr_]:
            succ_lists.setdefault(sr, []).append((tr_, p))
    o_max = max((len(v) for v in succ_lists.values()), default=0)
    succ_j = succ_p = None
    if o_max and C * o_max <= 32_000_000:
        succ_j = np.full((C, o_max), C, np.int32)
        succ_p = np.full((C, o_max), LZERO, np.float32)
        for sr, lst in succ_lists.items():
            for q, (tr_, p) in enumerate(lst):
                succ_j[sr, q] = tr_
                succ_p[sr, q] = p
    return {
        "bow": bow_out[rw].astype(np.float32),
        "uni": uni_in[rw].astype(np.float32),
        "buckets": buckets,
        "inv": inv,
        "succ_j": succ_j,
        "succ_p": succ_p,
    }


# --- fixtures ---------------------------------------------------------------

def _random_lm(rng, nwords, nbi, with_boundary=True, oov_frac=0.0):
    words = [f"w{i}" for i in range(nwords)]
    lm = NGramLM()
    pool = list(words)
    if with_boundary:
        pool += ["<s>", "</s>"]
    for w in pool:
        if oov_frac and rng.random() < oov_frac and w not in ("<s>", "</s>"):
            continue  # leave some words out of the LM
        lm.unigrams[w] = (float(-rng.random() * 3 - 0.1) * LN10,
                          float(-rng.random()) * LN10)
    for _ in range(nbi):
        w1 = pool[rng.integers(len(pool))]
        w2 = pool[rng.integers(len(pool))]
        lm.bigrams[(w1, w2)] = (float(-rng.random() * 2 - 0.05) * LN10,
                                float(-rng.random() * 0.5) * LN10)
    return words, lm


def _rows(rng, nwords, max_prons=3):
    row_word = []
    for wi in range(nwords):
        for _ in range(int(rng.integers(1, max_prons + 1))):
            row_word.append(wi)
    return row_word


def assert_factored_equal(a, b):
    np.testing.assert_array_equal(a["bow"], b["bow"])
    np.testing.assert_array_equal(a["uni"], b["uni"])
    np.testing.assert_array_equal(a["inv"], b["inv"])
    assert len(a["buckets"]) == len(b["buckets"])
    for (pa, sa), (pb, sb) in zip(a["buckets"], b["buckets"]):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(sa, sb)
    for k in ("succ_j", "succ_p"):
        if a[k] is None:
            assert b[k] is None
        else:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lm_loop_matrices_matches_loops(seed):
    rng = np.random.default_rng(seed)
    words, lm = _random_lm(rng, 30, 200)
    for ss, se in (("<s>", "</s>"), ("!ENTER", "!EXIT")):
        t0, s0, e0 = _ref_lm_loop_matrices(words, lm, ss, se)
        t1, s1, e1 = lvnet.lm_loop_matrices(words, lm, ss, se)
        np.testing.assert_array_equal(t0, t1)
        np.testing.assert_array_equal(s0, s1)
        np.testing.assert_array_equal(e0, e1)


def test_lm_loop_matrices_boundary_words_in_loop():
    """STARTWORD/ENDWORD mode: <s>/</s> are loop words AND the ARPA
    sentence boundaries — their bigrams must land in trans and the
    start/end vectors."""
    rng = np.random.default_rng(3)
    words, lm = _random_lm(rng, 20, 150)
    wl = ["<s>"] + words + ["</s>"]
    t0, s0, e0 = _ref_lm_loop_matrices(wl, lm, "<s>", "</s>")
    t1, s1, e1 = lvnet.lm_loop_matrices(wl, lm, "<s>", "</s>")
    np.testing.assert_array_equal(t0, t1)
    np.testing.assert_array_equal(s0, s1)
    np.testing.assert_array_equal(e0, e1)


@pytest.mark.parametrize("seed,oov", [(0, 0.0), (1, 0.0), (2, 0.3)])
def test_start_end_vectors_matches_loops(seed, oov):
    rng = np.random.default_rng(seed)
    words, lm = _random_lm(rng, 25, 180, oov_frac=oov)
    ws0, we0 = _ref_start_end_vectors(words, lm, "<s>", "</s>")
    ws1, we1 = lvnet._start_end_vectors(words, lm, "<s>", "</s>")
    np.testing.assert_array_equal(ws0, ws1)
    np.testing.assert_array_equal(we0, we1)
    # and without boundary entries in the LM
    ws0, we0 = _ref_start_end_vectors(words, lm, "!E", "!X")
    ws1, we1 = lvnet._start_end_vectors(words, lm, "!E", "!X")
    np.testing.assert_array_equal(ws0, ws1)
    np.testing.assert_array_equal(we0, we1)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_factored_rows_matches_loops(seed):
    rng = np.random.default_rng(seed)
    words, lm = _random_lm(rng, 24, 160)
    row_word = _rows(rng, len(words))
    a = _ref_factored_rows(words, lm, row_word, None, None)
    b = lvnet._factored_rows(words, lm, row_word, None, None)
    assert_factored_equal(a, b)


def test_factored_rows_boundary_filtering():
    rng = np.random.default_rng(7)
    words, lm = _random_lm(rng, 18, 120)
    wl = ["<s>"] + words + ["</s>"]
    for w in wl:
        lm.unigrams.setdefault(w, (-2.0, -0.5))
    row_word = []
    for wi in range(len(wl)):
        row_word.extend([wi] * int(rng.integers(1, 3)))
    i_s, i_e = 0, len(wl) - 1
    a = _ref_factored_rows(wl, lm, row_word, i_s, i_e)
    b = lvnet._factored_rows(wl, lm, row_word, i_s, i_e)
    assert_factored_equal(a, b)


def test_factored_rows_no_bigrams():
    words = ["a", "b", "c"]
    lm = NGramLM()
    for w in words:
        lm.unigrams[w] = (-1.0, -0.2)
    row_word = [0, 0, 1, 2]
    a = _ref_factored_rows(words, lm, row_word, None, None)
    b = lvnet._factored_rows(words, lm, row_word, None, None)
    assert_factored_equal(a, b)
    assert b["succ_j"] is None


def test_factored_rows_packed_lm(tmp_path):
    """The PackedNGramLM array path produces the same tables as the
    dict path for the same ARPA file."""
    from htk_jax.io.lm import read_arpa, write_arpa

    rng = np.random.default_rng(11)
    words, lm = _random_lm(rng, 20, 140)
    path = str(tmp_path / "r.arpa")
    write_arpa(lm, path)
    import os
    os.environ["HTKTPU_NO_NATIVE"] = "1"
    try:
        lm_py = read_arpa(path)
    finally:
        del os.environ["HTKTPU_NO_NATIVE"]
    lm_nat = read_arpa(path)
    row_word = _rows(rng, len(words))
    a = lvnet._factored_rows(words, lm_py, row_word, None, None)
    b = lvnet._factored_rows(words, lm_nat, row_word, None, None)
    assert_factored_equal(a, b)
    t0, s0, e0 = lvnet.lm_loop_matrices(words, lm_py, "<s>", "</s>")
    t1, s1, e1 = lvnet.lm_loop_matrices(words, lm_nat, "<s>", "</s>")
    np.testing.assert_array_equal(t0, t1)
    np.testing.assert_array_equal(s0, s1)
    np.testing.assert_array_equal(e0, e1)
