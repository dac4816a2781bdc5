"""Large-vocabulary decode-network compiler (the HLVNet role).

Mirrors `HTKLVRec/HLVNet.c`'s job — build the search network for a
full-vocabulary n-gram decode — with a layout chosen for dense device
scans instead of HLVNet's prefix-tree + LM-lookahead pointer structures:

  - one row per (word, pronunciation), every row padded to one common
    state width S_pad. The decode state vector is the flat (C * S_pad,)
    concatenation, so the existing banded within-word update applies
    unchanged, the word-end reduction is a reshape + row-max (no
    (Nn, Ns) mask, which is the small-net decoder's scaling wall), and
    word entry is a row broadcast — zero gathers anywhere in the scan;
  - the cross-word step is a dense (C, C) max-plus matvec built directly
    from the ARPA back-off tables (bow[i] + uni[j] overwritten by
    explicit bigrams), evaluated per frame and amortised over the
    utterance batch. Word-end top-A
    pruning (HLVRec's histogram/maxModel analogue) cuts that further
    and is exact whenever A covers every live word end;
  - interiors are word-internal context-dependent models; cross-word
    triphone exactness comes from the second pass (HDecode rescoring the
    pass-1 lattice with a lattice-constrained cross-word expansion),
    not from duplicating first/last-phone variants into the static
    network — the dense-layout answer to HLVNet's cross-word layers.

The result is an ordinary DecodeNetwork with `uniform_width` set; all
traceback / lattice machinery in algo/decode.py applies unchanged.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..io.dictionary import Vocab
from ..io.lm import NGramLM
from ..models.hmmset import CompiledHMMSet
from ..utils.errors import HError
from .composite import build_composite
from .net import DecodeNetwork

LZERO = -1.0e10
LSMALL = -0.5e10

# auto cut-over from the dense (C, C) cross-word matrix to the factored
# back-off tables: dense memory is 4*C^2 bytes (256 MB here)
FACTORED_THRESHOLD = 8000


def lm_loop_matrices(words: Sequence[str], lm: NGramLM,
                     sent_start: str = "!ENTER", sent_end: str = "!EXIT"):
    """Dense back-off bigram word-loop matrices from the ARPA tables.

    Returns (trans (W, W), start_entry (W,), end_exit (W,)) in natural
    logs: trans[i, j] = ln P(w_j | w_i) with back-off-NETWORK semantics,
    max(explicit bigram, bow(w_i) + uni(w_j)) — both paths physically
    exist in an HBuild back-off word network and the decoder maxes over
    them (SURVEY §2.3 HBuild; `HTKLib/HLM.c` strict GetLMProb replacement
    differs only where discounting pushes an explicit bigram below its
    own back-off product). This matches the factored `_factored_rows`
    form exactly, so the dense and factored paths agree bit-for-bit."""
    W = len(words)
    uni = np.empty(W, np.float64)
    bow = np.empty(W, np.float64)
    for k, w in enumerate(words):
        e = lm.unigrams.get(w)
        if e is None:
            HError(8625, "lm_loop_matrices: %s not in LM", w)
        uni[k], bow[k] = e
    trans = bow[:, None] + uni[None, :]

    # one vectorised pass over the explicit bigrams (bigram_arrays is
    # array-native for PackedNGramLM — no million-entry dict walk);
    # sentence-boundary words index after the loop words unless they are
    # loop words themselves (HDecode STARTWORD/ENDWORD boundary mode)
    ext = list(words)
    pos = {w: k for k, w in enumerate(ext)}
    for w in (sent_start, sent_end):
        if w not in pos:
            pos[w] = len(ext)
            ext.append(w)
    bi_i, bi_j, bi_p = lm.bigram_arrays(ext)
    m = (bi_i < W) & (bi_j < W)
    np.maximum.at(trans, (bi_i[m], bi_j[m]), bi_p[m])

    if sent_start in lm.unigrams:
        ss_bow = lm.unigrams[sent_start][1]
        start_entry = ss_bow + uni
        m = (bi_i == pos[sent_start]) & (bi_j < W)
        np.maximum.at(start_entry, bi_j[m], bi_p[m])
    else:
        start_entry = uni.copy()
    if sent_end in lm.unigrams:
        end_exit = bow + lm.unigrams[sent_end][0]
        m = (bi_j == pos[sent_end]) & (bi_i < W)
        np.maximum.at(end_exit, bi_i[m], bi_p[m])
    else:
        end_exit = np.zeros(W, np.float64)
    return trans, start_entry, end_exit


def _start_end_vectors(words, lm, sent_start, sent_end):
    """Word-level start/end log-probs, matching lm_loop_matrices'
    back-off-network max(explicit, bow + uni) semantics."""
    W = len(words)
    unis = lm.unigrams
    uni_all = np.array([lm.logp_uni(w) for w in words])
    ext = list(words)
    pos = {w: k for k, w in enumerate(ext)}
    for w in (sent_start, sent_end):
        if w not in pos:
            pos[w] = len(ext)
            ext.append(w)
    bi_i, bi_j, bi_p = lm.bigram_arrays(ext)
    if sent_start in unis:
        ss_bow = unis[sent_start][1]
        w_start = ss_bow + uni_all
        m = (bi_i == pos[sent_start]) & (bi_j < W)
        np.maximum.at(w_start, bi_j[m], bi_p[m])
    else:
        w_start = uni_all.copy()
    if sent_end in unis:
        e_uni = unis[sent_end][0]
        in_lm = np.array([w in unis for w in words])
        bow_all = np.array([unis[w][1] if w in unis else 0.0
                            for w in words])
        # max(logp_bi(w, </s>), bow(w) + P(</s>) if w in LM else LZERO):
        # logp_bi is the explicit bigram when present, else its back-off
        # product bow(w) + P(</s>)
        second = np.where(in_lm, bow_all + e_uni, LZERO)
        exp_p = np.full(W, -np.inf)
        m = (bi_j == pos[sent_end]) & (bi_i < W)
        np.maximum.at(exp_p, bi_i[m], bi_p[m])
        has_exp = np.zeros(W, bool)
        has_exp[bi_i[m]] = True
        first = np.where(has_exp, exp_p, bow_all + e_uni)
        w_end = np.maximum(first, second)
    else:
        w_end = np.zeros(W, np.float64)
    return w_start, w_end


def _bucket_width(n: int) -> int:
    """Padded in-degree for a bucket row: multiples of 4 instead of
    powers of two — the explicit-bigram leg is gather-index bound, and
    mult-4 padding carries ~25% fewer padded slots at 20k (571k -> 430k
    measured) for a handful of extra bucket gathers."""
    return max(4, -(-n // 4) * 4)


def _factored_rows(words, lm, row_word, i_s, i_e):
    """Row-level factored cross-word tables (the HLVLM role).

    The dense (C, C) max-plus matvec decomposes through the ARPA
    back-off structure: entry[j] = max( max_i(WE[i] + bow[i]) + uni[j],
    max over explicit bigrams i->j of WE[i] + P(j|i) ). The back-off leg
    is O(C); the explicit leg is a gather over per-target predecessor
    lists, bucketed by in-degree (rows padded to a multiple of four per
    bucket) so total per-frame work is O(#bigrams) — no dense matrix,
    no top-k pruning, exact at any vocabulary.

    Semantics note: where an explicit bigram scores BELOW its back-off
    path, the max picks the back-off — exactly the behaviour of HTK's
    HBuild back-off word networks (both paths exist in the net and the
    decoder maxes over them), vs. ARPA's strict replacement. i_s/i_e:
    boundary word indices (nothing re-enters <s>, nothing leaves </s>).

    Everything below is vectorised (one pass over the bigram arrays, a
    stable sort, and segment arithmetic) — at 100k vocab / 2M bigrams
    the former per-entry Python loops were a multi-second host stall on
    every network compile.
    """
    C = len(row_word)
    uni = np.empty(len(words))
    bow = np.empty(len(words))
    for k, w in enumerate(words):
        e = lm.unigrams.get(w)
        if e is None:
            HError(8625, "compile_lv_loop: %s not in LM", w)
        uni[k], bow[k] = e
    uni_in = uni.copy()
    bow_out = bow.copy()
    if i_s is not None:
        uni_in[i_s] = LZERO  # nothing re-enters <s> via back-off
    if i_e is not None:
        bow_out[i_e] = LZERO  # nothing leaves </s>

    rw = np.asarray(row_word)

    bi_i, bi_j, bi_p = lm.bigram_arrays(words)
    keep = np.ones(len(bi_i), bool)
    if i_s is not None:
        keep &= bi_j != i_s
    if i_e is not None:
        keep &= bi_i != i_e
    bi_i, bi_j, bi_p = bi_i[keep], bi_j[keep], bi_p[keep]

    # expand word-level bigrams to (src_row, tgt_row, score) triples.
    # rows of a word are contiguous ascending (built in word order), so
    # word w's rows are [w0[w], w0[w] + cnt[w]). Expansion order matches
    # the former nested loops — (bigram, target row, source row) — so
    # the bucket tables come out bit-identical.
    cnt = np.bincount(rw, minlength=len(words)).astype(np.int64)
    w0 = np.zeros(len(words), np.int64)
    if len(words):
        w0[1:] = np.cumsum(cnt)[:-1]

    def _expand(reps):
        # per-element group index + within-group rank for repeat counts
        tot = int(reps.sum())
        gi = np.repeat(np.arange(len(reps), dtype=np.int64), reps)
        starts = np.zeros(len(reps), np.int64)
        starts[1:] = np.cumsum(reps)[:-1]
        return gi, np.arange(tot, dtype=np.int64) - starts[gi]

    e1, off1 = _expand(cnt[bi_j])          # one copy per target row
    tr1 = w0[bi_j[e1]] + off1
    e2, off2 = _expand(cnt[bi_i][e1])      # ... then per source row
    tgt = tr1[e2]
    src = w0[bi_i[e1]][e2] + off2
    sc = bi_p[e1][e2]
    n_e = len(tgt)

    # bucket target rows by padded in-degree
    indeg = np.bincount(tgt, minlength=C).astype(np.int64)
    fb_row = np.maximum(4, -(-indeg // 4) * 4)
    order = np.argsort(fb_row, kind="stable")  # (bucket asc, row asc)
    inv = np.empty(C, np.int32)
    inv[order] = np.arange(C, dtype=np.int32)

    # entries of a target row, in expansion order, fill its slots 0..n-1
    eorder = np.argsort(tgt, kind="stable")
    tgt_s, src_s, sc_s = tgt[eorder], src[eorder], sc[eorder]
    row_first = np.cumsum(indeg) - indeg
    slot = np.arange(n_e, dtype=np.int64) - row_first[tgt_s]

    buckets = []
    uniq_fb, fb_counts = np.unique(fb_row, return_counts=True)
    start = 0
    for fb, nrows in zip(uniq_fb.tolist(), fb_counts.tolist()):
        preds = np.zeros((nrows, fb), np.int32)  # pad -> row 0
        scores = np.full((nrows, fb), LZERO, np.float32)
        sel = fb_row[tgt_s] == fb
        rpos = inv[tgt_s[sel]] - start
        preds[rpos, slot[sel]] = src_s[sel]
        scores[rpos, slot[sel]] = sc_s[sel]
        buckets.append((preds, scores))
        start += nrows

    # successor tables (the transposed view): row-level succ lists per
    # SOURCE row, for the top-A explicit leg (HLVRec maxModel-style
    # histogram pruning on the cross-word step). The per-target gather
    # leg costs O(#bigrams) gathers per frame; with the
    # succ tables the explicit leg shrinks to A row-gathers plus an
    # A*O_max scatter-max. Skipped
    # (None) when a skewed out-degree distribution would make the dense
    # (C, O_max) table explode; the exact bucket leg always remains.
    outdeg = np.bincount(src, minlength=C).astype(np.int64)
    o_max = int(outdeg.max()) if C else 0
    succ_j = succ_p = None
    if o_max and C * o_max <= 32_000_000:
        # succ insertion order = target-major over the expansion stream
        sorder = np.argsort(src_s, kind="stable")
        src_g, tgt_g, sc_g = src_s[sorder], tgt_s[sorder], sc_s[sorder]
        succ_j = np.full((C, o_max), C, np.int32)  # pad -> dummy row C
        succ_p = np.full((C, o_max), LZERO, np.float32)
        src_first = np.cumsum(outdeg) - outdeg
        slot2 = np.arange(n_e, dtype=np.int64) - src_first[src_g]
        succ_j[src_g, slot2] = tgt_g
        succ_p[src_g, slot2] = sc_g
    # per-source certificate margin for the adaptive-exact cross-word
    # step (decode._make_uniform_step, adaptive=True): an excluded
    # source i can outscore the back-off floor bo_best + uni[j] at some
    # target j only if WE[i] + max_j(p_ij - uni_j) > bo_best, so
    # marg[i] = that static max makes "top-A missed nothing this frame"
    # a one-reduction soundness certificate.
    marg = np.full(C, LZERO, np.float32)
    if n_e:
        np.maximum.at(marg, src, sc - uni_in[rw[tgt]])
    return {
        "bow": bow_out[rw].astype(np.float32),
        "uni": uni_in[rw].astype(np.float32),
        "buckets": buckets,
        "inv": inv,
        "succ_j": succ_j,
        "succ_p": succ_p,
        "marg": marg,
    }


def _trigram_tables(words, lm, row_word, i_s, i_e, sent_start):
    """Single-pass trigram guidance tables (the `HTKLVRec/HLVRec-LM.c`
    role).

    The reference decodes trigrams in ONE pass by carrying LM states on
    its tokens. Here every row keeps its single best token, and that
    token's entry record already names its predecessor row (the pwn
    plane the scan emits every frame) — so the cross-word step can
    rescore each word end with its best predecessor's trigram context:

      entry[j] = max_i WE[i] + max( s*tri(u_i, v_i, j),
                                    s*tribow(u_i, v_i) + bigram legs )

    where u_i = word(pwn[i]) and v_i = word(i). This is the word-pair
    approximation (one LM context per row, the best one) rather than
    HLVRec's exact token-set search; the exact lattice rescoring pass
    stays on, and the point of the guidance is that the pass-1 beam now
    protects trigram-best hypotheses (measured: the genBeam search-error
    knee collapses, benchmarks/lattice_quality.py).

    Table layout (everything static, device-resident once):
      pair_u / pair_bow / pair_tstart / pair_tcnt — the (u, v) bigram
        contexts, sorted (v_row asc, u_word asc) so each decode lane's
        segment base is STATIC (seg_start[v_row]) and the per-frame
        lookup is a short binary search over u alone — no int64 pair
        keys (jax default dtypes are 32-bit);
      seg_start (C+1,) — per-row slice into the pair arrays;
      tri_j / tri_p — row-level explicit-trigram successor lists,
        pair-major CSR (pair_tstart/pair_tcnt), target-sorted within a
        pair so the host lattice lookup can binary-search a target;
      ctx_word (C+1,) — row -> word id; slot C is the sentence-start
        context (tokens whose record says "no predecessor" back off to
        the <s> context, exactly HLVRec's initial LM state).
    """
    C = len(row_word)
    W = len(words)
    rw = np.asarray(row_word, np.int64)
    extra = () if sent_start in words else (sent_start,)
    t_i, t_j, t_k, t_p = lm.trigram_arrays(list(words), tuple(extra))
    # v and the target must be loop words; the context u may be the
    # sentence start (index W when it is not itself a loop word)
    kt = (t_j < W) & (t_k < W)
    if i_e is not None:
        kt &= t_j != i_e  # nothing leaves </s>
    if i_s is not None:
        kt &= t_k != i_s  # nothing re-enters <s>
    t_i, t_j, t_k, t_p = t_i[kt], t_j[kt], t_k[kt], t_p[kt]
    if not len(t_i):
        return None
    bi_i, bi_j, bi_b = lm.bigram_bow_arrays(list(words), tuple(extra))
    kb = bi_j < W
    if i_e is not None:
        kb &= bi_j != i_e
    pu, pv, pb = bi_i[kb], bi_j[kb], bi_b[kb]
    # contexts present only in the trigram section (ill-formed ARPA
    # tolerated the way HLM.c tolerates it): back-off weight 0
    Wx = W + 1
    miss = np.setdiff1d(np.unique(t_i * Wx + t_j), pu * Wx + pv)
    if len(miss):
        pu = np.concatenate([pu, miss // Wx])
        pv = np.concatenate([pv, miss % Wx])
        pb = np.concatenate([pb, np.zeros(len(miss))])

    cnt = np.bincount(rw, minlength=W).astype(np.int64)
    w0 = np.zeros(W, np.int64)
    w0[1:] = np.cumsum(cnt)[:-1]

    def _expand(reps):
        tot = int(reps.sum())
        gi = np.repeat(np.arange(len(reps), dtype=np.int64), reps)
        starts = np.cumsum(reps) - reps
        return gi, np.arange(tot, dtype=np.int64) - starts[gi]

    # (u_word, v_word) pairs expand over v's pronunciation rows (the
    # back-off weight is a word property; rows are (word, pron))
    g, off = _expand(cnt[pv])
    p_u = pu[g]
    p_vrow = w0[pv[g]] + off
    p_bow = pb[g]
    # trigram instances expand over v's rows then the target's rows
    g1, o1 = _expand(cnt[t_j])
    u1, v1, k1, p1 = t_i[g1], w0[t_j[g1]] + o1, t_k[g1], t_p[g1]
    g2, o2 = _expand(cnt[k1])
    tri_tgt = w0[k1[g2]] + o2
    tkey = v1[g2] * Wx + u1[g2]
    tri_lp = p1[g2]

    if not len(pu):
        return None  # trigrams but zero usable contexts: nothing to guide
    po = np.lexsort((p_u, p_vrow))
    p_u, p_vrow, p_bow = p_u[po], p_vrow[po], p_bow[po]
    pkey = p_vrow * Wx + p_u
    to = np.lexsort((tri_tgt, tkey))
    tkey, tri_tgt, tri_lp = tkey[to], tri_tgt[to], tri_lp[to]
    pair_tstart = np.searchsorted(tkey, pkey, side="left")
    pair_tcnt = np.searchsorted(tkey, pkey, side="right") - pair_tstart
    seg_start = np.searchsorted(p_vrow, np.arange(C + 1))
    max_seg = int((seg_start[1:] - seg_start[:-1]).max()) if C else 0
    o3max = int(pair_tcnt.max()) if len(pair_tcnt) else 0

    s_ctx = words.index(sent_start) if sent_start in words else W
    ctx_word = np.concatenate([rw, [s_ctx]])
    return {
        "pair_u": p_u.astype(np.int32),
        "pair_bow": p_bow.astype(np.float32),
        "pair_tstart": pair_tstart.astype(np.int32),
        "pair_tcnt": pair_tcnt.astype(np.int32),
        "seg_start": seg_start.astype(np.int32),
        "tri_j": tri_tgt.astype(np.int32),
        "tri_p": tri_lp.astype(np.float32),
        "ctx_word": ctx_word.astype(np.int32),
        "o3max": o3max,
        "iters": max(1, int(np.ceil(np.log2(max_seg + 1)))),
    }


def compile_lv_loop(
    words: Sequence[str],
    vocab: Vocab,
    comp: CompiledHMMSet,
    lm: Optional[NGramLM] = None,
    phone_map=None,
    sent_start: str = "!ENTER",
    sent_end: str = "!EXIT",
    pad_multiple: int = 4,
    start_word: Optional[str] = None,
    end_word: Optional[str] = None,
    factored: Optional[bool] = None,
    trigram: bool = False,
) -> DecodeNetwork:
    """Compile a full-vocabulary back-off bigram word loop.

    Equivalent in results to compile_network(bigram_lattice(...)) but
    built directly from the LM tables (no O(W^2) lattice arcs on the
    host) and emitted in the uniform-width row layout. lm=None gives an
    unweighted loop (HBuild word-loop parity).

    start_word/end_word (HDecode STARTWORD/ENDWORD, typically <s>/</s>
    with silence pronunciations in the dictionary) become dedicated
    boundary rows: every path must start in start_word's models and end
    in end_word's — HDecode's obligatory utterance-edge silence. They must
    be present in the LM (ARPA always carries <s>/</s>).

    `factored`: cross-word step through the back-off structure
    (xw_backoff tables) instead of the dense (C, C) matrix. The dense
    matrix is 4*C^2 bytes — 400 MB at 10k rows — so beyond
    FACTORED_THRESHOLD rows the factored form is the only viable one.
    None = auto by that threshold.

    `trigram`: build single-pass trigram guidance tables (see
    _trigram_tables — the `HTKLVRec/HLVRec-LM.c` role) so the pass-1
    cross-word step scores each word end under its best predecessor's
    trigram context. Forces the factored form (the guidance leg rides
    the factored top-A cross-word step). No-op for bigram LMs."""
    if trigram and lm is not None and lm.order >= 3:
        factored = True  # guidance rides the factored cross-word step
    else:
        trigram = False
    if factored is None:
        n_rows = sum(len(vocab.get(w).prons) if vocab.get(w) else 1
                     for w in words) + (2 if start_word else 0)
        factored = lm is not None and n_rows > FACTORED_THRESHOLD
    factored = bool(factored) and lm is not None
    boundary = start_word is not None or end_word is not None
    i_s = i_e = None
    w_trans = None
    if boundary:
        if lm is None or start_word is None or end_word is None:
            HError(8624, "compile_lv_loop: start_word/end_word need an LM "
                         "and must be given together")
        core = list(words)
        words = [start_word] + core + [end_word]
        i_s, i_e = 0, len(words) - 1
        if not factored:
            w_trans, _ws, _we = lm_loop_matrices(words, lm, sent_start,
                                                 sent_end)
            w_trans[:, i_s] = LZERO  # nothing re-enters <s>
            w_trans[i_e, :] = LZERO  # nothing leaves </s>
        w_start = np.full(len(words), LZERO)
        w_start[i_s] = 0.0  # paths must start in <s>'s silence models
        w_end = np.full(len(words), LZERO)
        w_end[i_e] = 0.0  # ... and end in </s>'s
    elif lm is not None:
        if factored:
            w_start, w_end = _start_end_vectors(words, lm, sent_start,
                                                sent_end)
        else:
            w_trans, w_start, w_end = lm_loop_matrices(
                words, lm, sent_start, sent_end)
    else:
        W = len(words)
        w_trans = np.zeros((W, W), np.float64)
        w_start = np.zeros(W, np.float64)
        w_end = np.zeros(W, np.float64)

    # rows: one per (word, pron)
    chains = []
    row_word: List[int] = []
    row_out: List[Optional[str]] = []
    row_pron_prob: List[float] = []
    node_words: List[str] = []
    for wi, w in enumerate(words):
        wd = vocab.get(w)
        if wd is None:
            HError(8621, "compile_lv_loop: word %s not in dictionary", w)
        for p in wd.prons:
            phones = phone_map(list(p.phones)) if phone_map else list(p.phones)
            try:
                ids = [comp.model_id(ph) for ph in phones]
            except Exception:
                HError(8622, "compile_lv_loop: missing model for %s (%s)",
                       w, " ".join(phones))
            chains.append(build_composite(comp, ids))
            row_word.append(wi)
            row_out.append(p.out_sym)
            node_words.append(w)
            row_pron_prob.append(float(np.log(max(p.prob, 1e-30))))
    C = len(chains)
    row_word_np = np.asarray(row_word, np.int32)

    S = max(ch.n_states for ch in chains)
    S = ((S + pad_multiple - 1) // pad_multiple) * pad_multiple
    Ns = C * S

    comp_state = np.zeros((C, S), np.int32)
    a0 = np.full((C, S), LZERO, np.float32)
    aE = np.full((C, S), LZERO, np.float32)
    K = 1
    for ch in chains:
        la = ch.logA
        q = la.shape[0]
        iu, ju = np.nonzero(la > LSMALL)
        if np.any(ju < iu):
            HError(8623, "compile_lv_loop: backward within-word "
                         "transitions not supported in decode")
        if len(ju):
            K = max(K, int(np.max(ju - iu)) + 1)
    band = np.full((K, C, S), LZERO, np.float32)
    for c, ch in enumerate(chains):
        q = ch.n_states
        comp_state[c, :q] = ch.comp_state
        a0[c, :q] = ch.a0
        aE[c, :q] = ch.aE
        la = ch.logA
        for k in range(K):
            jj = np.arange(k, q)
            band[k, c, jj] = la[jj - k, jj]

    # expand word-level matrices to rows
    start_entry = w_start[row_word_np]
    end_exit = w_end[row_word_np]
    xw = None
    xw3 = None
    if factored:
        # the dense (C, C) matrix is never materialised — the factored
        # tables carry the same information in O(#bigrams)
        trans = np.zeros((0, 0), np.float64)
        xw = _factored_rows(words, lm, row_word, i_s, i_e)
        if trigram:
            xw3 = _trigram_tables(list(words), lm, row_word, i_s, i_e,
                                  sent_start)
    else:
        trans = w_trans[row_word_np[:, None], row_word_np[None, :]]

    return DecodeNetwork(
        comp_state=comp_state.reshape(-1),
        band=band.reshape(K, Ns),
        a0=a0.reshape(-1),
        aE=aE.reshape(-1),
        chain_of=np.repeat(np.arange(C, dtype=np.int32), S),
        node_of_chain=np.arange(C, dtype=np.int32),
        chain_pron_prob=np.asarray(row_pron_prob, np.float32),
        node_words=node_words,
        node_out=row_out,
        trans=trans.astype(np.float32),
        start_entry=start_entry.astype(np.float32),
        end_exit=end_exit.astype(np.float32),
        n_states=Ns,
        n_chains=C,
        n_nodes=C,
        uniform_width=S,
        xw_backoff=xw,
        xw_trigram=xw3,
    )
