"""Word-network Viterbi decoding (the HRec token-passing core).

Replaces `HTKLib/HRec.c : ProcessObservation()`'s per-token pointer work
with a dense per-frame update over the whole network (SURVEY.md §2.5):

  1. word-end scores   WE[i]   = segment-max of (v + aE) per word node
  2. cross-word step   entry[j] = max_i WE[i] + s*lm[i,j] + p   (max-plus
     matvec over the epsilon-closed node matrix; s = LM scale, p = word
     insertion penalty)
  3. within-word step  K shifted adds over the banded transition matrix
  4. combine + emit    v'[s] = max(within, entry) + outp[t, s]

Word-link records (HRec's RelToken paths) are two int32 planes (entry
node, entry time) carried with the scores; per-frame word-end snapshots
(T, Nn) stream out of the scan and host code walks them backwards for the
1-best transcription (and lattice arcs, later).

Observation likelihoods come from one batched OutP over *physical* states
(ops/outp.py) — the HLVModel flattening: network states just gather rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.hmmset import CompiledHMMSet
from ..ops.outp import all_state_outp
from ..utils.errors import HError, HRError
from ..utils.logmath import LZERO, LSMALL

from .net import DecodeNetwork

# word-link record packing: one uint32 per state, (wn+1) << REC_TBITS | t
REC_TBITS = 15
REC_TMASK = (1 << REC_TBITS) - 1          # max frame index (32767)

# per-network LRU bound on (CompiledHMMSet, jitted pipeline) pairs —
# train-decode loops recompile the set each iteration
_COMP_CACHE_MAX = 4
REC_MAXROWS = (1 << (32 - REC_TBITS)) - 2  # max (word, pron) rows (131k)


@dataclass
class DecodeResult:
    words: List[str]  # output word sequence (suppressed symbols removed)
    word_nodes: List[int]  # node index per word
    times: List[Tuple[int, int]]  # (start_frame, end_frame) inclusive
    score: float  # total log likelihood (acoustic + scaled LM)
    scores: List[float]  # per-word segment scores


_BEAM_OFF = 1e30  # genBeam "off": never binds (scores live above LZERO)


def _shift_down(x, k, fill):
    """y[s] = x[s-k] with fill for s < k."""
    if k == 0:
        return x
    return jnp.concatenate([jnp.full((k,), fill, x.dtype), x[:-k]])


def decode_scan(
    outp_states,  # (T, Ns) per-network-state log b(o_t)
    band,  # (K, Ns)
    a0,  # (Ns,)
    aE,  # (Ns,)
    node_of_state,  # (Ns,)
    entry_bonus,  # (Ns,) pron prob per state's chain (added at entry)
    trans,  # (Nn, Nn) scaled closed LM matrix
    start_entry,  # (Nn,)
    word_pen: float,
    n_nodes: int,
):
    """Per-frame token-passing update as dense vector ops.

    Word-end reductions run as masked dense max/argmax over the (Nn, Ns)
    node-membership mask, and within-word record propagation selects
    among K shifted copies instead of gathering by source index.
    """
    T, Ns = outp_states.shape
    K = band.shape[0]
    Nn = n_nodes
    # static node-membership mask and per-state entry gather matrix
    node_mask = node_of_state[None, :] == jnp.arange(Nn, dtype=jnp.int32)[:, None]
    neg = jnp.asarray(LZERO, outp_states.dtype)

    def step(carry, inp):
        v, wn, wt = carry
        outp_t, t = inp

        # 1. word-end scores per node: masked dense max over states
        e_state = v + aE  # (Ns,)
        masked = jnp.where(node_mask, e_state[None, :], neg)  # (Nn, Ns)
        WE = jnp.max(masked, axis=1)
        best_sid = jnp.argmax(masked, axis=1)  # (Nn,) first max on ties
        ok = WE > LSMALL
        pwn = jnp.where(ok, wn[best_sid], -1)
        pwt = jnp.where(ok, wt[best_sid], -1)

        # 2. cross-word max-plus matvec (+ start entry at t=0)
        cand = WE[:, None] + trans  # (Nn_from, Nn_to)
        entry_n = jnp.max(cand, axis=0) + word_pen
        an = jnp.argmax(cand, axis=0).astype(jnp.int32)
        entry_n = jnp.where(t == 0, start_entry, entry_n)
        an = jnp.where(t == 0, -1, an)

        entry_s = entry_n[node_of_state] + a0 + entry_bonus  # (Ns,) static gather

        # 3. within-word banded update; records select among shifted copies
        cands = jnp.stack(
            [_shift_down(v, k, LZERO) + band[k] for k in range(K)], axis=0
        )  # (K, Ns)
        within = jnp.max(cands, axis=0)
        argk = jnp.argmax(cands, axis=0).astype(jnp.int32)
        wwn = jnp.full_like(wn, -1)
        wwt = jnp.full_like(wt, -1)
        for k in range(K):
            sel = argk == k
            wwn = jnp.where(sel, _shift_down(wn, k, -1), wwn)
            wwt = jnp.where(sel, _shift_down(wt, k, -1), wwt)

        # 4. combine
        use_entry = entry_s > within
        new_v = jnp.maximum(within, entry_s) + outp_t
        new_wn = jnp.where(use_entry, an[node_of_state], wwn)
        new_wt = jnp.where(use_entry, t - 1, wwt)
        # dead tokens carry no history
        dead = new_v <= LSMALL
        new_wn = jnp.where(dead, -1, new_wn)
        new_wt = jnp.where(dead, -1, new_wt)

        return (new_v, new_wn, new_wt), (WE, pwn, pwt)

    init = (
        jnp.full((Ns,), LZERO, outp_states.dtype),
        jnp.full((Ns,), -1, jnp.int32),
        jnp.full((Ns,), -1, jnp.int32),
    )
    (v, wn, wt), (WEs, pwns, pwts) = jax.lax.scan(
        step, init, (outp_states, jnp.arange(T))
    )
    return (v, wn, wt), (WEs, pwns, pwts)


def decode_scan_uniform(
    outp_states,  # (T, Ns) with Ns = C * S (uniform padded rows)
    band,  # (K, Ns)
    a0,  # (Ns,)
    aE,  # (Ns,)
    S: int,  # uniform chain width
    entry_bonus_row,  # (C,) log pron prob per row
    trans,  # (C, C) scaled LM matrix (rows = nodes = chains)
    start_entry,  # (C,)
    word_pen,
    beam=1e30,
    max_active: Optional[int] = None,
    xw: Optional[dict] = None,
):
    """Uniform-width token-passing update (the HLVRec-scale path).

    Same recursion as decode_scan but for lvnet.py networks where every
    chain is padded to S states and node == chain: the word-end
    reduction is a reshape + row max (the (Nn, Ns) node mask of the
    general path is the scaling wall: 1.4 G elements at 5k words), word
    entry is a row broadcast, and record selection uses a one-hot mask —
    no gathers anywhere.

    `beam`: HRec genBeam — states scoring below (best - beam) die each
    frame; may be a traced scalar (1e30 = off, same jaxpr either way).
    `max_active`: HLVRec histogram/maxModel pruning — only the top
    `max_active` word-end rows propagate across words this frame (exact
    whenever it covers every live word end, tested). lm_scale/word_pen/
    beam are traced so one compiled program serves all values.

    `xw`: factored cross-word tables (net.xw_backoff, already LM-scaled)
    — replaces the dense matvec/top-k with the back-off leg
    max_i(WE+bow)+uni plus an explicit-bigram leg. In this single-
    utterance scan the explicit leg is always the exact bucketed gather
    (O(#bigrams)/frame, `max_active` ignored); the batched step
    additionally supports top-A histogram pruning of the explicit leg
    (see _make_uniform_step). Both the factored and dense paths
    implement back-off-NETWORK semantics — max(explicit bigram,
    bow + uni) — so they agree bit-for-bit (see lm_loop_matrices).
    """
    T, Ns = outp_states.shape
    C = Ns // S
    K = band.shape[0]
    max_active, _adaptive = _topa_mode(max_active)
    if _adaptive:
        HError(8526, "adaptive-exact top-A (negative max_active) is a "
                     "batched-path feature — use decode()/decode_batch()")
    if C >= REC_MAXROWS or T > REC_TMASK:
        HError(8520, "decode_scan_uniform: %d rows / %d frames exceed the "
                     "packed-record range (%d rows, %d frames — chunk "
                     "longer audio)", C, T, REC_MAXROWS, REC_TMASK)
    neg = jnp.asarray(LZERO, outp_states.dtype)
    col = jnp.arange(S, dtype=jnp.int32)[None, :]
    # (wn, wt) word-link records ride ONE uint32 per state:
    # code = (wn+1) << REC_TBITS | t; 0 = no record (wn = wt = -1).
    # Halves record-propagation traffic, which profiles as the second
    # biggest step cost after the cross-word matvec at LV sizes. 15 bits
    # of t leave 17 for rows: 131k (word, pron) rows — 64k-vocab LVCSR
    # with pronunciation variants fits.

    def step(carry, inp):
        v, rec = carry
        outp_t, t = inp

        # 1. word-end scores: row max over the padded width
        ev = (v + aE).reshape(C, S)
        WE = jnp.max(ev, axis=1)
        best_s = jnp.argmax(ev, axis=1)
        onehot = best_s[:, None] == col
        ok = WE > LSMALL
        prec = jnp.max(jnp.where(onehot, rec.reshape(C, S), 0), axis=1)
        prec = jnp.where(ok, prec, 0)
        pwn = (prec >> REC_TBITS).astype(jnp.int32) - 1
        pwt = (prec & REC_TMASK).astype(jnp.int32) - 1

        # 2. cross-word max-plus: factored back-off form when available,
        # else dense matvec (optionally top-A pruned)
        if xw is not None:
            bo = WE + xw["bow"]
            bo_best = jnp.max(bo)
            bo_arg = jnp.argmax(bo).astype(jnp.int32)
            entry_n = bo_best + xw["uni"]
            an = jnp.full((C,), bo_arg, jnp.int32)
            if xw["buckets"]:  # an LM can carry zero explicit bigrams
                exp_v, exp_a = bucket_leg(WE[None], xw["buckets"],
                                          xw["inv"])
                exp_v, exp_a = exp_v[0], exp_a[0]
                take = exp_v > entry_n
                entry_n = jnp.maximum(entry_n, exp_v)
                an = jnp.where(take, exp_a, an)
            entry_n = entry_n + word_pen
        elif max_active is not None and max_active < C:
            vals, idxs = jax.lax.top_k(WE, max_active)
            rows = trans[idxs]  # (A, C) contiguous row gather
            cand = vals[:, None] + rows
            entry_n = jnp.max(cand, axis=0) + word_pen
            an = idxs[jnp.argmax(cand, axis=0)].astype(jnp.int32)
        else:
            cand = WE[:, None] + trans
            entry_n = jnp.max(cand, axis=0) + word_pen
            an = jnp.argmax(cand, axis=0).astype(jnp.int32)
        entry_n = jnp.where(t == 0, start_entry, entry_n)
        # entry record: (an, t-1) -> code (an+1) << REC_TBITS | t;
        # t==0 entries carry (-1, -1) = code 0
        entry_rec = jnp.where(
            t == 0, 0,
            ((an + 1).astype(jnp.uint32) << REC_TBITS)
            | t.astype(jnp.uint32)).astype(jnp.uint32)

        entry_s = (entry_n + entry_bonus_row)[:, None]  # (C, 1) row bcast
        entry_flat = (entry_s + a0.reshape(C, S)).reshape(Ns)
        erec_flat = jnp.broadcast_to(entry_rec[:, None], (C, S)).reshape(Ns)

        # 3. within-word banded update (band masks row boundaries);
        # incremental max keeps first-shift ties like argmax-first did
        within = v + band[0]
        wrec = rec
        for k in range(1, K):
            ck = _shift_down(v, k, LZERO) + band[k]
            take = ck > within
            within = jnp.where(take, ck, within)
            wrec = jnp.where(take, _shift_down(rec, k, 0), wrec)

        # 4. combine + prune
        use_entry = entry_flat > within
        new_v = jnp.maximum(within, entry_flat) + outp_t
        new_v = jnp.where(new_v < jnp.max(new_v) - beam, neg, new_v)
        new_rec = jnp.where(use_entry, erec_flat, wrec)
        new_rec = jnp.where(new_v <= LSMALL, 0, new_rec)

        return (new_v, new_rec), (WE, pwn, pwt)

    init = (
        jnp.full((Ns,), LZERO, outp_states.dtype),
        jnp.zeros((Ns,), jnp.uint32),
    )
    (v, rec), (WEs, pwns, pwts) = jax.lax.scan(
        step, init, (outp_states, jnp.arange(T))
    )
    # unpack the final carry back to the (v, wn, wt) interface
    wn = (rec >> REC_TBITS).astype(jnp.int32) - 1
    wt = (rec & REC_TMASK).astype(jnp.int32) - 1
    return (v, wn, wt), (WEs, pwns, pwts)


def bucket_leg(WE, buckets, inv):
    """Exact explicit-bigram cross-word leg over the in-degree buckets
    of lvnet._factored_rows: per target row j, the max over its
    predecessors i of WE[:, i] + score(i, j), and the winning i (first
    slot on ties). WE is (B, C); returns ((B, C) values, (B, C) rows).

    max + argmax fuse over ONE pass of each bucket's candidates; the
    winning source comes from the static preds table with a (B, Cb)
    gather, not a second slot-sized gather."""
    parts_v, parts_a = [], []
    for preds, scores in buckets:
        cand = WE[:, preds] + scores[None]  # (B, Cb, Fb)
        parts_v.append(jnp.max(cand, axis=2))
        k = jnp.argmax(cand, axis=2)
        parts_a.append(preds[jnp.arange(preds.shape[0])[None], k])
    return (jnp.concatenate(parts_v, axis=1)[:, inv],
            jnp.concatenate(parts_a, axis=1)[:, inv])


def _topa_mode(max_active):
    """Decode the max_active encoding.

    n > 0: top-A histogram pruning (HLVRec maxModel semantics).
    n < 0: ADAPTIVE-EXACT top-A — |n| sources drive the explicit leg
    plus a per-frame soundness certificate (an excluded source i can
    win some target j only if WE[i] + marg[i] > bo_best, marg static —
    see lvnet._factored_rows); frames where the certificate trips
    recompute the explicit leg exactly via the bucket gather under
    lax.cond. Scores are bit-identical to the exact decode on every
    frame; records can differ only on exact f32 score ties (the two
    legs' tie rules differ).
    Returns (A, adaptive)."""
    if max_active is None:
        return None, False
    return abs(int(max_active)), max_active < 0


def _shift_down_b(x, k, fill):
    """Batched _shift_down along axis 1: y[:, s] = x[:, s-k]."""
    if k == 0:
        return x
    B = x.shape[0]
    return jnp.concatenate(
        [jnp.full((B, k), fill, x.dtype), x[:, :-k]], axis=1)


def decode_scan_uniform_batch(
    outp_states,  # (B, T, Ns)
    band, a0, aE,
    S: int,
    entry_bonus_row,  # (C,)
    trans,  # (C, C) scaled, or (0, 0) when xw is given
    start_entry,  # (C,)
    word_pen,
    beam=1e30,
    max_active: Optional[int] = None,
    xw: Optional[dict] = None,
    xw3: Optional[dict] = None,
):
    """Batched uniform-row scan — same recursion as decode_scan_uniform
    but with the batch INSIDE the step, so each cross-word form (dense
    max-plus matvec, factored back-off `xw`, explicit top-A
    `max_active`) runs as one batched op per frame.

    `xw3`: single-pass trigram guidance tables (net.xw_trigram, scaled)
    — replaces the cross-word step with the trigram-context form (see
    _make_uniform_step). Batched-path only.
    """
    B, T, Ns = outp_states.shape
    step = _make_uniform_step(
        B, Ns, band, a0, aE, S, entry_bonus_row, trans, start_entry,
        word_pen, beam, max_active, xw, xw3)
    if T > REC_TMASK:
        HError(8520, "decode_scan_uniform_batch: %d frames exceed the "
                     "packed-record range (%d — chunk longer audio)",
               T, REC_TMASK)

    def body(carry, t):
        outp_t = jax.lax.dynamic_index_in_dim(
            outp_states, t, axis=1, keepdims=False)
        return step(carry, outp_t, t)

    init = (
        jnp.full((B, Ns), LZERO, outp_states.dtype),
        jnp.zeros((B, Ns), jnp.uint32),
    )
    (v, rec), (WEs, pwns, pwts) = jax.lax.scan(body, init, jnp.arange(T))
    wn = (rec >> REC_TBITS).astype(jnp.int32) - 1
    wt = (rec & REC_TMASK).astype(jnp.int32) - 1
    # match vmap(decode_scan_uniform) output layout: records (B, T, C)
    return (v, wn, wt), (jnp.swapaxes(WEs, 0, 1),
                         jnp.swapaxes(pwns, 0, 1),
                         jnp.swapaxes(pwts, 0, 1))


def _make_uniform_step(B, Ns, band, a0, aE, S, entry_bonus_row, trans,
                       start_entry, word_pen, beam, max_active, xw,
                       xw3=None):
    """The batched per-frame update as step(carry, outp_t, t).

    With `xw3` (single-pass trigram guidance, the `HTKLVRec/HLVRec-LM.c`
    role): the whole cross-word step runs over the top-A word-end set,
    each source row i scored under its own token's trigram context
    u_i = word(pwn_i) — the predecessor row its entry record already
    carries. entry[j] = max_i WE_i + max(s*tri(u_i, v_i, j),
    s*tribow(u_i, v_i) + bigram legs). This is the word-pair
    approximation (one LM context per row — the Viterbi-best one), not
    HLVRec's exact LM-state token sets; it is exact vs the same
    recursion unpruned whenever A covers every live word end, and its
    purpose is to make the pass-1 beam protect trigram-best hypotheses
    (the measured genBeam search-error knee collapses)."""
    C = Ns // S
    K = band.shape[0]
    max_active, adaptive = _topa_mode(max_active)
    if C >= REC_MAXROWS:
        HError(8520, "decode_scan_uniform_batch: %d rows exceed the "
                     "packed-record range (%d)", C, REC_MAXROWS)
    if adaptive and (xw is None or xw3 is not None
                     or xw.get("succ_j") is None or not xw["buckets"]
                     or xw.get("marg") is None):
        HError(8526, "adaptive-exact top-A needs the factored cross-word "
                     "tables with successor tables and buckets (and is "
                     "not combined with trigram guidance, which is "
                     "already a top-A semantic)")
    if xw3 is not None:
        if xw is None:
            HError(8526, "trigram guidance needs the factored cross-word "
                         "tables (compile_lv_loop(factored=True))")
        if (xw.get("succ_j") is None and max_active is not None
                and max_active < C):
            HError(8526, "trigram guidance with top-A pruning needs the "
                         "bigram successor tables (out-degree too skewed "
                         "at this vocabulary) — decode without -u or "
                         "disable HDECODE: TRIGUIDE")
    neg = jnp.asarray(LZERO, jnp.float32)
    col = jnp.arange(S, dtype=jnp.int32)[None, None, :]
    a0_r = a0.reshape(C, S)[None]

    def step(carry, outp_t, t):
        v, rec = carry  # (B, Ns)
        ev = (v + aE[None]).reshape(B, C, S)
        WE = jnp.max(ev, axis=2)  # (B, C)
        best_s = jnp.argmax(ev, axis=2)
        onehot = best_s[..., None] == col
        ok = WE > LSMALL
        prec = jnp.max(jnp.where(onehot, rec.reshape(B, C, S), 0), axis=2)
        prec = jnp.where(ok, prec, 0)
        pwn = (prec >> REC_TBITS).astype(jnp.int32) - 1
        pwt = (prec & REC_TMASK).astype(jnp.int32) - 1

        if xw3 is not None and xw is not None:
            # single-pass trigram guidance: everything below runs over
            # the top-A word-end set (A = C when max_active is off)
            if max_active is not None and max_active < C:
                vals, idxs = jax.lax.top_k(WE, max_active)  # (B, A)
                uA = jnp.take_along_axis(pwn, idxs, axis=1)
            else:
                idxs = jnp.broadcast_to(
                    jnp.arange(C, dtype=jnp.int32)[None], (B, C))
                vals = WE
                uA = pwn
            uw = xw3["ctx_word"][jnp.where(uA >= 0, uA, C)]  # (B, A)
            # lower-bound search for the (u, v) context: pairs are
            # sorted (v_row asc, u_word asc), so each lane's segment
            # base seg_start[row] is static and only u varies — a short
            # int32 binary search, no 64-bit pair keys
            P = xw3["pair_u"].shape[0]
            lo = xw3["seg_start"][idxs]
            hi0 = xw3["seg_start"][idxs + 1]
            hi = hi0
            for _ in range(xw3["iters"]):
                mid = (lo + hi) >> 1
                mu = xw3["pair_u"][jnp.minimum(mid, P - 1)]
                go = (mid < hi) & (mu < uw)
                lo = jnp.where(go, mid + 1, lo)
                hi = jnp.where(go | (mid >= hi), hi, mid)
            loc = jnp.minimum(lo, P - 1)
            hit = (lo < hi0) & (xw3["pair_u"][loc] == uw)
            tb = jnp.where(hit, xw3["pair_bow"][loc], 0.0)
            vb = vals + tb  # word-end mass through the trigram back-off
            # back-off-to-unigram leg
            bo = vb + xw["bow"][idxs]
            kbo = jnp.argmax(bo, axis=1)
            bo_best = jnp.take_along_axis(bo, kbo[:, None], axis=1)
            entry_n = bo_best + xw["uni"][None]
            bo_arg = jnp.take_along_axis(idxs, kbo[:, None], axis=1)
            an = jnp.broadcast_to(bo_arg, (B, C))
            bidx = jnp.arange(B)[:, None, None]
            # explicit-bigram leg (successor tables over the A set)
            if xw.get("succ_j") is not None:
                sj = xw["succ_j"][idxs]  # (B, A, O) row gather
                sp = xw["succ_p"][idxs]
                cand = vb[..., None] + sp
                ex = jnp.full((B, C + 1), 2.0 * LZERO, jnp.float32)
                ex = ex.at[bidx, sj].max(cand, mode="promise_in_bounds")
                exg = ex[bidx, sj]
                src_rows = jnp.broadcast_to(idxs[..., None], cand.shape)
                win_src = jnp.where(cand >= exg, src_rows, -1)
                anx = jnp.full((B, C + 1), -1, jnp.int32)
                anx = anx.at[bidx, sj].max(win_src,
                                           mode="promise_in_bounds")
                take = ex[:, :C] > entry_n
                entry_n = jnp.maximum(entry_n, ex[:, :C])
                an = jnp.where(take, anx[:, :C], an)
            elif idxs.shape[1] == C and xw["buckets"]:
                # exact mode without succ tables: vb is row-aligned, so
                # the per-target bucket gather applies unchanged
                exp_v, exp_a = bucket_leg(vb, xw["buckets"], xw["inv"])
                take = exp_v > entry_n
                entry_n = jnp.maximum(entry_n, exp_v)
                an = jnp.where(take, exp_a, an)
            # explicit-trigram leg (pair-major CSR gather, raw vals)
            if xw3["o3max"]:
                st = jnp.where(hit, xw3["pair_tstart"][loc], 0)
                cn = jnp.where(hit, xw3["pair_tcnt"][loc], 0)
                sl = jnp.arange(xw3["o3max"], dtype=jnp.int32)[None, None]
                valid = sl < cn[..., None]
                oc = jnp.where(valid, st[..., None] + sl, 0)
                tjg = jnp.where(valid, xw3["tri_j"][oc], C)
                tpg = jnp.where(valid, xw3["tri_p"][oc], 2.0 * LZERO)
                cand3 = vals[..., None] + tpg  # (B, A, O3)
                ex3 = jnp.full((B, C + 1), 2.0 * LZERO, jnp.float32)
                ex3 = ex3.at[bidx, tjg].max(cand3,
                                            mode="promise_in_bounds")
                exg3 = ex3[bidx, tjg]
                src3 = jnp.broadcast_to(idxs[..., None], cand3.shape)
                win3 = jnp.where(cand3 >= exg3, src3, -1)
                an3 = jnp.full((B, C + 1), -1, jnp.int32)
                an3 = an3.at[bidx, tjg].max(win3,
                                            mode="promise_in_bounds")
                take3 = ex3[:, :C] > entry_n
                entry_n = jnp.maximum(entry_n, ex3[:, :C])
                an = jnp.where(take3, an3[:, :C], an)
            entry_n = entry_n + word_pen
        elif xw is not None:
            bo = WE + xw["bow"][None]
            bo_best = jnp.max(bo, axis=1)  # (B,)
            bo_arg = jnp.argmax(bo, axis=1).astype(jnp.int32)
            entry_n = bo_best[:, None] + xw["uni"][None]
            an = jnp.broadcast_to(bo_arg[:, None], (B, C))
            use_topa = (max_active is not None and max_active < C
                        and xw.get("succ_j") is not None)
            if use_topa:
                # HLVRec histogram/maxModel pruning on the factored
                # explicit leg: only the top-A word ends propagate
                # explicit bigrams (the back-off leg stays exact over
                # ALL sources, so this is never worse than the dense
                # top-A form). The per-target gather leg costs
                # O(#bigrams) serialised gathers; this costs A
                # successor-row gathers + an A*O_max scatter-max.
                A = max_active
                vals, idxs = jax.lax.top_k(WE, A)  # (B, A)
                sj = xw["succ_j"][idxs]  # (B, A, O) row gather
                sp = xw["succ_p"][idxs]
                cand = vals[..., None] + sp  # (B, A, O); pads ~2*LZERO
                bidx = jnp.arange(B)[:, None, None]
                ex = jnp.full((B, C + 1), 2.0 * LZERO, jnp.float32)
                ex = ex.at[bidx, sj].max(cand, mode="promise_in_bounds")
                exp_v = ex[:, :C]
                # winning source: scatter the source row wherever its
                # candidate equals the target's max (f32 ties: highest
                # source row wins — tie order differs from the bucket
                # leg's first-slot rule, which only matters on exact
                # score ties)
                exg = ex[bidx, sj]
                src_rows = jnp.broadcast_to(idxs[..., None], cand.shape)
                win_src = jnp.where(cand >= exg, src_rows, -1)
                anx = jnp.full((B, C + 1), -1, jnp.int32)
                anx = anx.at[bidx, sj].max(win_src, mode="promise_in_bounds")
                an_x = anx[:, :C]
                if adaptive:
                    # soundness certificate: an excluded source i can
                    # win some target j over the back-off floor
                    # bo_best + uni[j] only if WE[i] + marg[i] >
                    # bo_best (marg static, lvnet._factored_rows).
                    # Frames where that trips recompute the explicit
                    # leg exactly (bucket gather) under lax.cond —
                    # exact scores every frame, top-A cost on the rest.
                    ex_m = WE + xw["marg"][None]
                    ex_m = ex_m.at[jnp.arange(B)[:, None], idxs].set(
                        2.0 * LZERO, mode="promise_in_bounds")
                    safe = jnp.all(jnp.max(ex_m, axis=1) <= bo_best)

                    def _fast(_):
                        return exp_v, an_x

                    def _slow(_):
                        return bucket_leg(WE, xw["buckets"], xw["inv"])

                    exp_v, an_x = jax.lax.cond(safe, _fast, _slow, None)
                take = exp_v > entry_n
                entry_n = jnp.maximum(entry_n, exp_v)
                an = jnp.where(take, an_x, an)
            elif xw["buckets"]:  # an LM can carry zero explicit bigrams
                exp_v, exp_a = bucket_leg(WE, xw["buckets"], xw["inv"])
                take = exp_v > entry_n
                entry_n = jnp.maximum(entry_n, exp_v)
                an = jnp.where(take, exp_a, an)
            entry_n = entry_n + word_pen
        elif max_active is not None and max_active < C:
            vals, idxs = jax.lax.top_k(WE, max_active)  # (B, A)
            rows = trans[idxs]  # (B, A, C)
            cand = vals[..., None] + rows
            entry_n = jnp.max(cand, axis=1) + word_pen
            an = jnp.take_along_axis(
                idxs, jnp.argmax(cand, axis=1), axis=1).astype(jnp.int32)
        else:
            cand = WE[:, :, None] + trans[None]
            entry_n = jnp.max(cand, axis=1) + word_pen
            an = jnp.argmax(cand, axis=1).astype(jnp.int32)

        entry_n = jnp.where(t == 0, start_entry[None], entry_n)
        entry_rec = jnp.where(
            t == 0, 0,
            ((an + 1).astype(jnp.uint32) << REC_TBITS)
            | t.astype(jnp.uint32)).astype(jnp.uint32)
        entry_flat = ((entry_n + entry_bonus_row[None])[..., None]
                      + a0_r).reshape(B, Ns)
        erec_flat = jnp.broadcast_to(
            entry_rec[..., None], (B, C, S)).reshape(B, Ns)

        within = v + band[0][None]
        wrec = rec
        for k in range(1, K):
            ck = _shift_down_b(v, k, LZERO) + band[k][None]
            take = ck > within
            within = jnp.where(take, ck, within)
            wrec = jnp.where(take, _shift_down_b(rec, k, 0), wrec)

        use_entry = entry_flat > within
        new_v = jnp.maximum(within, entry_flat) + outp_t
        new_v = jnp.where(
            new_v < jnp.max(new_v, axis=1, keepdims=True) - beam, neg, new_v)
        new_rec = jnp.where(use_entry, erec_flat, wrec)
        new_rec = jnp.where(new_v <= LSMALL, 0, new_rec)
        return (new_v, new_rec), (WE, pwn, pwt)

    return step


def _net_dev(net: DecodeNetwork) -> dict:
    """Per-network device-array cache.

    Re-uploading the static network every call is waste (a 5k-word
    trans matrix is 121 MB). Arrays are pushed once and the jitted
    callables built against them are cached alongside.
    """
    d = getattr(net, "_dev_cache", None)
    if d is None:
        d = {
            "band": jnp.asarray(net.band),
            "a0": jnp.asarray(net.a0),
            "aE": jnp.asarray(net.aE),
            "trans": jnp.asarray(net.trans),
            "start": jnp.asarray(net.start_entry),
            "bonus": jnp.asarray(net.chain_pron_prob),
            "node_of_state": jnp.asarray(net.node_of_chain[net.chain_of]),
            "entry_bonus": jnp.asarray(
                net.chain_pron_prob[net.chain_of]),
            "comp_state": jnp.asarray(net.comp_state),
            "end_exit": jnp.asarray(net.end_exit),
            "jits": {},
        }
        if net.xw_backoff is not None:
            x = net.xw_backoff
            d["xw"] = {
                "bow": jnp.asarray(x["bow"]),
                "uni": jnp.asarray(x["uni"]),
                "buckets": [(jnp.asarray(p), jnp.asarray(s))
                            for p, s in x["buckets"]],
                "inv": jnp.asarray(x["inv"]),
                "succ_j": (jnp.asarray(x["succ_j"])
                           if x.get("succ_j") is not None else None),
                "succ_p": (jnp.asarray(x["succ_p"])
                           if x.get("succ_p") is not None else None),
                "marg": (jnp.asarray(x["marg"])
                         if x.get("marg") is not None else None),
            }
        if getattr(net, "xw_trigram", None) is not None:
            x3 = net.xw_trigram
            d["xw3"] = {
                k: jnp.asarray(x3[k])
                for k in ("pair_u", "pair_bow", "pair_tstart",
                          "pair_tcnt", "seg_start", "tri_j", "tri_p",
                          "ctx_word")
            }
            d["xw3"]["o3max"] = x3["o3max"]
            d["xw3"]["iters"] = x3["iters"]
        net._dev_cache = d
    return d


def _scale_xw3(x3, lm_scale):
    """LM-scale the trigram guidance tables (traced)."""
    if x3 is None:
        return None
    out = dict(x3)
    out["pair_bow"] = x3["pair_bow"] * lm_scale
    out["tri_p"] = x3["tri_p"] * lm_scale
    return out


def _scale_xw(xw_d, lm_scale):
    """LM-scale the factored cross-word tables (traced)."""
    if xw_d is None:
        return None
    return {
        "bow": xw_d["bow"] * lm_scale,
        "uni": xw_d["uni"] * lm_scale,
        "buckets": [(p, s * lm_scale) for p, s in xw_d["buckets"]],
        "inv": xw_d["inv"],
        "succ_j": xw_d.get("succ_j"),
        "succ_p": (xw_d["succ_p"] * lm_scale
                   if xw_d.get("succ_p") is not None else None),
        "marg": (xw_d["marg"] * lm_scale
                 if xw_d.get("marg") is not None else None),
    }


def run_decode_batch(
    outp_states,  # (B, T, Ns)
    net: DecodeNetwork,
    lm_scale: float,
    word_pen: float,
    beam: Optional[float] = None,
    max_active: Optional[int] = None,
):
    """Dispatch the decode recursion: the uniform-row scan for lvnet
    networks, decode_scan for general networks."""
    d = _net_dev(net)
    if net.uniform_width:
        key = ("scan", max_active)
        fn = d["jits"].get(key)
        if fn is None:
            S = net.uniform_width
            xw_d = d.get("xw")

            xw3_d = d.get("xw3")

            def scan_all(outp, lm_scale_, word_pen_, beam_):
                xw_s = _scale_xw(xw_d, lm_scale_)
                return decode_scan_uniform_batch(
                    outp, d["band"], d["a0"], d["aE"], S, d["bonus"],
                    d["trans"] * lm_scale_, d["start"] * lm_scale_,
                    word_pen_, beam_, max_active, xw=xw_s,
                    xw3=_scale_xw3(xw3_d, lm_scale_),
                )

            fn = jax.jit(scan_all)
            d["jits"][key] = fn
        return fn(outp_states, float(lm_scale), float(word_pen),
                  _BEAM_OFF if beam is None else float(beam))
    # per-node word-insertion penalty: interior-sharing sub-word hops
    # (head->body->tail) are word transitions to the scan but must not
    # collect -p again (see net.py share_interiors)
    if net.node_wdpen is not None:
        wp = jnp.asarray(net.node_wdpen) * float(word_pen)
    else:
        wp = jnp.full((net.n_nodes,), float(word_pen), jnp.float32)
    fn = d["jits"].get("generic")
    if fn is None:
        def scan_all(outp, lm_scale_, wp_):
            return jax.vmap(lambda o: decode_scan(
                o, d["band"], d["a0"], d["aE"], d["node_of_state"],
                d["entry_bonus"], d["trans"] * lm_scale_,
                d["start"] * lm_scale_, wp_, net.n_nodes))(outp)

        fn = jax.jit(scan_all)
        d["jits"]["generic"] = fn
    return fn(outp_states, float(lm_scale), wp)


def _final_records(net, v, wn, wt):
    """Per-node word-end records from the final state vector."""
    nos = np.asarray(net.node_of_chain[net.chain_of])
    e_state = np.asarray(v) + np.asarray(net.aE)
    wn = np.asarray(wn)
    wt = np.asarray(wt)
    Nn = net.n_nodes
    WE_fin = np.full(Nn, LZERO, np.float64)
    pwn_fin = np.full(Nn, -1, np.int64)
    pwt_fin = np.full(Nn, -1, np.int64)
    for s in np.argsort(-e_state):
        i = nos[s]
        if e_state[s] > WE_fin[i]:
            WE_fin[i] = e_state[s]
            pwn_fin[i] = wn[s]
            pwt_fin[i] = wt[s]
    return WE_fin, pwn_fin, pwt_fin


def _finalize(net, WEs, pwns, pwts, WE_fin, pwn_fin, pwt_fin, T_real,
              lm_scale) -> Optional[DecodeResult]:
    """Pick the best complete path and walk the word-link records back."""
    final = WE_fin + np.asarray(net.end_exit, np.float64) * lm_scale
    i = int(np.argmax(final))
    if final[i] <= LSMALL:
        return None
    score = float(final[i])

    words_rev: List[Tuple[int, int, int]] = []  # (node, t_start, t_end)
    t = T_real - 1
    node = i
    pn, pt = int(pwn_fin[i]), int(pwt_fin[i])
    while True:
        words_rev.append((node, pt + 1, t))
        if pn < 0 or pt < 0:
            break
        node, t = pn, pt
        # records for end time t live in scan step t+1
        pn = int(pwns[t + 1, node])
        pt = int(pwts[t + 1, node])

    words_rev.reverse()
    return _result_from_chain(net, words_rev, score)


def _result_from_chain(net, words_fwd, score) -> DecodeResult:
    """(node, t_start, t_end) chain in forward order -> DecodeResult
    (shared by the plane walk and the batched record-chain walk)."""
    words, nodes, times, scores = [], [], [], []
    cont = net.node_cont
    pend_t0: Optional[int] = None  # head/body spans merge into the tail
    for node, t0, t1 in words_fwd:
        if cont is not None and cont[node]:
            if pend_t0 is None:
                pend_t0 = t0
            continue
        out = net.node_out[node]
        sym = net.node_words[node] if out is None else out
        if sym:
            words.append(sym)
            nodes.append(node)
            times.append((pend_t0 if pend_t0 is not None else t0, t1))
            scores.append(0.0)
        pend_t0 = None
    return DecodeResult(
        words=words, word_nodes=nodes, times=times, score=score, scores=scores
    )


import functools


@functools.partial(jax.jit, static_argnames=("S",))
def _traceback_device(vb, wnb, wtb, WEb, pwnb, pwtb, aE, end_exit_s,
                      t_reals, S: int):
    """Batched ON-DEVICE record walk for uniform-row nets.

    Shipping the (B, T, C) word-end planes to the host costs ~50 MB per
    batch at LV sizes — orders of magnitude more bytes than the answer.
    This walks the backpointers on device with a T-step scan (two scalar
    gathers per step) and returns (B, T) int32 planes: per-step
    (node, t_start, t_end) of the traceback in reverse order, -1 padded,
    plus the final path score. Mirrors _finalize()'s host walk exactly.
    """
    B, T, C = WEb.shape
    IMIN = jnp.iinfo(jnp.int32).min
    col = jnp.arange(S, dtype=jnp.int32)[None, :]

    def one(v, wn, wt, WEs, pwns, pwts, tr):
        # final records: plane row tr when tr < T (ends at tr-1 are
        # emitted by scan step tr), else computed from the final carry
        ev = (v + aE).reshape(C, S)
        WEl = jnp.max(ev, axis=1)
        best_s = jnp.argmax(ev, axis=1)
        onehot = best_s[:, None] == col
        okl = WEl > LSMALL
        pwnl = jnp.where(
            okl, jnp.max(jnp.where(onehot, wn.reshape(C, S), IMIN), axis=1),
            -1)
        pwtl = jnp.where(
            okl, jnp.max(jnp.where(onehot, wt.reshape(C, S), IMIN), axis=1),
            -1)
        use_last = tr >= T
        trc = jnp.clip(tr, 0, T - 1)
        WE_fin = jnp.where(use_last, WEl, WEs[trc])
        pwn_fin = jnp.where(use_last, pwnl, pwns[trc])
        pwt_fin = jnp.where(use_last, pwtl, pwts[trc])

        final = WE_fin + end_exit_s
        i0 = jnp.argmax(final).astype(jnp.int32)
        score = final[i0]
        ok = score > LSMALL

        def step(carry, _):
            node, t, pn, pt, alive = carry
            out = (jnp.where(alive, node, -1),
                   jnp.where(alive, pt + 1, -1),
                   jnp.where(alive, t, -1))
            stop = (pn < 0) | (pt < 0)
            it = jnp.clip(pt + 1, 0, T - 1)
            inn = jnp.clip(pn, 0, C - 1)
            npn = jnp.where(stop, -1, pwns[it, inn])
            npt = jnp.where(stop, -1, pwts[it, inn])
            nnode = jnp.where(stop, node, pn)
            nt = jnp.where(stop, t, pt)
            return (nnode, nt, npn, npt, alive & ~stop), out

        init = (i0, tr - 1,
                jnp.where(ok, pwn_fin[i0], -1),
                jnp.where(ok, pwt_fin[i0], -1), ok)
        _c, (nodes, t0s, t1s) = jax.lax.scan(step, init, None, length=T)
        return nodes, t0s, t1s, score

    return jax.vmap(one)(vb, wnb, wtb, WEb, pwnb, pwtb, t_reals)


def _retain_comp(d, comp):
    """LRU-retain comp against the net's jit cache (see _lv_pipeline)."""
    if comp is None:
        return
    refs = d.setdefault("comp_refs", {})
    refs.pop(id(comp), None)
    refs[id(comp)] = comp  # move-to-end = most recently used
    while len(refs) > _COMP_CACHE_MAX:
        old_id, _old = next(iter(refs.items()))
        del refs[old_id]
        for k in [k for k in d["jits"] if k[-1] == old_id]:
            del d["jits"][k]


def _lv_scan_body(net, comp, d, precision, max_active, state_mode,
                  x, lm_scale, word_pen, beam, mp=None):
    """Traced core shared by the 1-best and lattice LV pipelines:
    chunk-wise OutP fused into the uniform-row scan.

    Returns the final carry (v, rec) plus the per-frame record planes
    WEs/pwns/pwts in (B, T, C) layout (plane t = word ends at time t-1).
    """
    S = net.uniform_width
    B, T = x.shape[0], x.shape[1]
    Ns = len(net.comp_state)
    C = Ns // S
    xw_s = _scale_xw(d.get("xw"), lm_scale)
    step = _make_uniform_step(
        B, Ns, d["band"], d["a0"], d["aE"], S, d["bonus"],
        d["trans"] * lm_scale, d["start"] * lm_scale,
        word_pen, beam, max_active, xw_s,
        _scale_xw3(d.get("xw3"), lm_scale))

    def outp_of(fchunk):
        if state_mode:  # (B, t, S_phys) external state scores
            return fchunk[:, :, d["comp_state"]]
        return jax.vmap(
            lambda f: _net_outp(net, comp, f, precision, mp=mp))(fchunk)

    # OutP is computed CHUNK-WISE inside the scan: the full
    # (B, T, Ns) plane is ~2.5 GB at 5k vocab — materialising it
    # costs an extra HBM round-trip and caps the batch size.
    # The chunk itself is sized to ~1 GB: at 100k-vocab rows
    # (1.6M network states) a 64-frame chunk alone would be
    # 3.3 GB, so large nets drop to shorter chunks.
    CH = T
    for c in (64, 32, 16, 8):
        if T % c == 0:
            CH = c
            break
    while (CH > 8 and CH % 2 == 0 and T % (CH // 2) == 0
           and B * CH * Ns * 4 > 1 << 30):
        CH //= 2
    init = (
        jnp.full((B, Ns), LZERO, jnp.float32),
        jnp.zeros((B, Ns), jnp.uint32),
    )

    def outer(carry, c):
        fchunk = jax.lax.dynamic_slice_in_dim(x, c * CH, CH, 1)
        outp_chunk = outp_of(fchunk)  # (B, CH, Ns)

        def inner(carry2, tl):
            outp_t = jax.lax.dynamic_index_in_dim(
                outp_chunk, tl, axis=1, keepdims=False)
            return step(carry2, outp_t, c * CH + tl)

        return jax.lax.scan(inner, carry, jnp.arange(CH))

    (v, rec), recs = jax.lax.scan(outer, init, jnp.arange(T // CH))
    WEs = jnp.swapaxes(recs[0].reshape(T, B, C), 0, 1)
    pwns = jnp.swapaxes(recs[1].reshape(T, B, C), 0, 1)
    pwts = jnp.swapaxes(recs[2].reshape(T, B, C), 0, 1)
    return (v, rec), WEs, pwns, pwts


def _lv_pipeline(net, comp, precision, max_active, state_mode=False):
    """ONE jitted program per net: OutP -> scan -> device traceback.

    The whole decode is one compiled call (network arrays cached on
    device, model params baked as constants), so no eager dispatch or
    upload sits between OutP, the scan and the traceback.
    lm_scale / word_pen / beam are traced operands, so one executable
    serves all settings; max_active changes the program (static).
    """
    d = _net_dev(net)
    key = ("pipe", precision, max_active, state_mode,
           id(comp) if comp is not None else None)
    # the jitted program bakes comp's parameters in as constants, and the
    # cache key uses id(comp) — retain comp so a freed set's id can never
    # be reused for a different parameter set against the same net.
    # LRU-bounded: train-decode loops recompile the set each iteration,
    # and an unbounded cache would pin every generation's parameters
    # (plus its jitted executable) in device memory forever.
    _retain_comp(d, comp)
    fn = d["jits"].get(key)
    if fn is None:
        S = net.uniform_width

        def pipe(x, t_reals, lm_scale, word_pen, beam, mp=None):
            (v, rec), WEs, pwns, pwts = _lv_scan_body(
                net, comp, d, precision, max_active, state_mode,
                x, lm_scale, word_pen, beam, mp=mp)
            wn = (rec >> REC_TBITS).astype(jnp.int32) - 1
            wt = (rec & REC_TMASK).astype(jnp.int32) - 1
            nodes, t0s, t1s, scores = _traceback_device(
                v, wn, wt, WEs, pwns, pwts, d["aE"],
                d["end_exit"] * lm_scale, t_reals, S=S)
            # ONE packed plane: one host fetch per call
            return jnp.stack([nodes, t0s, t1s], axis=1), scores

        fn = jax.jit(pipe)
        d["jits"][key] = fn
    return fn


def _lv_lattice_pipeline(net, comp, precision, max_active, k_lat,
                         state_mode=False, k_rec=16384):
    """Jitted batched lattice front half: fused scan + device-side
    top-K record compaction + in-beam RAGGED compaction.

    Shipping the full (B, T, C) word-end planes to the host costs
    ~30 MB/utterance at LV sizes; even the per-frame top-`k_lat`
    compaction still ships (B, T, K) mostly-empty slots — 34 MB at
    (16, 512, 256). Lattices only need the records inside the
    lattice beam (~13/frame at 5k/latBeam 150), so a second device
    stage selects ALL in-beam records into a fixed (B, min(T*K, k_rec))
    buffer: scores f32, row ids int32, flat (frame, slot) index int32,
    and (pred row, pred time) packed into one uint32 — 16 B/record,
    ~50x less wire. `counts` flags budget overflow (weakest records
    drop first, a global-beam-style degradation). The full planes stay
    resident on device for the rare transitive predecessor
    resurrections (see generate_lattice_batch).
    """
    d = _net_dev(net)
    key = ("latpipe", precision, max_active, state_mode, k_lat, k_rec,
           id(comp) if comp is not None else None)
    _retain_comp(d, comp)
    fn = d["jits"].get(key)
    if fn is None:
        S = net.uniform_width

        def pipe(x, t_reals, lm_scale, word_pen, beam, lat_beam, mp=None):
            (v, rec), WEs, pwns, pwts = _lv_scan_body(
                net, comp, d, precision, max_active, state_mode,
                x, lm_scale, word_pen, beam, mp=mp)
            B, T, C = WEs.shape
            # final word ends per utterance: plane t_real when t_real < T
            # (ends at t_real-1 are emitted by scan step t_real), else
            # from the final carry — mirrors _traceback_device
            aE = d["aE"]
            ev = (v + aE[None]).reshape(B, C, S)
            WEl = jnp.max(ev, axis=2)
            best_s = jnp.argmax(ev, axis=2)
            col = jnp.arange(S, dtype=jnp.int32)[None, None, :]
            onehot = best_s[..., None] == col
            okl = WEl > LSMALL
            IMIN = jnp.iinfo(jnp.int32).min
            wn = (rec >> REC_TBITS).astype(jnp.int32) - 1
            wt = (rec & REC_TMASK).astype(jnp.int32) - 1
            pwnl = jnp.where(
                okl,
                jnp.max(jnp.where(onehot, wn.reshape(B, C, S), IMIN),
                        axis=2), -1)
            pwtl = jnp.where(
                okl,
                jnp.max(jnp.where(onehot, wt.reshape(B, C, S), IMIN),
                        axis=2), -1)
            use_last = (t_reals >= T)[:, None]
            trc = jnp.clip(t_reals, 0, T - 1)
            bi = jnp.arange(B)
            WE_fin = jnp.where(use_last, WEl, WEs[bi, trc])
            pwn_fin = jnp.where(use_last, pwnl, pwns[bi, trc])
            pwt_fin = jnp.where(use_last, pwtl, pwts[bi, trc])

            K = min(k_lat, C)
            sc_k, ix_k = jax.lax.top_k(WEs, K)  # (B, T, K)
            ix_k = ix_k.astype(jnp.int32)
            pn_k = jnp.take_along_axis(pwns, ix_k, axis=2)
            pt_k = jnp.take_along_axis(pwts, ix_k, axis=2)

            # ragged in-beam compaction: ALL records inside the lattice
            # beam, selected strongest-first into M fixed slots
            fidx = jnp.arange(T)
            valid_f = (fidx[None, :] >= 1) & (fidx[None, :] < t_reals[:, None])
            best = sc_k[:, :, 0]  # top_k sorts descending
            in_beam = (valid_f[:, :, None] & (sc_k > LSMALL)
                       & (best[:, :, None] > LSMALL)
                       & (sc_k >= best[:, :, None] - lat_beam))
            M = min(T * K, k_rec)
            skey = jnp.where(in_beam, sc_k, jnp.float32(LZERO))
            rec_sc, rec_idx = jax.lax.top_k(skey.reshape(B, T * K), M)
            rec_idx = rec_idx.astype(jnp.int32)
            bi2 = jnp.arange(B)[:, None]
            rec_ix = ix_k.reshape(B, T * K)[bi2, rec_idx]
            sel_pn = pn_k.reshape(B, T * K)[bi2, rec_idx]
            sel_pt = pt_k.reshape(B, T * K)[bi2, rec_idx]
            # (pn+1) needs <= 17 bits (rows < 2^17, the packed-record
            # constraint), (pt+1) 15 bits — exactly one uint32
            rec_pred = (
                jnp.left_shift((sel_pn + 1).astype(jnp.uint32),
                               REC_TBITS)
                | (sel_pt + 1).astype(jnp.uint32))
            counts = jnp.sum(in_beam.reshape(B, -1), axis=1,
                             dtype=jnp.int32)
            # final records rank by the COMPLETE path score (word-end +
            # end-node exit LM): ranking by raw score could drop the true
            # 1-best from the top-K under tight k_lat, silently changing
            # HVite -z output. Rows with no exit transition (end_exit
            # LZERO) can never be lattice final nodes (same as the
            # sequential path's end_exit > LSMALL filter) so masking
            # them out here loses nothing.
            tot_fin = jnp.where(
                (WE_fin > LSMALL) & (d["end_exit"][None] > LSMALL),
                WE_fin + d["end_exit"][None] * lm_scale, LZERO)
            _tot_k, ixf_k = jax.lax.top_k(tot_fin, K)  # (B, K)
            ixf_k = ixf_k.astype(jnp.int32)
            scf_k = jnp.where(
                _tot_k > LSMALL,
                jnp.take_along_axis(WE_fin, ixf_k, axis=1), LZERO)
            pnf_k = jnp.take_along_axis(pwn_fin, ixf_k, axis=1)
            ptf_k = jnp.take_along_axis(pwt_fin, ixf_k, axis=1)
            # wire format: the compaction packs EVERYTHING into ONE
            # record-major
            # int32 buffer the host fetches with a single call: the
            # finals+counts block first (padded to record width 4),
            # then the in-beam records (score, row, flat idx, packed
            # pred — floats bitcast side-by-side). At the default
            # k_rec the record block is ~4 MB for B=16, shipped whole
            # rather than as a second fetch of a count-bounded prefix.
            bc = lambda a: jax.lax.bitcast_convert_type(a, jnp.int32)
            wire_rec = jnp.stack(
                [bc(rec_sc), rec_ix, rec_idx, bc(rec_pred)], axis=2)
            wire_fin = jnp.concatenate(
                [bc(scf_k), ixf_k, pnf_k, ptf_k, counts[:, None]],
                axis=1)
            # 4K+1 finals ints pad to K+1 rows of 4 — the host recovers
            # the split from K (= min(k_lat, C), C free via plane shape)
            f_rows = K + 1
            fin_pad = jnp.pad(wire_fin, ((0, 0), (0, f_rows * 4
                                                  - wire_fin.shape[1]))
                              ).reshape(wire_fin.shape[0], f_rows, 4)
            wire = jnp.concatenate([fin_pad, wire_rec], axis=1)
            return wire, (WEs, pwns, pwts)

        fn = jax.jit(pipe)
        d["jits"][key] = fn
    return fn


_dev_scalar_cache: dict = {}


def _dev_scalar(x) -> jnp.ndarray:
    """Cached device scalar: jitted pipelines take lm_scale / word_pen /
    beam as traced operands every call, uploaded once per value."""
    key = ("s", float(x))
    v = _dev_scalar_cache.get(key)
    if v is None:
        v = jnp.asarray(float(x), jnp.float32)
        if len(_dev_scalar_cache) > 256:
            _dev_scalar_cache.clear()
        _dev_scalar_cache[key] = v
    return v


def _dev_lens(t_reals) -> jnp.ndarray:
    """Cached device length vector (bucketed batches repeat shapes)."""
    key = ("l", tuple(int(t) for t in t_reals))
    v = _dev_scalar_cache.get(key)
    if v is None:
        v = jnp.asarray(key[1], jnp.int32)
        if len(_dev_scalar_cache) > 256:
            _dev_scalar_cache.clear()
        _dev_scalar_cache[key] = v
    return v


def _decode_uniform(net, comp, x, t_reals, lm_scale, word_pen, beam,
                    max_active, precision, state_mode=False,
                    model_params=None):
    # the packed word-link record carries a 15-bit frame field; past it
    # the frame index would silently overflow into the row bits
    # (callers chunk long utterances before reaching this point)
    if x.shape[1] > REC_TMASK:
        HError(8520, "decode: %d frames exceed the packed record's "
                     "15-bit frame field (max %d) — chunk the utterance",
               x.shape[1], REC_TMASK)
    fn = _lv_pipeline(net, comp, precision, max_active, state_mode)
    mp = (None if model_params is None else
          tuple(jnp.asarray(model_params[k], jnp.float32)
                for k in ("means", "variances", "gconsts")))
    packed, scores = fn(
        x, _dev_lens(t_reals), _dev_scalar(lm_scale),
        _dev_scalar(word_pen),
        _dev_scalar(_BEAM_OFF if beam is None else beam), mp)
    p = np.asarray(packed)  # (B, 3, T): one transfer for all planes
    return _format_uniform_results(net, p[:, 0], p[:, 1], p[:, 2],
                                   np.asarray(scores))


def _format_uniform_results(net, nodes_b, t0_b, t1_b, scores_b):
    out: List[Optional[DecodeResult]] = []
    for b in range(nodes_b.shape[0]):
        if scores_b[b] <= LSMALL:
            out.append(None)
            continue
        words, nds, times, wscores = [], [], [], []
        valid = nodes_b[b] >= 0
        for k in range(int(valid.sum()) - 1, -1, -1):  # reverse order
            node = int(nodes_b[b, k])
            sym = net.node_out[node]
            sym = net.node_words[node] if sym is None else sym
            if sym:
                words.append(sym)
                nds.append(node)
                times.append((int(t0_b[b, k]), int(t1_b[b, k])))
                wscores.append(0.0)
        out.append(DecodeResult(words=words, word_nodes=nds, times=times,
                                score=float(scores_b[b]), scores=wscores))
    return out


def _net_outp(net, comp, feats, precision, mp=None):
    """(T, Ns) network-state observation log-likelihoods.

    `mp`: optional (means, variances, gconsts) override triple — the
    speaker-adaptation hook (HDecode -J): parameters ride as traced
    operands so one compiled pipeline serves every speaker."""
    if mp is not None:
        means, variances, gconsts = mp
    else:
        means, variances, gconsts = (jnp.asarray(comp.means),
                                     jnp.asarray(comp.variances),
                                     jnp.asarray(comp.gconsts))
    logb, _ = all_state_outp(
        jnp.asarray(feats, jnp.float32),
        means, variances,
        gconsts, jnp.asarray(comp.state_mix),
        jnp.asarray(comp.state_logw), precision=precision,
        slot_blocks=tuple(comp.slot_blocks) or None,
        state_sw=(jnp.asarray(comp.state_sw)
                  if comp.state_sw is not None else None),
        fc_proj=(jnp.asarray(comp.fc_proj) if comp.full_cov else None),
        fc_mu=(jnp.asarray(comp.fc_mu) if comp.full_cov else None),
    )
    return logb[:, jnp.asarray(net.comp_state)]


def decode(
    net: DecodeNetwork,
    comp: CompiledHMMSet,
    feats: np.ndarray,
    lm_scale: float = 1.0,
    word_pen: float = 0.0,
    precision: str = "highest",
    state_scores: Optional[np.ndarray] = None,
    beam: Optional[float] = None,
    max_active: Optional[int] = None,
    model_params: Optional[dict] = None,
) -> Optional[DecodeResult]:
    """Decode one utterance; returns None if no complete path survives.

    `state_scores` (T, S_phys) optionally replaces the GMM observation
    model — the hybrid-decoding hook (ANN log-posterior/prior scores).
    `model_params` optionally overrides {means, variances, gconsts} —
    the speaker-adaptation hook (HDecode -J).
    """
    T = feats.shape[0]
    if net.uniform_width:
        if T > REC_TMASK:
            # auto-chunk: HRec.c streams arbitrarily long input, but the
            # packed word-link record's 15-bit frame field caps one scan
            # at 32767 frames — longer utterances split at low-energy
            # frames (word-link chains then rarely span a cut) and the
            # chunk transcripts concatenate
            return _decode_chunked(net, comp, feats, lm_scale, word_pen,
                                   precision, state_scores, beam,
                                   max_active, model_params)
        if state_scores is not None:
            x = jnp.asarray(state_scores, jnp.float32)[None]
            return _decode_uniform(net, None, x, [T], lm_scale, word_pen,
                                   beam, max_active, precision,
                                   state_mode=True)[0]
        x = jnp.asarray(feats, jnp.float32)[None]
        return _decode_uniform(net, comp, x, [T], lm_scale, word_pen,
                               beam, max_active, precision,
                               model_params=model_params)[0]
    if state_scores is not None:
        logb = jnp.asarray(state_scores, jnp.float32)
        outp_states = logb[:, jnp.asarray(net.comp_state)]
    else:
        mp = (None if model_params is None else
              tuple(jnp.asarray(model_params[k], jnp.float32)
                    for k in ("means", "variances", "gconsts")))
        outp_states = _net_outp(net, comp, feats, precision, mp=mp)

    (vb, wnb, wtb), (WEs, pwns, pwts) = run_decode_batch(
        outp_states[None, :, :], net, lm_scale, word_pen,
        beam=beam, max_active=max_active,
    )
    WE_fin, pwn_fin, pwt_fin = _final_records(net, vb[0], wnb[0], wtb[0])
    return _finalize(net, np.asarray(WEs[0]), np.asarray(pwns[0]),
                     np.asarray(pwts[0]), WE_fin, pwn_fin, pwt_fin, T,
                     lm_scale)


# auto-chunk target length: comfortably under REC_TMASK so the cut-
# point search window never pushes a chunk over the record range
CHUNK_T = 30_000
CHUNK_WINDOW = 2_000


def _decode_chunked(net, comp, feats, lm_scale, word_pen, precision,
                    state_scores, beam, max_active, model_params):
    """Decode an over-long utterance as concatenated chunks.

    Cut points land on the LOWEST-ENERGY frame (smallest feature L2
    norm — silence-ish) inside the window [CHUNK_T - CHUNK_WINDOW,
    CHUNK_T) of each remaining span, so a word rarely straddles a cut.
    Results are the concatenation of the chunk decodes with times
    offset; the score is the sum (the cross-chunk LM transition is
    dropped — the approximation inherent to chunking).
    """
    src = state_scores if state_scores is not None else feats
    cuts = [0]
    pos = 0
    T = src.shape[0]
    while T - pos > CHUNK_T:
        w0 = pos + CHUNK_T - CHUNK_WINDOW
        w1 = pos + CHUNK_T
        norms = np.linalg.norm(np.asarray(src[w0:w1]), axis=1)
        pos = w0 + int(np.argmin(norms))
        cuts.append(pos)
    cuts.append(T)

    words: List[str] = []
    nodes: List[int] = []
    times: List[Tuple[int, int]] = []
    wscores: List[float] = []
    score = 0.0
    any_ok = False
    for c0, c1 in zip(cuts[:-1], cuts[1:]):
        # chunks pad to a 128 multiple so the jitted pipeline compiles
        # once per padded length, not once per cut position
        tc = c1 - c0
        tp = ((tc + 127) // 128) * 128
        chunk = np.asarray(src[c0:c1], np.float32)
        xb = np.zeros((1, tp, chunk.shape[1]), np.float32)
        xb[0, :tc] = chunk
        if state_scores is not None:
            r = _decode_uniform(net, None, jnp.asarray(xb), [tc],
                                lm_scale, word_pen, beam, max_active,
                                precision, state_mode=True)[0]
        else:
            r = _decode_uniform(net, comp, jnp.asarray(xb), [tc],
                                lm_scale, word_pen, beam, max_active,
                                precision, model_params=model_params)[0]
        if r is None:
            continue
        any_ok = True
        words.extend(r.words)
        nodes.extend(r.word_nodes)
        times.extend([(t0 + c0, t1 + c0) for t0, t1 in r.times])
        wscores.extend(r.scores)
        score += r.score
    if not any_ok:
        return None
    return DecodeResult(words=words, word_nodes=nodes, times=times,
                        score=score, scores=wscores)


def decode_batch(
    net: DecodeNetwork,
    comp: CompiledHMMSet,
    feats_list: List[np.ndarray],
    lm_scale: float = 1.0,
    word_pen: float = 0.0,
    precision: str = "highest",
    pad_to: int = 128,
    beam: Optional[float] = None,
    max_active: Optional[int] = None,
) -> List[Optional[DecodeResult]]:
    """Decode a batch of utterances through ONE kernel launch.

    Utterances are padded to a common frame count (rounded up to
    `pad_to` so bucketed callers reuse compilations). Padding frames
    never affect results: the decode recursion is causal and each
    utterance finalises from the word-end record plane at its own
    t_real (WEs[t] holds the ends at time t-1), so the scores the scan
    computes beyond t_real are simply ignored. Identical output to
    calling `decode` per utterance (tested).
    """
    B = len(feats_list)
    lens = [int(f.shape[0]) for f in feats_list]
    if net.uniform_width and max(lens) > REC_TMASK:
        # over-long utterances go through the chunked single path;
        # the rest batch as usual
        out: List[Optional[DecodeResult]] = [None] * B
        ok_idx = [b for b in range(B) if lens[b] <= REC_TMASK]
        for b in range(B):
            if lens[b] > REC_TMASK:
                out[b] = decode(net, comp, feats_list[b], lm_scale,
                                word_pen, precision, beam=beam,
                                max_active=max_active)
        if ok_idx:
            rs = decode_batch(net, comp, [feats_list[b] for b in ok_idx],
                              lm_scale, word_pen, precision, pad_to,
                              beam, max_active)
            for b, r in zip(ok_idx, rs):
                out[b] = r
        return out
    T = ((max(lens) + pad_to - 1) // pad_to) * pad_to
    D = feats_list[0].shape[1]
    fb = np.zeros((B, T, D), np.float32)
    for b, f in enumerate(feats_list):
        fb[b, : lens[b]] = f

    if net.uniform_width:
        return _decode_uniform(net, comp, jnp.asarray(fb), lens, lm_scale,
                               word_pen, beam, max_active, precision)
    outp = jax.vmap(lambda x: _net_outp(net, comp, x, precision))(
        jnp.asarray(fb))
    (vb, wnb, wtb), (WEb, pwnb, pwtb) = run_decode_batch(
        outp, net, lm_scale, word_pen, beam=beam, max_active=max_active)
    WEb = np.asarray(WEb)
    pwnb = np.asarray(pwnb)
    pwtb = np.asarray(pwtb)

    out: List[Optional[DecodeResult]] = []
    for b in range(B):
        tr = lens[b]
        if tr == T:
            WE_fin, pwn_fin, pwt_fin = _final_records(
                net, vb[b], wnb[b], wtb[b])
        else:
            # ends at time tr-1 were emitted by scan step tr
            WE_fin = WEb[b, tr].astype(np.float64)
            pwn_fin = pwnb[b, tr].astype(np.int64)
            pwt_fin = pwtb[b, tr].astype(np.int64)
        out.append(_finalize(net, WEb[b], pwnb[b], pwtb[b], WE_fin,
                             pwn_fin, pwt_fin, tr, lm_scale))
    return out


def _host_lm_lookup(net):
    """Host-side row-to-row LM scores, vectorised: takes int64 arrays
    (pn, i) and returns the f64 score array (dense matrix or factored
    back-off tables)."""
    if net.xw_backoff is None:
        # cache the f64 view: the (R, R) conversion is ~50 ms at 5k
        # vocab and this is called once per utterance in the batched
        # lattice walk
        trans_np = getattr(net, "_trans_np64", None)
        if trans_np is None:
            trans_np = net._trans_np64 = np.asarray(net.trans, np.float64)
        return lambda pn, i: trans_np[pn, i]
    x = net.xw_backoff
    cached = getattr(net, "_xw_pairs_arr", None)
    if cached is None:
        # one vectorised pass per bucket (the per-slot loop was
        # multi-second at 100k vocab / 2M explicit-bigram slots);
        # (pred, row) pairs pack into sorted int64 keys so each lookup
        # is a binary search, not a dict walk (row/pred indices are
        # bounded by the 17-bit word-link row space, < 2^21)
        kparts, vparts = [], []
        perm = np.argsort(np.asarray(x["inv"]))
        pos = 0
        for preds, scores in x["buckets"]:
            nrows, fb = preds.shape
            rows = np.repeat(perm[pos:pos + nrows], fb)
            pos += nrows
            m = (scores > LSMALL).ravel()
            kparts.append(preds.ravel()[m].astype(np.int64) * _REC_PK
                          + rows[m].astype(np.int64))
            vparts.append(scores.ravel()[m].astype(np.float64))
        ks = (np.concatenate(kparts) if kparts
              else np.empty(0, np.int64))
        vs = (np.concatenate(vparts) if vparts
              else np.empty(0, np.float64))
        o = np.argsort(ks, kind="stable")
        cached = net._xw_pairs_arr = (ks[o], vs[o])
    ks, vs = cached
    bow = np.asarray(x["bow"], np.float64)
    uni = np.asarray(x["uni"], np.float64)

    def lm_of(pn, i):
        scalar = np.ndim(pn) == 0
        pn_a = np.atleast_1d(np.asarray(pn, np.int64))
        i_a = np.atleast_1d(np.asarray(i, np.int64))
        out = bow[pn_a] + uni[i_a]
        if ks.size:
            q = pn_a * _REC_PK + i_a
            # rightmost match = last inserted among duplicates (the
            # former dict's last-wins), though keys are in fact unique
            pos = np.searchsorted(ks, q, side="right") - 1
            psafe = np.maximum(pos, 0)
            hit = (pos >= 0) & (ks[psafe] == q)
            out = np.maximum(out, np.where(hit, vs[psafe], -np.inf))
        return float(out[0]) if scalar else out

    return lm_of


def _host_lm3_lookup(net):
    """Host-side trigram-guided LM scores for lattice arc arithmetic:
    lm3(ppn, pn, i) = the score the single-pass trigram cross-word step
    applied to the pn -> i transition when pn's token's own predecessor
    was ppn (-1 = sentence-start context). The lattice's acoustic
    scores come from subtracting exactly what pass 1 added."""
    x3 = net.xw_trigram
    lm2 = _host_lm_lookup(net)
    ctx = np.asarray(x3["ctx_word"], np.int64)
    C = len(ctx) - 1
    cached = getattr(net, "_lm3_host_arr", None)
    if cached is None:
        # global packed keys over the segmented tables so the per-arc
        # segment binary searches vectorise into two np.searchsorted
        # calls: pairs are stored (v_row asc, u_word asc), so
        # v_row * 2^22 + u_word is globally sorted; each pair's
        # trigram CSR range tiles tri_j in pair order with targets
        # ascending, so pair_idx * 2^22 + tri_j is globally sorted too
        seg = np.asarray(x3["seg_start"], np.int64)
        pu = np.asarray(x3["pair_u"], np.int64)
        pcn = np.asarray(x3["pair_tcnt"], np.int64)
        tj = np.asarray(x3["tri_j"], np.int64)
        p_vrow = np.repeat(np.arange(seg.size - 1, dtype=np.int64),
                           np.diff(seg))
        pair_key = p_vrow * _REC_PK + pu
        tri_key = (np.repeat(np.arange(pu.size, dtype=np.int64), pcn)
                   * _REC_PK + tj)
        cached = net._lm3_host_arr = (pair_key, tri_key)
    pair_key, tri_key = cached
    pbow = np.asarray(x3["pair_bow"], np.float64)
    tp = np.asarray(x3["tri_p"], np.float64)

    def lm3(ppn, pn, i):
        ppn_a = np.atleast_1d(np.asarray(ppn, np.int64))
        pn_a = np.atleast_1d(np.asarray(pn, np.int64))
        i_a = np.atleast_1d(np.asarray(i, np.int64))
        uw = ctx[np.where(ppn_a >= 0, ppn_a, C)]
        out = np.asarray(lm2(pn_a, i_a), np.float64).copy()
        q = pn_a * _REC_PK + uw
        j = np.searchsorted(pair_key, q)
        js = np.minimum(j, pair_key.size - 1)
        has = (j < pair_key.size) & (pair_key[js] == q)
        # (u, v) context present: trigram back-off v = bow + bigram,
        # overridden by an explicit trigram when it scores higher
        v = pbow[js] + out
        if tri_key.size:
            tq = js * _REC_PK + i_a
            k = np.searchsorted(tri_key, tq)
            ksafe = np.minimum(k, tri_key.size - 1)
            thit = has & (k < tri_key.size) & (tri_key[ksafe] == tq)
            v = np.where(thit & (tp[ksafe] > v), tp[ksafe], v)
        return np.where(has, v, out)

    return lm3


def generate_lattice(
    net: DecodeNetwork,
    comp: CompiledHMMSet,
    feats: np.ndarray,
    lm_scale: float = 1.0,
    word_pen: float = 0.0,
    lattice_beam: float = 200.0,
    frame_period_s: float = 0.01,
    precision: str = "highest",
    state_scores: Optional[np.ndarray] = None,
    want_result: bool = False,
    beam: Optional[float] = None,
    max_active: Optional[int] = None,
    model_params: Optional[dict] = None,
    max_preds: int = 1,
):
    """Decode and emit a word lattice (HVite -z).

    Matches HVite's lattice semantics: one lattice node per (word node,
    end time) word-link record, each with its single best predecessor
    (HRec.c LatFromPaths — HVite lattices keep only the best predecessor
    per record). Records scoring worse than `lattice_beam` below the best
    record at the same frame are dropped. `max_preds` > 1 adds
    alternative-predecessor arcs (HLVRec semantics, see
    _lattice_from_rec) — HDecode's lattices use it.

    `want_result=True` additionally returns the 1-best DecodeResult from
    the same recursion (so HVite -z needs one decode, not two);
    `state_scores` is the hybrid/discrete observation hook as in decode().
    """
    from ..io.slf import Lattice, LArc, LNode, NULL_WORD

    T = feats.shape[0]
    if state_scores is not None:
        logb = jnp.asarray(state_scores, jnp.float32)
        outp_states = logb[:, jnp.asarray(net.comp_state)]
    else:
        mp = (None if model_params is None else
              tuple(jnp.asarray(model_params[k], jnp.float32)
                    for k in ("means", "variances", "gconsts")))
        outp_states = _net_outp(net, comp, feats, precision, mp=mp)

    (vb, wnb, wtb), (WEb, pwnb, pwtb) = run_decode_batch(
        outp_states[None, :, :], net, lm_scale, word_pen,
        beam=beam, max_active=max_active,
    )
    return _lattice_from_host_planes(
        net, np.asarray(WEb[0]), np.asarray(pwnb[0]), np.asarray(pwtb[0]),
        (vb[0], wnb[0], wtb[0]), None, T, lattice_beam, frame_period_s,
        lm_scale, word_pen, want_result, max_preds)


def _lattice_from_host_planes(net, WEs, pwns, pwts, carry, fin, T,
                              lattice_beam, frame_period_s, lm_scale,
                              word_pen, want_result, max_preds):
    """Lattice (+ optional 1-best) from host-fetched word-end planes.

    `WEs/pwns/pwts` cover scan steps 0..T-1 (step t holds ends at time
    t-1). Final-frame (T-1) records come from `fin` =
    (WE_fin, pwn_fin, pwt_fin) when given — the padded-batch case, where
    they are plane T of the full scan — else from `carry` = (v, wn, wt),
    the final state vector of an unpadded scan. Shared by the sequential
    and generic-batched generators (identical output, tested)."""
    if fin is not None:
        WE_fin = np.asarray(fin[0], np.float64)
        pwn_fin = np.asarray(fin[1], np.int64)
        pwt_fin = np.asarray(fin[2], np.int64)
    else:
        v, wn, wt = carry
        # final-frame records
        v = np.asarray(v)
        wn = np.asarray(wn)
        wt = np.asarray(wt)
        nos = np.asarray(net.node_of_chain[net.chain_of])
        e_state = np.asarray(v + np.asarray(net.aE), np.float64)
        Nn = net.n_nodes
        WE_fin = np.full(Nn, LZERO, np.float64)
        pwn_fin = np.full(Nn, -1, np.int64)
        pwt_fin = np.full(Nn, -1, np.int64)
        # per-node max over states; stable sort keeps the FIRST state
        # among equal scores, matching the former strict-greater scan
        s_ord = np.argsort(-e_state, kind="stable")
        i_ord = nos[s_ord]
        _uniq, first = np.unique(i_ord, return_index=True)
        sel = s_ord[first]
        win = e_state[sel] > LZERO
        WE_fin[i_ord[first][win]] = e_state[sel][win]
        pwn_fin[i_ord[first][win]] = np.asarray(wn, np.int64)[sel][win]
        pwt_fin[i_ord[first][win]] = np.asarray(wt, np.int64)[sel][win]

    # records table: rec[(node, t)] = (score, pred_node, pred_t) — one
    # vectorised pass over the (T-1, Nn) plane (the per-frame per-node
    # Python loop dominated sequential lattice generation); np.nonzero's
    # row-major order IS the former (t asc, node asc) insertion order
    rec = {}
    rows = np.asarray(WEs[1:T])  # native plane dtype: beam comparisons
    # round exactly like the former per-element loop (and the batch path)
    best = rows.max(axis=1, keepdims=True) if T > 1 else rows
    mask = (best > LSMALL) & (rows > LSMALL) & (rows >= best - lattice_beam)
    tt, ii = np.nonzero(mask)
    rec.update(zip(
        zip(ii.tolist(), tt.tolist()),
        zip(rows[tt, ii].tolist(),
            np.asarray(pwns)[tt + 1, ii].tolist(),
            np.asarray(pwts)[tt + 1, ii].tolist())))
    bestf = WE_fin.max()
    fkeep = np.nonzero((WE_fin > LSMALL)
                       & (WE_fin >= bestf - lattice_beam))[0]
    for i_ in fkeep.tolist():
        rec[(i_, T - 1)] = (float(WE_fin[i_]), int(pwn_fin[i_]),
                            int(pwt_fin[i_]))
    res = None
    if want_result:
        res = _finalize(net, WEs, pwns, pwts, WE_fin.astype(np.float64),
                        pwn_fin.astype(np.int64), pwt_fin.astype(np.int64),
                        T, lm_scale)
    if not rec:
        return (None, res) if want_result else None

    def resolve(pn, pt):
        score = float(WEs[pt + 1, pn]) if pt < T - 1 else float(WE_fin[pn])
        if score <= LSMALL:
            return None
        ppn = int(pwns[pt + 1, pn]) if pt < T - 1 else int(pwn_fin[pn])
        ppt = int(pwts[pt + 1, pn]) if pt < T - 1 else int(pwt_fin[pn])
        return score, ppn, ppt

    lat = _lattice_from_rec(net, rec, resolve, T, frame_period_s,
                            lm_scale, word_pen, max_preds=max_preds,
                            arc_beam=lattice_beam)
    return (lat, res) if want_result else lat


# (node, t) record keys pack into one int64 so record lookups become
# sorted-array searches instead of dict walks: t is bounded by the
# 15-bit traceback field (auto-chunked above 32767 frames) and node ids
# by the 17+4-bit word-link row space, so node * 2^22 + (t + 2) cannot
# collide or overflow
_REC_PK = np.int64(1) << 22


def _lattice_from_rec(net, rec, resolve, T_real, frame_period_s,
                      lm_scale, word_pen, resolve_many=None,
                      max_preds=1, arc_beam=None):
    """Build a Lattice from beam-kept word-end records.

    `max_preds` > 1 (HDECODE: LATPREDS — the HLVRec lattice semantics):
    each record additionally links to up to max_preds-1 ALTERNATIVE
    predecessors among the records kept at its entry time, under the
    standard acoustic-invariance approximation (the word's internal
    Viterbi path — hence its acoustic score — is taken from the winning
    predecessor; alternatives reuse it). HVite keeps the default
    max_preds=1 (HRec.c LatFromPaths single-best-predecessor lattices);
    HLVRec-style rescoring needs the alternatives — without them the
    exact pass-2 trigram walk can only rescore the pass-1 chain.
    `arc_beam` prunes alternatives scoring worse than the record's own
    path by more than the beam (default: keep all that max_preds allows).

    `rec`: {(node, t): (score, pred_node, pred_t)} in deterministic
    insertion order; `resolve(pn, pt)` recovers a record that the beam
    dropped (returns (score, ppn, ppt) or None when unavailable);
    `resolve_many(pairs)` is the batch form — one device gather per
    resurrection wave instead of one fetch per record. Shared by the
    sequential and batched lattice generators so both emit byte-identical
    SLF for identical record sets.
    """
    from ..io.slf import Lattice, LArc, LNode, NULL_WORD

    _PK = _REC_PK

    def _rec_arrays():
        # rec INSERTION order — it defines arc emission order
        ka = np.asarray(list(rec), np.int64).reshape(len(rec), 2)
        va = np.asarray(list(rec.values()), np.float64).reshape(
            len(rec), 3)
        return (ka[:, 0], ka[:, 1], va[:, 0],
                va[:, 1].astype(np.int64), va[:, 2].astype(np.int64))

    ii, tt_, sc, pn_a, pt_a = _rec_arrays()
    n = ii.size
    pk = ii * _PK + (tt_ + 2)
    srt = np.argsort(pk, kind="stable")
    pks = pk[srt]

    def _pred_rows(m):
        # rows (in rec insertion order) holding each m-row's (pn, pt)
        pos = np.searchsorted(pks, pn_a[m] * _PK + (pt_a[m] + 2))
        return pos, srt

    # Transitively retain predecessor records referenced by survivors:
    # a beam keeps the best ends per frame, but a kept record's traceback
    # may point at a pruned (pn, pt) — HTK's LatFromPaths never emits arcs
    # to pruned predecessors, so resurrect them from the word-end planes
    # (their scores are still there) rather than rerouting to the start.
    # Breadth-first waves: each wave's missing predecessors resolve in
    # one call, then their own predecessors form the next wave. The
    # seed wave is found vectorised (callers that pre-resolve — the
    # batched pipeline's pass 2 — make this whole block a no-op).
    m_ref = pn_a >= 0
    if m_ref.any():
        pos, _ = _pred_rows(m_ref)
        ok = (pos < n) & (pks[np.minimum(pos, n - 1)]
                          == pn_a[m_ref] * _PK + (pt_a[m_ref] + 2))
        miss = np.nonzero(m_ref)[0][~ok]
    else:
        miss = np.empty(0, np.int64)
    if miss.size:
        keys0 = list(rec)
        frontier = [keys0[j] for j in miss.tolist()]
        while frontier:
            need = []
            referrers: dict = {}
            for key in frontier:
                _, pn, pt = rec[key]
                if pn < 0 or (pn, pt) in rec:
                    continue
                if (pn, pt) not in referrers:
                    referrers[(pn, pt)] = []
                    need.append((pn, pt))
                referrers[(pn, pt)].append(key)
            if not need:
                break
            got_all = (resolve_many(need) if resolve_many is not None
                       else [resolve(pn, pt) for pn, pt in need])
            frontier = []
            for (pn, pt), got in zip(need, got_all):
                if got is None:
                    # genuinely unavailable: sever so the arc is dropped,
                    # not misattached to the utterance start
                    for key in referrers[(pn, pt)]:
                        rec[key] = (rec[key][0], -1, -2)
                    continue
                rec[(pn, pt)] = got
                frontier.append((pn, pt))
        # resurrection extended/rewrote rec — rebuild the arrays
        ii, tt_, sc, pn_a, pt_a = _rec_arrays()
        n = ii.size
        pk = ii * _PK + (tt_ + 2)
        srt = np.argsort(pk, kind="stable")
        pks = pk[srt]

    lat = Lattice(lmscale=lm_scale, wdpenalty=word_pen)
    start_id = 0
    lat.nodes.append(LNode(id=0, time=0.0, word=NULL_WORD))
    end_id = 1
    lat.nodes.append(
        LNode(id=1, time=T_real * frame_period_s, word=NULL_WORD))
    # nodes in (t, i) order, ids assigned by rank (same order the former
    # sorted() loop produced); node_id lookups become array indexing
    nsort = np.lexsort((ii, tt_))
    nid_a = np.empty(n, np.int64)
    nid_a[nsort] = 2 + np.arange(n, dtype=np.int64)
    node_words = net.node_words
    nodes = lat.nodes
    for nid0, (i_, t_) in enumerate(zip(ii[nsort].tolist(),
                                        tt_[nsort].tolist())):
        nodes.append(LNode(id=nid0 + 2, time=(t_ + 1) * frame_period_s,
                           word=node_words[i_]))
    # arcs: all score/LM arithmetic vectorised over the record arrays,
    # one lean loop only for LArc construction (same arc order and f64
    # arithmetic as the former per-record loop)
    end_exit = np.asarray(net.end_exit, np.float64)
    m_start = pn_a < 0
    m_sever = m_start & (pt_a == -2)
    m_int = ~m_start

    lm_a = np.zeros(n, np.float64)
    ac_a = np.zeros(n, np.float64)
    src_a = np.full(n, start_id, np.int64)
    if m_start.any():
        start_entry = np.asarray(net.start_entry, np.float64)
        lm_a[m_start] = start_entry[ii[m_start]]
        ac_a[m_start] = sc[m_start] - lm_a[m_start] * lm_scale
    if m_int.any():
        pos, _ = _pred_rows(m_int)
        prow = srt[pos]  # every m_int predecessor is present by now
        if getattr(net, "xw_trigram", None) is not None:
            # pass 1 scored pn -> i under pn's token's own trigram
            # context — its record's predecessor names that context
            lm_a[m_int] = _host_lm3_lookup(net)(
                pn_a[prow], pn_a[m_int], ii[m_int])
        else:
            lm_of = _host_lm_lookup(net)
            lm_a[m_int] = lm_of(pn_a[m_int], ii[m_int])
        ac_a[m_int] = (sc[m_int] - sc[prow] - lm_a[m_int] * lm_scale
                       - word_pen)
        src_a[m_int] = nid_a[prow]
    m_fin = (tt_ == T_real - 1) & (end_exit[ii] > LSMALL)
    fin_lm = end_exit[ii]

    aid = 0
    arcs = lat.arcs
    for sev_j, fin_j, src_j, nid_j, ac_j, lm_j, flm_j in zip(
            m_sever.tolist(), m_fin.tolist(), src_a.tolist(),
            nid_a.tolist(), ac_a.tolist(), lm_a.tolist(),
            fin_lm.tolist()):
        if not sev_j:
            arcs.append(LArc(id=aid, start=src_j, end=nid_j,
                             aclike=ac_j, lmlike=lm_j))
            aid += 1
        if fin_j:
            arcs.append(LArc(id=aid, start=nid_j, end=end_id,
                             aclike=0.0, lmlike=flm_j))
            aid += 1

    if max_preds > 1 and m_int.any():
        # alternative-predecessor arcs (HLVRec lattice semantics):
        # candidates are the records kept at each entry time, scored
        # score(j, pt) + s*lm(j -> i) + pen + ac_seg(i, t)
        from collections import defaultdict

        MAXC = 64  # candidate predecessors examined per entry time
        s = float(lm_scale)
        node_id = dict(zip(zip(ii.tolist(), tt_.tolist()),
                           nid_a.tolist()))
        by_t: dict = defaultdict(list)
        for (j_, t_) in rec:
            by_t[t_].append(j_)
        tri = getattr(net, "xw_trigram", None) is not None
        lmf3 = _host_lm3_lookup(net) if tri else None
        lmf2 = _host_lm_lookup(net) if not tri else None
        get = rec.get
        rows_int = np.nonzero(m_int)[0]
        by_pt: dict = defaultdict(list)
        for r in rows_int.tolist():
            by_pt[int(pt_a[r])].append(r)
        for pt_, rws in by_pt.items():
            cands = by_t.get(pt_)
            if not cands or len(cands) < 2:
                continue
            if len(cands) > MAXC:
                cands = sorted(
                    cands, key=lambda j_: -get((j_, pt_))[0])[:MAXC]
            cj = np.asarray(cands, np.int64)
            c_sc = np.asarray([get((j_, pt_))[0] for j_ in cands])
            c_pp = np.asarray([get((j_, pt_))[1] for j_ in cands],
                              np.int64)
            ri = np.asarray(rws, np.int64)
            # (n_rec, n_cand) pair grid, flattened for the LM lookup
            ii_g = np.repeat(ii[ri], len(cj))
            cj_g = np.tile(cj, len(ri))
            if tri:
                lm_g = lmf3(np.tile(c_pp, len(ri)), cj_g, ii_g)
            else:
                lm_g = lmf2(cj_g, ii_g)
            lm_g = lm_g.reshape(len(ri), len(cj))
            alt = (c_sc[None, :] + s * lm_g + word_pen
                   + ac_a[ri][:, None])
            own = sc[ri][:, None]
            okm = cj[None, :] != pn_a[ri][:, None]
            if arc_beam is not None:
                okm &= alt >= own - arc_beam
            okm &= alt > LSMALL
            # top (max_preds - 1) alternatives per record
            for k_, r in enumerate(ri.tolist()):
                cand_k = np.nonzero(okm[k_])[0]
                if not len(cand_k):
                    continue
                top = cand_k[np.argsort(-alt[k_][cand_k],
                                        kind="stable")][:max_preds - 1]
                for q in top.tolist():
                    arcs.append(LArc(
                        id=aid, start=int(node_id[(int(cj[q]), pt_)]),
                        end=int(nid_a[r]), aclike=float(ac_a[r]),
                        lmlike=float(lm_g[k_, q])))
                    aid += 1
    return lat


# device-side top-K record compaction width for batched lattice
# generation: frames whose in-beam record count exceeds this keep only
# their best LAT_TOPK — an effective per-frame width cap on top of the
# lattice beam (HLVRec bounds record growth per frame the same way)
LAT_TOPK = 256


def generate_lattice_batch(
    net: DecodeNetwork,
    comp: CompiledHMMSet,
    feats_list: List[np.ndarray],
    lm_scale: float = 1.0,
    word_pen: float = 0.0,
    lattice_beam: float = 200.0,
    frame_period_s: float = 0.01,
    precision: str = "highest",
    beam: Optional[float] = None,
    max_active: Optional[int] = None,
    pad_to: int = 128,
    k_lat: Optional[int] = None,
    k_rec: int = 16384,
    state_scores_list: Optional[List[np.ndarray]] = None,
    model_params: Optional[dict] = None,
    max_preds: int = 1,
    want_results: bool = False,
):
    """Batched lattice generation — a bucket of utterances through ONE
    fused scan (the HDecode batch path; `HTKLVRec/HDecode.c` decodes its
    file list sequentially).

    Uniform-row (LV) networks only; other nets fall back to sequential
    generate_lattice. Identical lattices to the sequential path whenever
    `k_lat` covers every in-beam record per frame (tested); by default
    k_lat=LAT_TOPK caps each frame's records at the 256 best, a width
    cap alongside the lattice beam.

    `want_results=True` returns (lattice, DecodeResult) pairs — the
    1-best is walked from the same compacted record planes (best final
    record among the top-K compaction + end node exit LM, then the
    predecessor chain; beam-pruned chain records resurrect from the
    on-device planes), so HVite -z needs one scan per bucket, not two.
    """
    if not net.uniform_width:
        return _generate_lattice_batch_generic(
            net, comp, feats_list, lm_scale, word_pen, lattice_beam,
            frame_period_s, precision, beam, max_active, pad_to,
            state_scores_list, model_params, max_preds, want_results)

    B = len(feats_list)
    state_mode = state_scores_list is not None
    src = state_scores_list if state_mode else feats_list
    lens = [int(f.shape[0]) for f in src]
    if max(lens) > REC_TMASK:
        HError(8520, "generate_lattice_batch: %d frames exceed the packed "
                     "record's 15-bit frame field (max %d) — chunk the "
                     "utterance", max(lens), REC_TMASK)
    T = ((max(lens) + pad_to - 1) // pad_to) * pad_to
    D = src[0].shape[1]
    fb = np.zeros((B, T, D), np.float32)
    for b, f in enumerate(src):
        fb[b, : lens[b]] = f

    C = net.n_chains
    K = min(k_lat if k_lat is not None else LAT_TOPK, C)
    fn = _lv_lattice_pipeline(net, comp if not state_mode else None,
                              precision, max_active, K, state_mode,
                              k_rec=k_rec)
    mp = (None if model_params is None else
          tuple(jnp.asarray(model_params[k], jnp.float32)
                for k in ("means", "variances", "gconsts")))
    wire, planes = fn(
        jnp.asarray(fb), _dev_lens(lens), _dev_scalar(lm_scale),
        _dev_scalar(word_pen),
        _dev_scalar(_BEAM_OFF if beam is None else beam),
        _dev_scalar(lattice_beam), mp)
    # ONE fetch total: finals+counts rows first (K+1 rows of 4), then
    # the full in-beam record block (~4 MB at default k_rec, B=16).
    w = np.asarray(wire)
    f_rows = K + 1
    wf = w[:, :f_rows].reshape(B, f_rows * 4)
    scf_k = wf[:, :K].copy().view(np.float32)
    ixf_k = wf[:, K:2 * K]
    pnf_k = wf[:, 2 * K:3 * K]
    ptf_k = wf[:, 3 * K:4 * K]
    counts = wf[:, 4 * K]
    wr = w[:, f_rows:]
    M = int(wr.shape[1])
    rec_sc = wr[:, :, 0].copy().view(np.float32)
    rec_ix = wr[:, :, 1]
    rec_idx = wr[:, :, 2]
    rec_pred = wr[:, :, 3].copy().view(np.uint32)
    WEs_d, pwns_d, pwts_d = planes  # stay on device

    # pass 1: decode the ragged records into per-utterance rec dicts
    # (plane t+1 holds ends at time t; the final frame tr-1 comes from
    # the per-utterance final records). Insertion order (t asc, row asc,
    # compaction slot asc) matches the former per-frame loop exactly.
    recs: List[dict] = []
    for b in range(B):
        tr = lens[b]
        rec: dict = {}
        if counts[b] > M:
            HRError(8523, "generate_lattice_batch: %d in-beam records "
                          "exceed the device budget %d — weakest "
                          "dropped (raise k_rec or tighten "
                          "lattice_beam)", int(counts[b]), M)
        keep = rec_sc[b] > LSMALL
        if keep.any():
            idxs = rec_idx[b][keep]
            tt = idxs // K - 1  # plane index - 1 = end time
            kk = idxs % K
            ixs = rec_ix[b][keep]
            scs = rec_sc[b][keep].astype(np.float64)
            pred = rec_pred[b][keep]
            pns = (pred >> REC_TBITS).astype(np.int64) - 1
            pts = (pred & REC_TMASK).astype(np.int64) - 1
            order = np.lexsort((kk, ixs, tt))
            rec.update(zip(
                zip(ixs[order].tolist(), tt[order].tolist()),
                zip(scs[order].tolist(), pns[order].tolist(),
                    pts[order].tolist())))
        row_sc = scf_k[b]
        # final compaction is ranked by raw+exit-LM total, so the raw
        # max may sit anywhere among the kept K
        bestf = row_sc.max()
        if bestf > LSMALL:
            keepf = np.nonzero((row_sc > LSMALL)
                               & (row_sc >= bestf - lattice_beam))[0]
            keepf = keepf[np.argsort(ixf_k[b, keepf], kind="stable")]
            for k in keepf:
                rec[(int(ixf_k[b, k]), tr - 1)] = (
                    float(row_sc[k]), int(pnf_k[b, k]), int(ptf_k[b, k]))
        recs.append(rec)

    # pass 2: transitively resurrect beam-dropped predecessors for the
    # WHOLE batch — one stacked device gather per wave, not one per
    # utterance. The seed wave (which
    # records point at a pruned predecessor) is found vectorised with
    # one packed-key membership test per utterance; usually it is empty
    # and the whole wave loop is skipped.
    frontier = []
    for b, rec in enumerate(recs):
        if not rec:
            continue
        ka = np.asarray(list(rec), np.int64).reshape(len(rec), 2)
        va = np.asarray(list(rec.values()), np.float64).reshape(
            len(rec), 3)
        pn_b = va[:, 1].astype(np.int64)
        pt_b = va[:, 2].astype(np.int64)
        pks = np.sort(ka[:, 0] * _REC_PK + (ka[:, 1] + 2))
        m = pn_b >= 0
        pp = pn_b[m] * _REC_PK + (pt_b[m] + 2)
        pos = np.searchsorted(pks, pp)
        nb = pks.size
        ok = (pos < nb) & (pks[np.minimum(pos, nb - 1)] == pp)
        for j in np.nonzero(m)[0][~ok].tolist():
            frontier.append((b, (int(ka[j, 0]), int(ka[j, 1]))))
    while frontier:
        need = []
        referrers: dict = {}
        for b, key in frontier:
            _s, pn, pt = recs[b][key]
            if pn < 0 or (pn, pt) in recs[b]:
                continue
            k2 = (b, pn, pt)
            if k2 not in referrers:
                referrers[k2] = []
                need.append(k2)
            referrers[k2].append(key)
        if not need:
            break
        bs = np.asarray([k[0] for k in need], np.int32)
        pns = np.asarray([k[1] for k in need], np.int32)
        pts = np.asarray([k[2] for k in need], np.int32)
        trip = np.asarray(jnp.stack([
            WEs_d[bs, pts + 1, pns].astype(jnp.float32),
            pwns_d[bs, pts + 1, pns].astype(jnp.float32),
            pwts_d[bs, pts + 1, pns].astype(jnp.float32)]))
        frontier = []
        for (b, pn, pt), s, a, c in zip(need, *trip):
            if s <= LSMALL:
                # genuinely unavailable: sever so the arc is dropped,
                # not misattached to the utterance start
                for key in referrers[(b, pn, pt)]:
                    recs[b][key] = (recs[b][key][0], -1, -2)
                continue
            recs[b][(pn, pt)] = (float(s), int(a), int(c))
            frontier.append((b, (pn, pt)))

    def _severed(pairs):
        # every resolvable record is already in rec (pass 2)
        return [None] * len(pairs)

    # pass 3: lattices (+ 1-bests) from the completed record sets
    out = []
    for b in range(B):
        tr = lens[b]
        rec = recs[b]
        if not rec:
            out.append((None, None) if want_results else None)
            continue
        res = None
        if want_results:
            # best COMPLETE path: the device compaction ranks final
            # records by word-end + exit-LM total, so the true 1-best is
            # always inside the top-K and this argmax matches the
            # sequential _finalize exactly (ADVICE r4 item 2)
            end_exit = np.asarray(net.end_exit, np.float64)
            fsc = (scf_k[b].astype(np.float64)
                   + end_exit[ixf_k[b]] * float(lm_scale))
            j = int(np.argmax(np.where(scf_k[b] > LSMALL, fsc, LZERO)))
            if scf_k[b, j] > LSMALL and fsc[j] > LSMALL:
                node, t = int(ixf_k[b, j]), tr - 1
                pn, pt = int(pnf_k[b, j]), int(ptf_k[b, j])
                chain = []
                while True:
                    chain.append((node, pt + 1, t))
                    if pn < 0 or pt < 0:
                        break
                    node, t = pn, pt
                    got = rec.get((node, t))
                    if got is None:  # pragma: no cover - resolved above
                        break
                    _s, pn, pt = got
                    pn, pt = int(pn), int(pt)
                chain.reverse()
                res = _result_from_chain(net, chain, float(fsc[j]))
        lat = _lattice_from_rec(net, rec, None, tr,
                                frame_period_s, lm_scale, word_pen,
                                resolve_many=_severed,
                                max_preds=max_preds,
                                arc_beam=lattice_beam)
        out.append((lat, res) if want_results else lat)
    return out


def _generate_lattice_batch_generic(net, comp, feats_list, lm_scale,
                                    word_pen, lattice_beam,
                                    frame_period_s, precision, beam,
                                    max_active, pad_to,
                                    state_scores_list, model_params,
                                    max_preds, want_results):
    """Batched lattice generation for GENERAL (non-uniform) networks —
    the HVite -z bucket path: one padded scan for the whole bucket, then
    the shared per-utterance plane walk. Identical output to sequential
    generate_lattice (the plane slices at each utterance's own t_real
    are exactly the unpadded planes; tested)."""
    B = len(feats_list)
    state_mode = state_scores_list is not None
    src = state_scores_list if state_mode else feats_list
    lens = [int(f.shape[0]) for f in src]
    T = ((max(lens) + pad_to - 1) // pad_to) * pad_to
    mp = (None if model_params is None else
          tuple(jnp.asarray(model_params[k], jnp.float32)
                for k in ("means", "variances", "gconsts")))
    if state_mode:
        Ns = len(np.asarray(net.comp_state))
        ob = np.full((B, T, Ns), LZERO, np.float32)
        cs = np.asarray(net.comp_state)
        for b, s in enumerate(state_scores_list):
            ob[b, : lens[b]] = np.asarray(s, np.float32)[:, cs]
        outp = jnp.asarray(ob)
    else:
        D = src[0].shape[1]
        fb = np.zeros((B, T, D), np.float32)
        for b, f in enumerate(src):
            fb[b, : lens[b]] = f
        outp = jax.vmap(
            lambda x: _net_outp(net, comp, x, precision, mp=mp))(
            jnp.asarray(fb))
    (vb, wnb, wtb), (WEb, pwnb, pwtb) = run_decode_batch(
        outp, net, lm_scale, word_pen, beam=beam, max_active=max_active)
    WEb = np.asarray(WEb)
    pwnb = np.asarray(pwnb)
    pwtb = np.asarray(pwtb)
    out = []
    for b in range(B):
        tr = lens[b]
        if tr == T:
            carry, fin = (vb[b], wnb[b], wtb[b]), None
        else:
            # ends at time tr-1 were emitted by scan step tr
            carry, fin = None, (WEb[b, tr], pwnb[b, tr], pwtb[b, tr])
        out.append(_lattice_from_host_planes(
            net, WEb[b, :tr], pwnb[b, :tr], pwtb[b, :tr], carry, fin,
            tr, lattice_beam, frame_period_s, lm_scale, word_pen,
            want_results, max_preds))
    if not want_results:
        return out
    return [(r if isinstance(r, tuple) else (r, None)) for r in out]
