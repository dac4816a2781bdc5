"""Embedded Baum-Welch forward-backward as log-space device scans.

The device replacement for `HTKLib/HFB.c` (SURVEY.md §3.2): instead of
per-frame pointer-chasing over a composite HMM with beam pruning, the
whole utterance runs as three `lax.scan`s over dense (Q,) state vectors:

  1. backward scan  -> beta_t               (logsumexp-semiring matvec)
  2. forward scan   -> alpha_t, logP
  3. accumulation scan -> xi transition counts (Q, Q)

then mixture occupancies L_jm(t) reduce onto the physical Gaussian block
with two matmuls ((Q*maxmix, T) @ (T, D)) and segment-sums implement
HTK's tied-parameter accumulator sharing. No pruning: at north-star sizes
(Q <= ~512) dense compute is simpler than any sparse bookkeeping,
and results match un-pruned HTK (beams only ever drop negligible mass).

Everything here is jit/vmap-compatible with static (T, Q, maxmix) shapes;
tools bucket utterances to limit retraces.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.outp import mix_scores, pack_gaussians, state_outp
from ..utils.logmath import LZERO, MINLOGEXP, exp_or_zero, ladd_reduce


class Accumulators(NamedTuple):
    """HTK's MuAcc/VaAcc/WtAcc/TrAcc as one pytree (HTrain.c role)."""

    occ: jnp.ndarray  # (M,) mixture occupancies
    sum_x: jnp.ndarray  # (M, D) occupancy-weighted feature sums
    sum_xx: jnp.ndarray  # (M, D) occupancy-weighted squared sums
    wt_occ: jnp.ndarray  # (S, maxmix) per-state mixture occupancies
    tr: jnp.ndarray  # (TR_FLAT,) transition counts (flat (Tn, Nmax, Nmax))
    total_logp: jnp.ndarray  # () sum of per-utterance log likelihoods
    total_frames: jnp.ndarray  # () total frames accumulated
    n_utts: jnp.ndarray  # () utterances accumulated


def zero_accs(n_mix: int, dim: int, n_states: int, max_mix: int, tr_flat: int):
    return Accumulators(
        occ=jnp.zeros(n_mix, jnp.float32),
        sum_x=jnp.zeros((n_mix, dim), jnp.float32),
        sum_xx=jnp.zeros((n_mix, dim), jnp.float32),
        wt_occ=jnp.zeros((n_states, max_mix), jnp.float32),
        tr=jnp.zeros(tr_flat, jnp.float32),
        total_logp=jnp.zeros((), jnp.float32),
        total_frames=jnp.zeros((), jnp.float32),
        n_utts=jnp.zeros((), jnp.float32),
    )


def _gathered_mix_scores(feats, st_mix, means, variances, gconsts,
                         precision: str = "highest"):
    """Per-Gaussian log-likelihoods for ONLY the Gaussians a composite
    touches: (T, D) frames x (Q, slots) physical mixture ids ->
    (T, Q, slots) scores.

    The dense path scores all M physical Gaussians ((T, M), right when a
    big composite touches a good fraction of the set) — but an MMI arc
    mini-utterance touches ~Q*maxmix ~ 128 of 16k+, and at arc-batch
    widths the vmapped (B, T, M) plane is gigabytes (the round-5 MMI
    RESOURCE_EXHAUSTED). Row-gather the (M, 2D) weight block per
    utterance, then one (T, 2D) @ (2D, Q*slots) matmul.
    """
    T = feats.shape[0]
    Q, slots = st_mix.shape
    Wt, c = pack_gaussians(means, variances, gconsts)  # (2D, M), (M,)
    idx = jnp.maximum(st_mix, 0).reshape(-1)  # (Q*slots,)
    Wg = Wt.T[idx]  # (Q*slots, 2D) — contiguous row gather
    cg = c[idx]
    featx = jnp.concatenate([feats * feats, feats], axis=-1)  # (T, 2D)
    quad = jnp.matmul(featx, Wg.T, precision=precision)  # (T, Q*slots)
    return (-0.5 * (quad + cg[None, :])).reshape(T, Q, slots)


def _ladd_matvec_left(alpha: jnp.ndarray, logA: jnp.ndarray) -> jnp.ndarray:
    """pred[j] = logsumexp_i alpha[i] + logA[i, j] (HTK LAdd clamping)."""
    return ladd_reduce(alpha[:, None] + logA, axis=0)


def _ladd_matvec_right(v: jnp.ndarray, logA: jnp.ndarray) -> jnp.ndarray:
    """out[i] = logsumexp_j logA[i, j] + v[j]."""
    return ladd_reduce(logA + v[None, :], axis=1)


def forward_scan(outp, logA, a0, t_real, betas=None):
    """alpha_t for t = 0..T-1 (HFB.c StepAlpha); (T, Q) stacked.

    With `betas` given (beam-pruned FB, HERest -t), each alpha_t is
    confined to the beta-active band: HFB computes the alpha pass only
    over the columns the pruned beta pass kept alive, so states whose
    beta was beamed away get alpha = LZERO and zero occupancy.
    """
    T, Q = outp.shape

    def step(alpha, inp):
        outp_t, t, beta_t = inp
        pred = _ladd_matvec_left(alpha, logA)
        alpha_new = jnp.where(t == 0, a0, pred) + outp_t
        if betas is not None:
            alpha_new = jnp.where(beta_t > LZERO / 2, alpha_new, LZERO)
        return alpha_new, alpha_new

    # init derives from outp so its sharding/varying axes match the data
    # (required for scan carries under shard_map)
    init = jnp.full_like(outp[0], LZERO)
    bx = betas if betas is not None else jnp.zeros((T, 1), outp.dtype)
    _, alphas = jax.lax.scan(step, init, (outp, jnp.arange(T), bx))
    return alphas


def backward_scan(outp, logA, aE, t_real, beam=None):
    """beta_t for t = 0..T-1 (HFB.c SetBeta); (T, Q) stacked.

    beta at the true last frame (t_real-1) is aE; the recursion resets
    there so padding frames beyond t_real never contaminate real betas.
    `beam` (traced scalar or None) applies HFB's pruning: states whose
    beta falls below the frame's best by more than the beam die (LZERO),
    bounding the survivor band exactly as HERest -t does.
    """
    T, Q = outp.shape
    outp_next = jnp.concatenate([outp[1:], jnp.zeros((1, Q), outp.dtype)], axis=0)
    is_last = jnp.arange(T) == (t_real - 1)

    def step(beta_next, inp):
        o_next, last = inp
        val = _ladd_matvec_right(o_next + beta_next, logA)
        beta_t = jnp.where(last, aE, val)
        if beam is not None:
            beta_t = jnp.where(beta_t < jnp.max(beta_t) - beam,
                               LZERO, beta_t)
        return beta_t, beta_t

    _, betas_rev = jax.lax.scan(
        step,
        jnp.full_like(outp[0], LZERO),
        (outp_next[::-1], is_last[::-1]),
    )
    return betas_rev[::-1]


def xi_scan(alphas, betas, outp, logA, logp, t_real):
    """Summed transition posteriors xi[i,j] (the TrAcc integrand).

    xi_sum[i,j] = sum_{t<t_real-1} exp(alpha_t[i] + A[i,j]
                                       + outp_{t+1}[j] + beta_{t+1}[j] - logP)
    """
    T, Q = outp.shape
    tgt = jnp.concatenate(
        [outp[1:] + betas[1:], jnp.full((1, Q), LZERO, outp.dtype)], axis=0
    )
    valid = (jnp.arange(T) < (t_real - 1)).astype(outp.dtype)

    def step(acc, inp):
        alpha_t, tgt_t, v = inp
        term = exp_or_zero(alpha_t[:, None] + logA + tgt_t[None, :] - logp)
        return acc + term * v, None

    xi, _ = jax.lax.scan(step, jnp.zeros_like(logA), (alphas, tgt, valid))
    return xi


def _fb_core(
    feats,  # (T, D)
    t_real,  # () int32
    comp_state,  # (Q,) int32 physical state ids (trash row for padding)
    q_mask,  # (Q,) bool
    logA,  # (Q, Q)
    a0,  # (Q,)
    aE,  # (Q,)
    feats2=None,  # (T, D2) single-pass retraining second channel
    *,
    means,
    variances,
    gconsts,
    state_mix,  # (S, n_slots)
    state_logw,
    state_sw=None,  # (S, n_slots) stream-weight exponents (None = ones)
    slot_blocks=None,  # per-stream slot ranges; None/1 block = single stream
    precision: str = "highest",
    fc_proj=None,  # (M, D, D) full-covariance precision Cholesky
    fc_mu=None,  # (M, D) transformed means (FULLC training)
    beam=None,  # traced scalar: HFB beta-beam pruning (HERest -t)
    gather_outp: bool = False,  # score only the touched Gaussians
):
    """FB scans + occupancy moments for one utterance, *pre-scatter*.

    The shared front half of fb_utterance/fb_batch: everything up to
    (but excluding) the segment-sum scatter onto physical accumulators,
    so a batched caller can defer the scatter and do it ONCE over the
    whole batch instead of materialising (B, M, D) per-utterance
    accumulators (the memory/launch cliff that bounded MMI arc batches
    to 16).

    Returns (logp, occ_qm (Q, maxmix), sum_x_qm (Q*maxmix, D2),
    sum_xx_qm, xi (Q, Q), entry_occ (Q,), exit_occ (Q,)).
    """
    T, D = feats.shape
    Q = comp_state.shape[0]
    maxmix = state_mix.shape[1]
    M = means.shape[0]
    blocks = list(slot_blocks) if slot_blocks else [(0, maxmix)]

    # 1. observation likelihoods for the states this utterance touches
    st_mix = state_mix[comp_state]  # (Q, n_slots)
    st_logw = state_logw[comp_state]
    if fc_proj is not None:
        from ..ops.outp import full_cov_mix_scores

        mix_lp = full_cov_mix_scores(feats, fc_proj, fc_mu, gconsts,
                                     precision=precision)
        gathered = mix_lp[:, jnp.maximum(st_mix, 0)]  # (T, Q, n_slots)
    elif gather_outp:
        gathered = _gathered_mix_scores(feats, st_mix, means, variances,
                                        gconsts, precision=precision)
    else:
        Wt, c = pack_gaussians(means, variances, gconsts)
        mix_lp = mix_scores(feats, Wt, c, precision=precision)  # (T, M)
        gathered = mix_lp[:, jnp.maximum(st_mix, 0)]  # (T, Q, n_slots)
    weighted = jnp.where(st_mix[None] >= 0, gathered + st_logw[None], LZERO)
    # per-stream log b_js (unweighted) and the stream-weighted state outp
    b_stream = [ladd_reduce(weighted[:, :, j0:j1], axis=-1)
                for (j0, j1) in blocks]  # each (T, Q)
    if state_sw is None:
        outp = b_stream[0]
        for bs in b_stream[1:]:
            outp = outp + bs
    else:
        st_sw = state_sw[comp_state]  # (Q, n_slots)
        outp = None
        for (j0, _j1), bs in zip(blocks, b_stream):
            term = bs * st_sw[None, :, j0]
            outp = term if outp is None else outp + term
    outp = jnp.where(q_mask[None, :], outp, LZERO)

    # 2. scans
    betas = backward_scan(outp, logA, aE, t_real, beam=beam)
    alphas = forward_scan(outp, logA, a0, t_real,
                          betas=betas if beam is not None else None)
    alpha_last = alphas[jnp.maximum(t_real - 1, 0)]
    logp = ladd_reduce(alpha_last + aE, axis=0)

    t_mask = (jnp.arange(T) < t_real).astype(feats.dtype)

    # 3. state/mixture occupancies: within each stream the slot posterior
    # normalises by that stream's own b_js (HFB.c L_jsm semantics)
    gamma = alphas + betas - logp  # (T, Q) log domain
    if len(blocks) == 1:
        bnorm = b_stream[0][:, :, None]
    else:
        bnorm = jnp.concatenate(
            [jnp.broadcast_to(bs[:, :, None], (T, Q, j1 - j0))
             for (j0, j1), bs in zip(blocks, b_stream)], axis=2,
        )
    l_log = gamma[:, :, None] + st_logw[None] + gathered - bnorm
    l_log = jnp.where(st_mix[None] >= 0, l_log, LZERO)
    L = exp_or_zero(l_log) * t_mask[:, None, None]  # (T, Q, n_slots)

    occ_qm = jnp.sum(L, axis=0)  # (Q, maxmix)
    Lf = L.reshape(T, Q * maxmix)
    # single-pass retraining (HERest -r): occupancies come from the
    # alignment channel (feats), moment statistics from the new one
    xfeat = feats if feats2 is None else feats2
    sum_x_qm = jnp.matmul(Lf.T, xfeat, precision=precision)  # (Q*maxmix, D2)
    sum_xx_qm = jnp.matmul(Lf.T, xfeat * xfeat, precision=precision)

    # 4. transition posteriors
    xi = xi_scan(alphas, betas, outp, logA, logp, t_real)  # (Q, Q)
    entry_occ = exp_or_zero(a0 + outp[0] + betas[0] - logp)  # (Q,)
    exit_occ = exp_or_zero(alpha_last + aE - logp)

    return logp, occ_qm, sum_x_qm, sum_xx_qm, xi, entry_occ, exit_occ


def fb_utterance(
    feats,  # (T, D)
    t_real,  # () int32
    comp_state,  # (Q,) int32 physical state ids (trash row for padding)
    q_mask,  # (Q,) bool
    logA,  # (Q, Q)
    a0,  # (Q,)
    aE,  # (Q,)
    tr_seg,  # (Q, Q) int32 flat cells, -1 = cross/invalid
    entry_seg,  # (Q,) int32
    exit_seg,  # (Q,) int32
    weight=1.0,  # () scalar: accumulator weight (MMI arc posteriors)
    feats2=None,  # (T, D2) single-pass retraining second channel
    *,
    means,
    variances,
    gconsts,
    state_mix,  # (S, n_slots)
    state_logw,
    state_sw=None,  # (S, n_slots) stream-weight exponents (None = ones)
    slot_blocks=None,  # per-stream slot ranges; None/1 block = single stream
    n_states: int,
    tr_flat: int,
    precision: str = "highest",
    fc_proj=None,  # (M, D, D) full-covariance precision Cholesky
    fc_mu=None,  # (M, D) transformed means (FULLC training)
    beam=None,  # traced scalar: HFB beta-beam pruning (HERest -t)
) -> Tuple[jnp.ndarray, Accumulators]:
    """Forward-backward + accumulation for one utterance (HFB.c FBUtt)."""
    # state_mix may carry a trailing trash row for padded composite states;
    # n_states is the true physical state count for accumulator shapes.
    S = n_states
    maxmix = state_mix.shape[1]
    M = means.shape[0]
    logp, occ_qm, sum_x_qm, sum_xx_qm, xi, entry_occ, exit_occ = _fb_core(
        feats, t_real, comp_state, q_mask, logA, a0, aE, feats2=feats2,
        means=means, variances=variances, gconsts=gconsts,
        state_mix=state_mix, state_logw=state_logw, state_sw=state_sw,
        slot_blocks=slot_blocks, precision=precision,
        fc_proj=fc_proj, fc_mu=fc_mu, beam=beam,
    )
    st_mix = state_mix[comp_state]  # (Q, n_slots)

    flat_mix = jnp.where(st_mix >= 0, st_mix, M).reshape(-1)  # (Q*maxmix,)
    occ = jax.ops.segment_sum(occ_qm.reshape(-1), flat_mix, M + 1)[:M]
    sum_x = jax.ops.segment_sum(sum_x_qm, flat_mix, M + 1)[:M]
    sum_xx = jax.ops.segment_sum(sum_xx_qm, flat_mix, M + 1)[:M]

    state_seg = jnp.where(q_mask & (comp_state < S), comp_state, S)  # (Q,)
    wt_occ = jax.ops.segment_sum(occ_qm, state_seg, S + 1)[:S]

    within = (tr_seg >= 0).astype(feats.dtype)
    tr_within = jax.ops.segment_sum(
        xi.reshape(-1), jnp.where(tr_seg >= 0, tr_seg, tr_flat).reshape(-1),
        tr_flat + 1,
    )[:tr_flat]
    cross_in = jnp.sum(xi * (1.0 - within), axis=0) + entry_occ  # (Q,)
    cross_out = jnp.sum(xi * (1.0 - within), axis=1) + exit_occ
    tr_entry = jax.ops.segment_sum(
        cross_in, jnp.where(entry_seg >= 0, entry_seg, tr_flat), tr_flat + 1
    )[:tr_flat]
    tr_exit = jax.ops.segment_sum(
        cross_out, jnp.where(exit_seg >= 0, exit_seg, tr_flat), tr_flat + 1
    )[:tr_flat]
    tr = tr_within + tr_entry + tr_exit

    n_frames = t_real.astype(jnp.float32)
    ok = (logp > LZERO / 2).astype(jnp.float32)  # drop failed utterances
    w = ok * weight
    accs = Accumulators(
        occ=occ * w,
        sum_x=sum_x * w,
        sum_xx=sum_xx * w,
        wt_occ=wt_occ * w,
        tr=tr * w,
        total_logp=logp * ok,
        total_frames=n_frames * ok,
        n_utts=ok,
    )
    return logp, accs



def _stream_outp(weighted, blocks, st_sw):
    """(T, Q, n_slots) weighted slot scores -> (b_stream list, outp)."""
    b_stream = [ladd_reduce(weighted[:, :, j0:j1], axis=-1)
                for (j0, j1) in blocks]
    if st_sw is None:
        outp = b_stream[0]
        for bs in b_stream[1:]:
            outp = outp + bs
    else:
        outp = None
        for (j0, _j1), bs in zip(blocks, b_stream):
            term = bs * st_sw[None, :, j0]
            outp = term if outp is None else outp + term
    return b_stream, outp


def mix_posteriors_utterance(
    feats, t_real, comp_state, q_mask, logA, a0, aE,
    *, means, variances, gconsts, state_mix, state_logw,
    state_sw=None, slot_blocks=None,
    precision: str = "highest",
    fc_proj=None, fc_mu=None,
):
    """Per-frame physical-Gaussian posteriors gamma (T, M) for one
    utterance — the adaptation-statistics front half of fb_utterance."""
    T, D = feats.shape
    M = means.shape[0]
    maxmix = state_mix.shape[1]
    Q = comp_state.shape[0]
    blocks = list(slot_blocks) if slot_blocks else [(0, maxmix)]
    if fc_proj is not None:
        from ..ops.outp import full_cov_mix_scores

        mix_lp = full_cov_mix_scores(feats, fc_proj, fc_mu, gconsts,
                                     precision=precision)
    else:
        Wt, c = pack_gaussians(means, variances, gconsts)
        mix_lp = mix_scores(feats, Wt, c, precision=precision)
    st_mix = state_mix[comp_state]
    st_logw = state_logw[comp_state]
    st_sw = state_sw[comp_state] if state_sw is not None else None
    gathered = mix_lp[:, jnp.maximum(st_mix, 0)]
    weighted = jnp.where(st_mix[None] >= 0, gathered + st_logw[None], LZERO)
    b_stream, outp = _stream_outp(weighted, blocks, st_sw)
    outp = jnp.where(q_mask[None, :], outp, LZERO)
    betas = backward_scan(outp, logA, aE, t_real)
    alphas = forward_scan(outp, logA, a0, t_real)
    alpha_last = alphas[jnp.maximum(t_real - 1, 0)]
    logp = ladd_reduce(alpha_last + aE, axis=0)
    t_mask = (jnp.arange(T) < t_real).astype(feats.dtype)
    gamma = alphas + betas - logp
    if len(blocks) == 1:
        bnorm = b_stream[0][:, :, None]
    else:
        bnorm = jnp.concatenate(
            [jnp.broadcast_to(bs[:, :, None], (T, Q, j1 - j0))
             for (j0, j1), bs in zip(blocks, b_stream)], axis=2)
    l_log = gamma[:, :, None] + st_logw[None] + gathered - bnorm
    l_log = jnp.where(st_mix[None] >= 0, l_log, LZERO)
    L = exp_or_zero(l_log) * t_mask[:, None, None]  # (T, Q, n_slots)
    flat_mix = jnp.where(st_mix >= 0, st_mix, M).reshape(-1)
    # scatter (T, Q*maxmix) -> (T, M)
    Lf = L.reshape(T, Q * maxmix)
    gamma_m = jax.ops.segment_sum(Lf.T, flat_mix, M + 1)[:M].T  # (T, M)
    return logp, gamma_m


def loglik_utterance(
    feats, t_real, comp_state, q_mask, logA, a0, aE,
    *, means, variances, gconsts, state_mix, state_logw,
    state_sw=None, slot_blocks=None,
    precision: str = "highest",
    gather_outp: bool = False,
):
    """Forward-pass log-likelihood only (no accumulation) — the cheap
    first pass of MMI arc scoring."""
    blocks = list(slot_blocks) if slot_blocks else [(0, state_mix.shape[1])]
    st_mix = state_mix[comp_state]
    st_logw = state_logw[comp_state]
    st_sw = state_sw[comp_state] if state_sw is not None else None
    if gather_outp:
        gathered = _gathered_mix_scores(feats, st_mix, means, variances,
                                        gconsts, precision=precision)
    else:
        Wt, c = pack_gaussians(means, variances, gconsts)
        mix_lp = mix_scores(feats, Wt, c, precision=precision)
        gathered = mix_lp[:, jnp.maximum(st_mix, 0)]
    weighted = jnp.where(st_mix[None] >= 0, gathered + st_logw[None], LZERO)
    _bs, outp = _stream_outp(weighted, blocks, st_sw)
    outp = jnp.where(q_mask[None, :], outp, LZERO)
    alphas = forward_scan(outp, logA, a0, t_real)
    alpha_last = alphas[jnp.maximum(t_real - 1, 0)]
    return ladd_reduce(alpha_last + aE, axis=0)


def loglik_batch(
    feats, t_real, comp_state, q_mask, logA, a0, aE,
    *, means, variances, gconsts, state_mix, state_logw,
    state_sw=None, slot_blocks=None,
    precision: str = "highest",
    gather_outp: bool = False,
):
    fn = functools.partial(
        loglik_utterance,
        means=means, variances=variances, gconsts=gconsts,
        state_mix=state_mix, state_logw=state_logw,
        state_sw=state_sw, slot_blocks=slot_blocks, precision=precision,
        gather_outp=gather_outp,
    )
    return jax.vmap(fn)(feats, t_real, comp_state, q_mask, logA, a0, aE)


def fb_batch(
    feats, t_real, comp_state, q_mask, logA, a0, aE, tr_seg, entry_seg, exit_seg,
    weights=None, feats2=None,
    *, means, variances, gconsts, state_mix, state_logw, n_states, tr_flat,
    state_sw=None, slot_blocks=None,
    precision: str = "highest",
    beam=None,
    gather_outp: bool = False,
):
    """vmapped forward-backward over a padded utterance batch.

    `weights` (B,) optionally scales each utterance's accumulators (the
    MMI lattice-arc posterior weighting). `feats2` (B, T, D2) optionally
    supplies the second channel for single-pass retraining (HERest -r).
    `beam` (traced scalar or None) enables HFB beta-beam pruning, shared
    by the whole batch. Returns (per-utterance logP (B,), summed
    Accumulators).

    Only the FB core is vmapped; the accumulator scatter runs ONCE over
    the flattened (B*Q*maxmix) batch. The per-utterance form scatters to
    full (M, D) accumulators inside the vmap, materialising (B, M, D)
    intermediates — 600+ MB at MMI arc-batch widths (B=256, M=16k) and
    the reason arc batches were stuck at 16.
    """
    B = feats.shape[0]
    if weights is None:
        weights = jnp.ones(B, feats.dtype)
    S = n_states
    maxmix = state_mix.shape[1]
    M = means.shape[0]
    fn = functools.partial(
        _fb_core,
        means=means,
        variances=variances,
        gconsts=gconsts,
        state_mix=state_mix,
        state_logw=state_logw,
        state_sw=state_sw,
        slot_blocks=slot_blocks,
        precision=precision,
        beam=beam,
        gather_outp=gather_outp,
    )
    if feats2 is None:
        logps, occ_qm, sum_x_qm, sum_xx_qm, xi, entry_occ, exit_occ = (
            jax.vmap(fn)(feats, t_real, comp_state, q_mask, logA, a0, aE))
    else:
        logps, occ_qm, sum_x_qm, sum_xx_qm, xi, entry_occ, exit_occ = (
            jax.vmap(fn)(feats, t_real, comp_state, q_mask, logA, a0, aE,
                         feats2))
    Q = comp_state.shape[1]
    D2 = sum_x_qm.shape[-1]

    # drop failed utterances AND all-padding rows (t_real == 0): a
    # padded row that carries a real composite id (the device-resident
    # arc path pads with composite 0) would otherwise contribute a real
    # logp to total_logp/n_utts
    ok = ((logps > LZERO / 2) & (t_real > 0)).astype(feats.dtype)
    w = ok * weights  # (B,)

    st_mix = state_mix[comp_state]  # (B, Q, maxmix)
    flat_mix = jnp.where(st_mix >= 0, st_mix, M).reshape(-1)  # (B*Q*maxmix,)
    occ_w = occ_qm * w[:, None, None]  # (B, Q, maxmix)
    occ = jax.ops.segment_sum(occ_w.reshape(-1), flat_mix, M + 1)[:M]
    sum_x = jax.ops.segment_sum(
        (sum_x_qm * w[:, None, None]).reshape(-1, D2), flat_mix, M + 1)[:M]
    sum_xx = jax.ops.segment_sum(
        (sum_xx_qm * w[:, None, None]).reshape(-1, D2), flat_mix, M + 1)[:M]

    state_seg = jnp.where(q_mask & (comp_state < S), comp_state, S)  # (B, Q)
    wt_occ = jax.ops.segment_sum(
        occ_w.reshape(-1, maxmix), state_seg.reshape(-1), S + 1)[:S]

    within = (tr_seg >= 0).astype(feats.dtype)  # (B, Q, Q)
    xi_w = xi * w[:, None, None]
    tr_within = jax.ops.segment_sum(
        xi_w.reshape(-1),
        jnp.where(tr_seg >= 0, tr_seg, tr_flat).reshape(-1),
        tr_flat + 1,
    )[:tr_flat]
    cross_in = jnp.sum(xi_w * (1.0 - within), axis=1) \
        + entry_occ * w[:, None]  # (B, Q)
    cross_out = jnp.sum(xi_w * (1.0 - within), axis=2) \
        + exit_occ * w[:, None]
    tr_entry = jax.ops.segment_sum(
        cross_in.reshape(-1),
        jnp.where(entry_seg >= 0, entry_seg, tr_flat).reshape(-1),
        tr_flat + 1,
    )[:tr_flat]
    tr_exit = jax.ops.segment_sum(
        cross_out.reshape(-1),
        jnp.where(exit_seg >= 0, exit_seg, tr_flat).reshape(-1),
        tr_flat + 1,
    )[:tr_flat]
    tr = tr_within + tr_entry + tr_exit

    summed = Accumulators(
        occ=occ,
        sum_x=sum_x,
        sum_xx=sum_xx,
        wt_occ=wt_occ,
        tr=tr,
        total_logp=jnp.sum(logps * ok),
        total_frames=jnp.sum(t_real.astype(jnp.float32) * ok),
        n_utts=jnp.sum(ok),
    )
    return logps, summed
