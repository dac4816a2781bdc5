"""Device-side composite-HMM assembly.

Builds the dense composite arrays (logA/a0/aE/comp_state/masks/transition
segment maps) ON DEVICE from just the per-utterance model-id sequence —
the host then ships ~Kmax int32s per utterance instead of ~1 MB of padded
(Q, Q) planes.

Semantics match algo/composite.build_composite exactly (tested), including
tee chains: a block k links to any later block k2 when every intermediate
model is a tee, with the chain's entry->exit log-probs added; validity is
vectorised via a cumulative non-tee count, the chain weight via cumulative
tee log-prob sums.
"""

from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from ..models.hmmset import CompiledHMMSet
from ..utils.logmath import LZERO, LSMALL, ladd


def assemble_utterance(
    ids,  # (K,) int32 model ids, -1 padded
    *,
    model_states,  # (H+1, emax) int32 (trash row appended for id -1)
    log_transp,  # (Tn, nmax, nmax)
    model_transp,  # (H+1,) int32
    model_nstates,  # (H+1,) int32
    n_states: int,  # physical state count (trash id)
    nmax: int,
    emax: int,
):
    """One utterance's composite arrays from its model-id sequence."""
    K = ids.shape[0]
    Q = K * emax
    valid_k = ids >= 0
    safe = jnp.where(valid_k, ids, model_states.shape[0] - 1)

    lt = log_transp[model_transp[safe]]  # (K, nmax, nmax)
    n_k = model_nstates[safe]  # (K,)

    # per-block pieces
    en = lt[:, 0, 1 : 1 + emax]  # (K, emax)
    within = lt[:, 1 : 1 + emax, 1 : 1 + emax]  # (K, emax, emax)
    # exit column and tee prob are at column n_k-1 (model-dependent)
    exit_col = jnp.clip(n_k - 1, 0, nmax - 1)
    ex = jnp.take_along_axis(
        lt[:, 1 : 1 + emax, :], exit_col[:, None, None].repeat(emax, 1), axis=2
    )[:, :, 0]  # (K, emax)
    tee = jnp.take_along_axis(lt[:, 0, :], exit_col[:, None], axis=1)[:, 0]
    en = jnp.where(valid_k[:, None], en, LZERO)
    ex = jnp.where(valid_k[:, None], ex, LZERO)
    within = jnp.where(valid_k[:, None, None], within, LZERO)
    tee = jnp.where(valid_k, tee, LZERO)

    # composite states + mask
    st = model_states[safe]  # (K, emax) with -1 for dead slots
    comp_state = jnp.where((st >= 0) & valid_k[:, None], st, n_states)
    q_mask = (comp_state < n_states).reshape(Q)
    comp_state = comp_state.reshape(Q)

    # within-block logA: scatter (K, emax, emax) onto the block diagonal
    base = jnp.arange(K) * emax
    rows = (base[:, None, None] + jnp.arange(emax)[None, :, None])
    cols = (base[:, None, None] + jnp.arange(emax)[None, None, :])
    logA = jnp.full((Q, Q), LZERO, jnp.float32)
    logA = logA.at[rows, cols].set(within)

    # tee chains: valid k->k2 iff no non-tee strictly between them
    is_tee = tee > LSMALL
    has_states = valid_k & (st >= 0).any(axis=1)
    nontee = jnp.cumsum((~is_tee) & valid_k)  # counts incl. position
    cumtee = jnp.cumsum(jnp.where(is_tee, tee, 0.0))
    kk = jnp.arange(K)
    # chain(k, k2) = cumtee[k2-1] - cumtee[k]; valid needs all of
    # k+1..k2-1 tee: nontee[k2-1] == nontee[k]
    k2m1 = jnp.maximum(kk - 1, 0)
    chain_w = jnp.take(cumtee, k2m1)[None, :] - cumtee[:, None]
    chain_ok = (jnp.take(nontee, k2m1)[None, :] - nontee[:, None]) == 0
    pair_ok = (
        (kk[None, :] > kk[:, None]) & chain_ok
        & has_states[:, None] & has_states[None, :]
    )
    cross = jnp.where(
        pair_ok[:, :, None, None],
        ex[:, None, :, None] + chain_w[:, :, None, None] + en[None, :, None, :],
        LZERO,
    )  # (K, K2, emax_src, emax_dst)
    rows2 = (base[:, None, None, None] + jnp.arange(emax)[None, None, :, None])
    cols2 = (base[None, :, None, None] + jnp.arange(emax)[None, None, None, :])
    rows2 = jnp.broadcast_to(rows2, cross.shape)
    cols2 = jnp.broadcast_to(cols2, cross.shape)
    logA = logA.at[rows2, cols2].max(cross)

    # utterance entry/exit through leading/trailing tee chains
    lead_ok = (nontee - ((~is_tee) & valid_k).astype(nontee.dtype)) == 0
    lead_chain = cumtee - jnp.where(is_tee, tee, 0.0)
    a0 = jnp.where(
        (lead_ok & has_states)[:, None], lead_chain[:, None] + en, LZERO
    ).reshape(Q)
    total_nontee = nontee[-1]
    trail_ok = (total_nontee - nontee) == 0
    trail_chain = cumtee[-1] - cumtee
    aE = jnp.where(
        (trail_ok & has_states)[:, None], ex + trail_chain[:, None], LZERO
    ).reshape(Q)

    # transition accumulator segment maps
    tid = model_transp[safe]  # (K,)
    i_loc = jnp.arange(emax)
    tr_seg = (
        (tid[:, None, None] * nmax + (1 + i_loc)[None, :, None]) * nmax
        + (1 + i_loc)[None, None, :]
    )
    tr_full = jnp.full((Q, Q), -1, jnp.int32)
    tr_full = tr_full.at[rows, cols].set(
        jnp.where(valid_k[:, None, None], tr_seg, -1).astype(jnp.int32)
    )
    entry_seg = jnp.where(
        valid_k[:, None], tid[:, None] * nmax * nmax + (1 + i_loc)[None, :], -1
    ).reshape(Q).astype(jnp.int32)
    exit_seg = jnp.where(
        valid_k[:, None],
        (tid[:, None] * nmax + (1 + i_loc)[None, :]) * nmax
        + exit_col[:, None], -1,
    ).reshape(Q).astype(jnp.int32)
    # dead slots (st < 0) carry no accumulation
    dead = ~q_mask
    entry_seg = jnp.where(dead, -1, entry_seg)
    exit_seg = jnp.where(dead, -1, exit_seg)

    return dict(
        comp_state=comp_state, q_mask=q_mask, logA=logA, a0=a0, aE=aE,
        tr_seg=tr_full, entry_seg=entry_seg, exit_seg=exit_seg,
    )


def make_assembler(comp: CompiledHMMSet):
    """Batched device assembler closed over a compiled HMM set's tables."""
    emax = comp.nmax - 2
    H = comp.n_models
    model_states = jnp.asarray(
        np.concatenate([comp.model_states,
                        np.full((1, emax), -1, np.int32)], axis=0)
    )
    model_transp = jnp.asarray(
        np.concatenate([comp.model_transp, np.zeros(1, np.int32)])
    )
    model_nstates = jnp.asarray(
        np.concatenate([comp.model_nstates, np.full(1, 2, np.int32)])
    )
    log_transp = jnp.asarray(comp.log_transp)

    fn = functools.partial(
        assemble_utterance,
        model_states=model_states,
        log_transp=log_transp,
        model_transp=model_transp,
        model_nstates=model_nstates,
        n_states=comp.n_states,
        nmax=comp.nmax,
        emax=emax,
    )
    return jax.vmap(fn)
