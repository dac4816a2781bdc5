"""Baum-Welch for discrete (VQ) HMMs.

The DISCRETE observation model (HVQ/HModel.c discrete path): observations
are codeword indices per stream, b_j(o) = sum_s sw_js * logDProb_js[o_s].
Reuses the continuous engine's scans (algo/fb) — only the observation
lookup and the accumulators differ: codeword counts replace Gaussian
sufficient statistics, accumulated as one (Q, K) matmul against the
frame one-hots and segment-summed onto physical states.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.hmmset import CompiledHMMSet
from ..utils.errors import HError
from ..utils.logmath import LZERO, exp_or_zero, ladd_reduce
from .fb import backward_scan, forward_scan, xi_scan
from .trainer import UttData, make_batches, pad_batch


class DiscreteAccumulators(NamedTuple):
    counts: jnp.ndarray  # (S, K_total) codeword occupancies
    tr: jnp.ndarray  # (TR_FLAT,)
    total_logp: jnp.ndarray
    total_frames: jnp.ndarray
    n_utts: jnp.ndarray


def fb_discrete_utterance(
    idx,  # (T, n_streams) int32 codeword indices (1-based, 0 = pad)
    t_real, comp_state, q_mask, logA, a0, aE, tr_seg, entry_seg, exit_seg,
    weight=1.0,
    *, dprob_table, state_sw, dprob_blocks, n_states: int, tr_flat: int,
):
    T = idx.shape[0]
    Q = comp_state.shape[0]
    S = n_states
    Ktot = dprob_table.shape[1]

    # observation scores: per stream, table lookup by codeword
    outp_phys = None  # (T, S+1)
    for s, (k0, k1) in enumerate(dprob_blocks):
        col = jnp.clip(k0 + idx[:, s] - 1, k0, k1 - 1)  # (T,)
        term = dprob_table[:, col].T * state_sw[None, :, s]  # (T, S+1)
        outp_phys = term if outp_phys is None else outp_phys + term
    outp = outp_phys[:, jnp.minimum(comp_state, dprob_table.shape[0] - 1)]
    outp = jnp.where(q_mask[None, :], outp, LZERO)

    betas = backward_scan(outp, logA, aE, t_real)
    alphas = forward_scan(outp, logA, a0, t_real)
    alpha_last = alphas[jnp.maximum(t_real - 1, 0)]
    logp = ladd_reduce(alpha_last + aE, axis=0)
    t_mask = (jnp.arange(T) < t_real).astype(jnp.float32)
    gamma = exp_or_zero(alphas + betas - logp) * t_mask[:, None]  # (T, Q)

    # codeword counts: one-hot per stream -> (Q, K) matmul -> segment to S
    state_seg = jnp.where(q_mask & (comp_state < S), comp_state, S)
    counts = jnp.zeros((S + 1, Ktot), jnp.float32)
    for s, (k0, k1) in enumerate(dprob_blocks):
        onehot = (
            (k0 + idx[:, s] - 1)[:, None]
            == jnp.arange(k0, k1)[None, :]
        ).astype(jnp.float32)  # (T, K_s)
        cq = jnp.matmul(gamma.T, onehot, precision="highest")  # (Q, K_s)
        counts = counts.at[:, k0:k1].add(
            jax.ops.segment_sum(cq, state_seg, S + 1)
        )
    counts = counts[:S]

    xi = xi_scan(alphas, betas, outp, logA, logp, t_real)
    entry_occ = exp_or_zero(a0 + outp[0] + betas[0] - logp)
    exit_occ = exp_or_zero(alpha_last + aE - logp)
    within = (tr_seg >= 0).astype(jnp.float32)
    tr_within = jax.ops.segment_sum(
        xi.reshape(-1), jnp.where(tr_seg >= 0, tr_seg, tr_flat).reshape(-1),
        tr_flat + 1,
    )[:tr_flat]
    cross_in = jnp.sum(xi * (1.0 - within), axis=0) + entry_occ
    cross_out = jnp.sum(xi * (1.0 - within), axis=1) + exit_occ
    tr_entry = jax.ops.segment_sum(
        cross_in, jnp.where(entry_seg >= 0, entry_seg, tr_flat), tr_flat + 1
    )[:tr_flat]
    tr_exit = jax.ops.segment_sum(
        cross_out, jnp.where(exit_seg >= 0, exit_seg, tr_flat), tr_flat + 1
    )[:tr_flat]

    ok = (logp > LZERO / 2).astype(jnp.float32)
    w = ok * weight
    return logp, DiscreteAccumulators(
        counts=counts * w,
        tr=(tr_within + tr_entry + tr_exit) * w,
        total_logp=logp * ok,
        total_frames=t_real.astype(jnp.float32) * ok,
        n_utts=ok,
    )


class DiscreteTrainer:
    """Corpus accumulation for discrete HMM sets (HERest discrete path)."""

    def __init__(self, comp: CompiledHMMSet):
        if not comp.discrete:
            HError(7060, "DiscreteTrainer: continuous HMM set")
        self.comp = comp
        self.tr_flat = int(np.prod(comp.log_transp.shape))
        # pad one trash state row
        self.table_pad = np.concatenate(
            [comp.dprob_table,
             np.full((1, comp.dprob_table.shape[1]), LZERO, np.float32)],
            axis=0,
        )
        self.sw_pad = np.concatenate(
            [comp.state_sw[:, : comp.n_streams],
             np.ones((1, comp.n_streams), np.float32)], axis=0
        )
        self._step = None

    def _step_fn(self):
        if self._step is not None:
            return self._step
        blocks = tuple(self.comp.dprob_blocks)
        n_states = self.comp.n_states
        tr_flat = self.tr_flat

        @jax.jit
        def step(params, batch):
            table, sw = params
            fn = functools.partial(
                fb_discrete_utterance,
                dprob_table=table, state_sw=sw, dprob_blocks=blocks,
                n_states=n_states, tr_flat=tr_flat,
            )
            logps, accs = jax.vmap(fn)(
                batch["idx"], batch["t_real"], batch["comp_state"],
                batch["q_mask"], batch["logA"], batch["a0"], batch["aE"],
                batch["tr_seg"], batch["entry_seg"], batch["exit_seg"],
                jnp.ones(batch["idx"].shape[0], jnp.float32),
            )
            return logps, jax.tree.map(lambda a: jnp.sum(a, axis=0), accs)

        self._step = step
        return step

    def accumulate(self, utts, batch_size: int = 8, trace: int = 0):
        c = self.comp
        total = DiscreteAccumulators(
            counts=jnp.zeros_like(jnp.asarray(c.dprob_table)),
            tr=jnp.zeros(self.tr_flat, jnp.float32),
            total_logp=jnp.zeros(()), total_frames=jnp.zeros(()),
            n_utts=jnp.zeros(()),
        )
        step = self._step_fn()
        params = (jnp.asarray(self.table_pad), jnp.asarray(self.sw_pad))
        for batch in make_batches(utts, batch_size):
            arrs = pad_batch(batch, c.n_states)
            # features here are codeword indices (T, n_streams) int
            arrs["idx"] = arrs.pop("feats").astype(np.int32)
            logps, accs = step(params, {k: jnp.asarray(v)
                                        for k, v in arrs.items()})
            total = jax.tree.map(lambda a, b: a + b, total, accs)
        return total


def discrete_state_scores(comp: CompiledHMMSet, idx: np.ndarray) -> np.ndarray:
    """(T, n_streams) codeword indices -> (T, S_phys) log b_j (decode path)."""
    T = idx.shape[0]
    out = np.zeros((T, comp.dprob_table.shape[0]), np.float32)
    for s, (k0, k1) in enumerate(comp.dprob_blocks):
        col = np.clip(k0 + idx[:, s].astype(np.int64) - 1, k0, k1 - 1)
        out += comp.dprob_table[:, col].T * comp.state_sw[None, :, s]
    return out


def reestimate_discrete(comp: CompiledHMMSet, accs: DiscreteAccumulators,
                        floor: float = 1e-5):
    """Update codeword probs (per stream) and transitions."""
    counts = np.asarray(accs.counts, np.float64)
    new_table = comp.dprob_table.astype(np.float64).copy()
    for (k0, k1) in comp.dprob_blocks:
        blk = counts[:, k0:k1]
        tot = blk.sum(axis=1, keepdims=True)
        p = np.where(tot > 1e-3, blk / np.maximum(tot, 1e-30), np.nan)
        p = np.maximum(p, floor)
        p = p / p.sum(axis=1, keepdims=True)
        upd = np.log(p)
        new_table[:, k0:k1] = np.where(np.isnan(upd), new_table[:, k0:k1], upd)

    tn, nmax = comp.log_transp.shape[0], comp.nmax
    tr3 = np.asarray(accs.tr, np.float64).reshape(tn, nmax, nmax)
    row = tr3.sum(axis=2, keepdims=True)
    old = np.where(comp.log_transp <= -0.5e10, 0.0,
                   np.exp(np.maximum(comp.log_transp, -745.0)))
    new_tr = np.where(row > 1e-3, tr3 / np.maximum(row, 1e-30), old)
    new_tr[:, -1, :] = 0.0
    rs = new_tr.sum(axis=2, keepdims=True)
    new_tr = np.where(rs > 0, new_tr / np.maximum(rs, 1e-30), 0.0)
    return new_table.astype(np.float32), new_tr.astype(np.float32)
