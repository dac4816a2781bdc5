"""Time-sharded forward-backward (SURVEY.md §5.7, built out).

The reference has nothing like this — `HTKLib/HFB.c` walks one frame at
a time and bounds *work* (beam pruning), not memory or latency. On a
device mesh the (log,+)-semiring α/β recursions are associative, so the
time axis itself can be sharded across devices: the long-context
strategy for audio far beyond utterance length (meetings, broadcast
archives) where one chip cannot hold the T×Q activations or a serial
scan's latency.

Blelloch-style three-phase algorithm under `shard_map`, time sharded
over the mesh. Write M_t for the per-frame semiring matrix
M_t[i,j] = logA[i,j] + outp_t[j]; row vectors α evolve as α_t = α_{t-1}
∘ M_t (α_0 = a0 + outp_0), and column vectors β as β_t = M_{t+1} ∘ …
∘ M_{T-1} ∘ aE. Then:

  1. **block operator** — each device scans its T/D frames carrying a
     (Q, Q) matrix: O_d = M_{t0} ⊗ … ⊗ M_{t1} (block 0 replaces M_0 by
     the rank-1 injection a0 + outp_0). For the banded logA of
     composite-utterance HMMs each product step costs K·Q² (column
     shifts, K = band width) — (K+1)× the plain vector scan's work,
     split D ways.
  2. **operator prefix/suffix** — all_gather the D small matrices and
     fold, per device, the exclusive prefix (for α: e₀ ∘ O_0 ⊗ … ⊗
     O_{d-1} gives the α entering the block) and the exclusive suffix
     (for β: O_{d+1} ⊗ … ⊗ O_{D-1} ∘ aE gives β at the block's last
     frame).
  3. **local rescan** — the ordinary per-frame vector scans, seeded by
     phase 2, emit this block's (T/D, Q) alphas and betas.

Transition posteriors ξ need the (outp+β) row just across each block
boundary — one `ppermute` shift; statistics are block-local sums +
`psum`, so downstream accumulation is unchanged.

Numerics: same operations as algo/fb.forward_scan/backward_scan up to
LSE re-association (operator products associate differently than vector
scans); agreement is asserted against the serial scans on an 8-device
CPU mesh in tests/test_timeshard.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..utils.logmath import LZERO, exp_or_zero, ladd_reduce


def _band_of(logA: np.ndarray, lsmall=-0.5e10) -> int:
    """Upper bandwidth K of a forward-only transition matrix."""
    iu, ju = np.nonzero(np.asarray(logA) > lsmall)
    if len(ju) == 0:
        return 1
    return int(np.max(ju - iu)) + 1


def _op_step_banded(X: jnp.ndarray, logA: jnp.ndarray, K: int) -> jnp.ndarray:
    """(X ⊗ A)[.., j] = LSE_k X[.., k] + logA[k, j] for banded A.

    Only k in [j-K+1, j] contribute; offset d uses column-shifted X plus
    the d-th superdiagonal of logA.
    """
    Q = X.shape[-1]
    terms = []
    for d in range(K):
        band_d = jnp.concatenate(
            [jnp.full((d,), LZERO, logA.dtype), jnp.diagonal(logA, offset=d)])
        Xs = jnp.concatenate(
            [jnp.full(X.shape[:-1] + (d,), LZERO, X.dtype), X[..., : Q - d]],
            axis=-1)
        terms.append(Xs + band_d)
    return ladd_reduce(jnp.stack(terms, axis=0), axis=0)


def _op_compose(X: jnp.ndarray, Y: jnp.ndarray) -> jnp.ndarray:
    """Dense semiring product (X ⊗ Y)[i,j] = LSE_k X[i,k] + Y[k,j]."""
    return ladd_reduce(X[:, :, None] + Y[None, :, :], axis=1)


def _identity_op(Q: int, dtype) -> jnp.ndarray:
    eye = jnp.arange(Q)
    return jnp.full((Q, Q), LZERO, dtype).at[eye, eye].set(0.0)


def fb_time_sharded(
    outp: jnp.ndarray,  # (T, Q) per-frame per-state log b; T = D * T_blk
    logA: jnp.ndarray,  # (Q, Q) forward-only (banded) transitions
    a0: jnp.ndarray,  # (Q,) entry log-probs
    aE: jnp.ndarray,  # (Q,) exit log-probs
    mesh: Mesh,
    axis: str = "t",
    K: Optional[int] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Time-sharded α/β/logP/ξ for one utterance of T frames.

    Returns (alphas (T, Q), betas (T, Q), logP (), xi_sum (Q, Q));
    alphas/betas stay sharded over `axis`. Semantics match
    algo/fb.forward_scan + backward_scan + xi_scan with t_real = T.
    """
    T, Q = outp.shape
    D = mesh.shape[axis]
    if T % D:
        raise ValueError(f"T={T} not divisible by mesh axis {axis}={D}")
    if K is None:
        K = _band_of(np.asarray(logA))

    logA_j = jnp.asarray(logA, jnp.float32)
    a0_j = jnp.asarray(a0, jnp.float32)
    aE_j = jnp.asarray(aE, jnp.float32)

    shard_fn = _make_block_fb(axis, T, Q, D, logA_j, a0_j, aE_j, K)
    spec_t = P(axis)
    fn = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(spec_t,),
        out_specs=(spec_t, spec_t, P(), P()),
    ))
    return fn(jnp.asarray(outp, jnp.float32))


def _make_block_fb(axis, T, Q, D, logA_j, a0_j, aE_j, K):
    """The per-device FB block body ((T/D, Q) -> block α/β/logP/ξ) with
    collectives over mesh axis `axis`; shared by the 1D time-sharded
    form and the 2D dp x t batched form (where it runs under vmap)."""

    def shard_fn(outp_blk):
        d = jax.lax.axis_index(axis)
        Tb = outp_blk.shape[0]
        ts = d * Tb + jnp.arange(Tb)
        # scan carries must be device-varying like the data they absorb
        # (shard_map VMA rule) — tie the inits to the block
        vary_row = 0.0 * outp_blk[0]
        ident = _identity_op(Q, outp_blk.dtype) + vary_row[None, :]

        # ---- phase 1: block operator O_d = ⊗_t M_t --------------------
        def op_step(X, inp):
            o_t, t = inp
            gen = _op_step_banded(X, logA_j, K) + o_t[None, :]
            rk1 = jnp.broadcast_to((a0_j + o_t)[None, :], (Q, Q))
            return jnp.where(t == 0, rk1, gen), None

        O_blk, _ = jax.lax.scan(op_step, ident, (outp_blk, ts))
        allO = jax.lax.all_gather(O_blk, axis)  # (D, Q, Q)

        # ---- phase 2: exclusive prefix (α) and suffix (β) --------------
        def fold(cond_fn):
            def step(X, k):
                Y = _op_compose(X, allO[k])
                return jax.lax.cond(cond_fn(k), lambda: Y, lambda: X), None

            out, _ = jax.lax.scan(step, ident, jnp.arange(D))
            return out

        prefix = fold(lambda k: k < d)   # O_0 ⊗ … ⊗ O_{d-1}
        suffix = fold(lambda k: k > d)   # O_{d+1} ⊗ … ⊗ O_{D-1}
        # α entering the block: e₀ ∘ prefix (block 0's rank-1 injection
        # makes row choice irrelevant beyond block 0)
        alpha_in = prefix[0]
        # β at the block's LAST frame: suffix ∘ aE (for the last device
        # suffix = identity, so this is aE itself — the true β_{T-1})
        beta_last = ladd_reduce(suffix + aE_j[None, :], axis=1)

        # ---- phase 3: local rescans ------------------------------------
        def a_step(alpha, inp):
            o_t, t = inp
            pred = ladd_reduce(alpha[:, None] + logA_j, axis=0)
            a_new = jnp.where(t == 0, a0_j + o_t, pred + o_t)
            return a_new, a_new

        _, alphas_blk = jax.lax.scan(a_step, alpha_in, (outp_blk, ts))

        # reversed local β scan; the block's last frame takes the
        # operator-derived seed, interior frames the plain recursion
        o_next = jnp.concatenate(
            [outp_blk[1:], jnp.zeros((1, Q), outp_blk.dtype)], axis=0)
        is_blk_last = jnp.arange(Tb) == (Tb - 1)

        def b_step(beta_next, inp):
            o_n, last = inp
            val = ladd_reduce(logA_j + (o_n + beta_next)[None, :], axis=1)
            beta_t = jnp.where(last, beta_last, val)
            return beta_t, beta_t

        _, betas_rev = jax.lax.scan(
            b_step, jnp.full((Q,), LZERO, outp_blk.dtype) + vary_row,
            (o_next[::-1], is_blk_last[::-1]))
        betas_blk = betas_rev[::-1]

        # ---- logP + ξ ----------------------------------------------------
        # LSE_i α_t[i] + β_t[i] is logP at every t; average the devices'
        # (re-association-level different) copies for a replicated value
        logp = jax.lax.pmean(
            ladd_reduce(alphas_blk[0] + betas_blk[0], axis=0), axis)

        tgt_local = outp_blk + betas_blk
        nxt_first = jax.lax.ppermute(
            tgt_local[0], axis, [(i, (i - 1) % D) for i in range(D)])
        tgt = jnp.concatenate([tgt_local[1:], nxt_first[None, :]], axis=0)
        valid = (ts < (T - 1)).astype(outp_blk.dtype)[:, None, None]
        xi_terms = exp_or_zero(
            alphas_blk[:, :, None] + logA_j[None, :, :]
            + tgt[:, None, :] - logp) * valid
        xi = jax.lax.psum(jnp.sum(xi_terms, axis=0), axis)

        return alphas_blk, betas_blk, logp, xi

    return shard_fn


def fb_time_sharded_batch(
    outp: jnp.ndarray,  # (B, T, Q); B = dp * B_loc, T = Dt * T_blk
    logA: jnp.ndarray,
    a0: jnp.ndarray,
    aE: jnp.ndarray,
    mesh: Mesh,
    dp_axis: str = "d",
    t_axis: str = "t",
    K: Optional[int] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """2D-mesh forward-backward: a batch of equal-length utterances
    data-parallel over `dp_axis` while every utterance's time axis is
    sharded over `t_axis` — long-context sequence parallelism composed
    with data-parallel training on one (dp, t) device mesh. The block
    body is shared with fb_time_sharded (vmapped over the local batch;
    the time-axis collectives ride inside the vmap).

    Returns (alphas (B, T, Q), betas (B, T, Q), logP (B,),
    xi_sum (B, Q, Q)); alphas/betas stay sharded over (dp, t).
    """
    B, T, Q = outp.shape
    Ddp = mesh.shape[dp_axis]
    Dt = mesh.shape[t_axis]
    if B % Ddp:
        raise ValueError(f"B={B} not divisible by mesh axis "
                         f"{dp_axis}={Ddp}")
    if T % Dt:
        raise ValueError(f"T={T} not divisible by mesh axis {t_axis}={Dt}")
    if K is None:
        K = _band_of(np.asarray(logA))

    logA_j = jnp.asarray(logA, jnp.float32)
    a0_j = jnp.asarray(a0, jnp.float32)
    aE_j = jnp.asarray(aE, jnp.float32)

    body = _make_block_fb(t_axis, T, Q, Dt, logA_j, a0_j, aE_j, K)
    fn = jax.jit(jax.shard_map(
        lambda blk: jax.vmap(body)(blk), mesh=mesh,
        in_specs=(P(dp_axis, t_axis, None),),
        out_specs=(P(dp_axis, t_axis), P(dp_axis, t_axis),
                   P(dp_axis), P(dp_axis)),
    ))
    return fn(jnp.asarray(outp, jnp.float32))
