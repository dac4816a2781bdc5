"""Full-covariance embedded reestimation (HERest for FULLC sets).

`HTKLib/HFB.c` + `HERest.c : UpdateModels()` support FULLC Gaussians by
accumulating full second-moment matrices; round 1 limited FULLC to
decode/align. This module closes that gap with a dedicated path — FULLC
sets are small in practice (full matrices are D² parameters per
Gaussian), so a per-utterance device pass with host f64 accumulation is
the right shape:

  1. fb_utterance with the full-covariance scorer (fc_proj/fc_mu) gives
     the standard accumulators (occ, Σγx, weights, transitions);
  2. a second pass reuses the same gammas for the (M, D, D) outer-
     product sums Σ γ x xᵀ (one einsum);
  3. the update is μ = Σγx/occ, Σ = ΣγxxT/occ − μμᵀ (+ diagonal
     loading), stored back as the INVERSE covariance (<INVCOVAR>, the
     MMF convention) with a fresh gConst, then the set recompiles.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.hmmset import CompiledHMMSet, compile_hmmset
from ..utils.errors import HError, HRError
from ..utils.logmath import LZERO
from .fb import fb_utterance, mix_posteriors_utterance
from .reestimate import MINOCC, UpdateFlags, reestimate
from .trainer import UttData, pad_batch


def fullcov_accumulate(comp: CompiledHMMSet, utts: Sequence[UttData],
                      trace: int = 0):
    """One corpus pass: standard Accumulators + Σ γ x xᵀ (M, D, D) f64."""
    if not comp.full_cov:
        HError(7060, "fullcov_accumulate: set is not full-covariance")
    M, D = comp.means.shape
    sm_pad = np.concatenate(
        [comp.state_mix, np.full((1, comp.max_mix), -1, np.int32)], axis=0)
    lw_pad = np.concatenate(
        [comp.state_logw, np.full((1, comp.max_mix), LZERO, np.float32)],
        axis=0)
    tr_flat = int(np.prod(comp.log_transp.shape))
    kw = dict(
        means=jnp.asarray(comp.means), variances=jnp.asarray(comp.variances),
        gconsts=jnp.asarray(comp.gconsts), state_mix=jnp.asarray(sm_pad),
        state_logw=jnp.asarray(lw_pad),
        slot_blocks=tuple(comp.slot_blocks) or None,
        fc_proj=jnp.asarray(comp.fc_proj), fc_mu=jnp.asarray(comp.fc_mu),
    )

    total = None
    xxT = np.zeros((M, D, D), np.float64)
    n_fail = 0
    for u in utts:
        arrs = pad_batch([u], comp.n_states)
        a = {k: jnp.asarray(v[0]) for k, v in arrs.items()}
        logp, accs = fb_utterance(
            a["feats"], a["t_real"], a["comp_state"], a["q_mask"],
            a["logA"], a["a0"], a["aE"], a["tr_seg"], a["entry_seg"],
            a["exit_seg"], n_states=comp.n_states, tr_flat=tr_flat, **kw)
        lp = float(logp)
        if lp <= LZERO / 2:
            n_fail += 1
            HRError(7323, "fullcov_accumulate: no path through %s", u.name)
            continue
        _lp2, gam = mix_posteriors_utterance(
            a["feats"], a["t_real"], a["comp_state"], a["q_mask"],
            a["logA"], a["a0"], a["aE"], **kw)
        T = u.feats.shape[0]
        g = jnp.asarray(gam)[:T]
        x = a["feats"][:T]
        xxT += np.asarray(
            jnp.einsum("tm,td,te->mde", g, x, x), np.float64)
        total = accs if total is None else jax.tree.map(
            lambda p, q: p + q, total, accs)
        if trace >= 2:
            print(f"  {u.name}: logP={lp:.2f} ({lp / T:.3f}/frame)")
    if total is None:
        HError(7326, "fullcov_accumulate: no trainable utterances")
    if n_fail:
        HRError(7324, "fullcov_accumulate: %d utterance(s) skipped", n_fail)
    return total, xxT


def fullcov_update(hset, comp: CompiledHMMSet, accs, xxT: np.ndarray,
                   flags: UpdateFlags = UpdateFlags(),
                   min_var: float = 1e-4) -> CompiledHMMSet:
    """Reestimate FULLC means/covariances in place; returns the
    recompiled set. Weights/transitions go through the standard update.
    Low-occupancy Gaussians keep their parameters (HTK's minEgs guard).
    """
    occ = np.asarray(accs.occ, np.float64)
    sum_x = np.asarray(accs.sum_x, np.float64)
    M, D = sum_x.shape

    _m, _v, w, t = reestimate(
        comp, accs, UpdateFlags(means=False, variances=False,
                                weights=flags.weights,
                                transitions=flags.transitions))
    from ..models.hmmset import write_back

    write_back(comp, weights=w, transps=t)

    n_upd = 0
    for i, mp in enumerate(comp._mix_objs):
        if occ[i] <= MINOCC:
            continue
        mu = sum_x[i] / occ[i]
        inv = None
        if flags.variances:
            if flags.means:
                cov = xxT[i] / occ[i] - np.outer(mu, mu)
            else:
                # means stay fixed: the covariance must be the second
                # moment AROUND THE RETAINED MEAN m, E[(x-m)(x-m)^T] =
                # xxT/occ - mu m^T - m mu^T + m m^T, not around the new
                # sample mean (which would pair inconsistent moments)
                m_old = np.asarray(mp.mean, np.float64)
                cov = (xxT[i] / occ[i] - np.outer(mu, m_old)
                       - np.outer(m_old, mu) + np.outer(m_old, m_old))
            cov = 0.5 * (cov + cov.T) + min_var * np.eye(D)  # diag loading
            try:
                inv = np.linalg.inv(cov)
            except np.linalg.LinAlgError:
                # keep BOTH old mean and old covariance — a new mean
                # paired with a stale covariance is not a valid update
                HRError(7032, "fullcov_update: singular covariance for "
                              "Gaussian %d — parameters kept", i)
                continue
        if flags.means:
            mp.mean = mu.astype(np.float32)
        if inv is not None:
            mp.var = inv.astype(np.float32)  # MMF stores INVCOVAR
            mp.cov_kind = "FULLC"
            mp.fix_gconst()
        n_upd += 1
    return compile_hmmset(hset), n_upd
