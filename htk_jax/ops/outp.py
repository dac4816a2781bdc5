"""Batched GMM log-likelihoods (HTK OutP) as matmul-shaped device code.

Replaces `HTKLib/HModel.c : OutP()/SOutP()/MOutP()` — which evaluate one
(state, frame) pair at a time — with one fused computation for all frames
x all Gaussians (SURVEY.md §2.5):

  logN_m(x) = -0.5 * (gConst_m + sum_d (x_d - mu_md)^2 / var_md)

expands to    -0.5 * (x^2 . a_m  - 2 x . b_m  + c_m)
with          a_m = 1/var_m,  b_m = mu_m/var_m,
              c_m = gConst_m + sum_d mu_md^2/var_md

so all frames x all Gaussians is a single (T, 2D) @ (2D, M) matmul.
State-level log b_j(x) then logsumexps mixture scores with their log
weights using HTK LAdd clamping semantics.

Precision: "highest" is true f32 and the parity default. On an H100,
"high" and "default" both run the matmul in TF32: against a float64
reference at the config-#4 shapes (522 frames x 15,952 Gaussians x 39)
the state log-likelihoods are off by up to 3.5e-4 with "highest" and by
up to 0.29 (relative 3.0e-4) with "high" or "default". The expansion
above cancels, so TF32's 10-bit mantissa shows in the result.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.logmath import LZERO, ladd_reduce


def pack_gaussians(means: jnp.ndarray, variances: jnp.ndarray, gconsts: jnp.ndarray):
    """Precompute the (2D, M) weight block and (M,) bias for mix_scores.

    Done once per reestimation iteration; cheap relative to the scan.
    """
    a = 1.0 / variances  # (M, D)
    b = means / variances
    c = gconsts + jnp.sum(means * means / variances, axis=1)  # (M,)
    Wt = jnp.concatenate([a, -2.0 * b], axis=1).T  # (2D, M)
    return Wt, c


def mix_scores(x: jnp.ndarray, Wt: jnp.ndarray, c: jnp.ndarray,
               precision: str = "highest") -> jnp.ndarray:
    """(T, D) frames -> (T, M) per-Gaussian log-likelihoods."""
    feats = jnp.concatenate([x * x, x], axis=-1)  # (T, 2D)
    quad = jnp.matmul(feats, Wt, precision=precision)  # (T, M)
    return -0.5 * (quad + c[None, :])


def full_cov_mix_scores(x: jnp.ndarray, fc_proj: jnp.ndarray,
                        fc_mu: jnp.ndarray, gconsts: jnp.ndarray,
                        precision: str = "highest") -> jnp.ndarray:
    """(T, D) frames -> (T, M) full-covariance Gaussian log-likelihoods.

    HModel.c OutP for FULLC/LLTC sets: each Gaussian carries the Cholesky
    factor L of its precision matrix P = L L^T embedded in full-D columns
    (models/hmmset.py), so the Mahalanobis form is one batched
    contraction ||x @ L_m - mu~_m||^2 with mu~_m = mu_m @ L_m —
    (T, D) x (M, D, D) as one contraction instead of per-pair scalar
    loops.
    """
    y = jnp.einsum("td,mde->tme", x, fc_proj, precision=precision)
    q = jnp.sum((y - fc_mu[None, :, :]) ** 2, axis=-1)  # (T, M)
    return -0.5 * (gconsts[None, :] + q)


def state_outp(
    mix_lp: jnp.ndarray, state_mix: jnp.ndarray, state_logw: jnp.ndarray,
    slot_blocks=None, state_sw=None,
) -> jnp.ndarray:
    """(T, M) Gaussian log-probs -> (T, S) state log-likelihoods b_j(x).

    Gathers each state's mixture rows and logsumexps with weights (HTK
    LAdd semantics: contributions below minLogExp of the max drop out).
    Padded mixture slots carry LZERO weights so they never contribute.

    Multi-stream sets pass `slot_blocks` ([(j0, j1)] per stream) and
    `state_sw` (per-slot stream-weight exponents):
    b_j = sum_s sw_js * logsumexp over block s (HModel.c SOutP product).
    """
    safe_idx = jnp.maximum(state_mix, 0)  # (S, n_slots)
    gathered = mix_lp[:, safe_idx]  # (T, S, n_slots)
    weighted = gathered + state_logw[None, :, :]
    weighted = jnp.where(state_mix[None, :, :] >= 0, weighted, LZERO)
    if slot_blocks is None or len(slot_blocks) <= 1:
        out = ladd_reduce(weighted, axis=-1)  # (T, S)
        if state_sw is not None and len(slot_blocks or []) == 1:
            out = out * state_sw[None, :, 0]
        return out
    total = None
    for s, (j0, j1) in enumerate(slot_blocks):
        bs = ladd_reduce(weighted[:, :, j0:j1], axis=-1)  # (T, S)
        bs = bs * state_sw[None, :, j0]  # stream-weight exponent
        total = bs if total is None else total + bs
    return total


def all_state_outp(
    x: jnp.ndarray,
    means: jnp.ndarray,
    variances: jnp.ndarray,
    gconsts: jnp.ndarray,
    state_mix: jnp.ndarray,
    state_logw: jnp.ndarray,
    precision: str = "highest",
    slot_blocks=None,
    state_sw=None,
    fc_proj=None,
    fc_mu=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Frames (T, D) -> (state log-likes (T, S), Gaussian log-likes (T, M)).

    `fc_proj`/`fc_mu` switch the Gaussian scorer to the full-covariance
    path (compile_hmmset provides them for FULLC/LLTC sets)."""
    if fc_proj is not None:
        mlp = full_cov_mix_scores(x, fc_proj, fc_mu, gconsts,
                                  precision=precision)
    else:
        Wt, c = pack_gaussians(means, variances, gconsts)
        mlp = mix_scores(x, Wt, c, precision=precision)
    return state_outp(mlp, state_mix, state_logw, slot_blocks, state_sw), mlp
