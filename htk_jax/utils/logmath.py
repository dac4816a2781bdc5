"""Log-domain arithmetic with HTK's clamping semantics.

Reproduces `HTKLib/HMath.c : LAdd()/LSub()` exactly (parity-critical —
see SURVEY.md §7 "Hard parts" #2):

  LZERO   = -1.0e10   log(0): any log-prob at or below this is "zero"
  LSMALL  = -0.5e10   results below this are flushed to LZERO
  MINEARG = -708.3    smallest x for which exp(x) is representable (f64)
  minLogExp = -log(-LZERO) ≈ -23.025850929940457
              increments smaller than exp(minLogExp) are dropped by LAdd

HTK computes logs in C `double`; on the device we default to float32 and keep the
identical clamping structure. The clamps make the arithmetic *more* robust
in f32 than naive logaddexp (no exp underflow contributions below 1e-10
relative), so f32 drift stays within the 1e-4 parity budget for the
north-star workloads. Functions accept any float dtype and preserve it.

All functions are jit/vmap/scan-safe (pure jnp, no Python branching on
traced values).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

LZERO = -1.0e10
LSMALL = -0.5e10
MINEARG = -708.3
MINLARG = 2.45e-308
# minLogExp = -log(-LZERO): below this difference the smaller addend can't
# change the sum at double precision (HMath.c computes it in InitMath()).
MINLOGEXP = -float(np.log(-LZERO))


def ladd(x, y):
    """HTK LAdd: log(exp(x)+exp(y)) with LZERO/LSMALL flush-to-zero.

    Mirrors HTKLib/HMath.c : LAdd(). Elementwise over broadcastable arrays.
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    hi = jnp.maximum(x, y)
    lo = jnp.minimum(x, y)
    diff = lo - hi  # <= 0
    # When diff < minLogExp the small term is dropped; and if the big term
    # itself is below LSMALL the result is flushed to LZERO.
    dropped = jnp.where(hi < LSMALL, LZERO, hi)
    # Guard log1p(exp(diff)) against diff = -inf producing nan under jit.
    safe_diff = jnp.maximum(diff, MINLOGEXP)
    summed = hi + jnp.log1p(jnp.exp(safe_diff))
    return jnp.where(diff < MINLOGEXP, dropped, summed)


def lsub(x, y):
    """HTK LSub: log(exp(x)-exp(y)); returns LZERO when result underflows.

    Mirrors HTKLib/HMath.c : LSub(). Requires x >= y elementwise (HTK
    raises HError(5271) otherwise; here the invalid lanes return LZERO —
    callers in HFB/HRec never hit that path with valid inputs).
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    diff = y - x  # <= 0 for valid input
    safe_diff = jnp.maximum(diff, MINLOGEXP)
    z = -jnp.expm1(safe_diff)  # 1 - exp(diff), accurate near diff=0
    small = jnp.where(x < LSMALL, LZERO, x)
    # z<=0 (complete cancellation, incl. x==y) flushes to LZERO; the f64
    # MINLARG threshold underflows in f32 so use the dtype-safe z<=0 test.
    res = jnp.where(z <= 0.0, LZERO, x + jnp.log(jnp.maximum(z, 1e-37)))
    return jnp.where(diff < MINLOGEXP, small, res)


def ladd_reduce(a, axis=-1, keepdims=False):
    """logsumexp along an axis with HTK LAdd clamping semantics.

    Equivalent to folding LAdd over the axis (LAdd is associative and
    commutative up to fp rounding; HTK folds left-to-right). Implemented
    as a max-shifted sum with per-element drop of increments below
    minLogExp and flush of results below LSMALL — identical fixed points
    to the pairwise fold for the magnitudes HTK operates in.
    """
    a = jnp.asarray(a)
    hi = jnp.max(a, axis=axis, keepdims=True)
    diff = a - hi
    contrib = jnp.where(diff < MINLOGEXP, 0.0, jnp.exp(jnp.maximum(diff, MINLOGEXP)))
    s = hi + jnp.log(jnp.sum(contrib, axis=axis, keepdims=True))
    s = jnp.where(hi < LSMALL, LZERO, s)
    if not keepdims:
        s = jnp.squeeze(s, axis=axis)
    return s


def log_or_lzero(p):
    """log(p) with p<=MINLARG mapping to LZERO (HTK's safe log pattern)."""
    p = jnp.asarray(p)
    return jnp.where(p > MINLARG, jnp.log(jnp.maximum(p, MINLARG)), LZERO)


def exp_or_zero(x):
    """exp(x) with x<=LSMALL mapping to 0 (HTK's L2F pattern)."""
    x = jnp.asarray(x)
    return jnp.where(x > LSMALL, jnp.exp(jnp.maximum(x, MINEARG)), 0.0)
