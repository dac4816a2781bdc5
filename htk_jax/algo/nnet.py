"""ANN training: frame cross-entropy SGD with HTK's schedulers.

Mirrors `HTKTools/HNTrainSGD.c` + `HTKLib/HNCache.c`: frame-level
cross-entropy training of a feed-forward net on tied-state targets from
forced alignment, with minibatching, frame-level shuffling (FRAMERAND),
momentum SGD, and the NewBob / exponential-decay learning-rate schedules.

The whole update step is one jitted function (forward + backward + SGD);
XLA compiles the matmuls for the device — the reference needed hand-written CUDA
(HCUDA.cu) for exactly this, which is free here (SURVEY.md §2.5).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.ann import ANNDef, ann_params, forward, splice
from ..utils.errors import HError, HRError


@dataclass
class SGDConfig:
    lr: float = 0.002  # LEARNRATE
    momentum: float = 0.5  # MOMENTUM
    batch_size: int = 256  # MINIBATCHSIZE
    n_epochs: int = 10  # MAXEPOCHNUM
    # LRSCHEDULER: NEWBOB | EXPDECAY | LIST | ADAGRAD | FIXED
    scheduler: str = "NEWBOB"
    newbob_ramp: float = 0.005  # improvement threshold to start decay
    newbob_stop: float = 0.0001  # improvement threshold to stop
    decay_factor: float = 0.5
    lr_list: Optional[List[float]] = None  # LIST: per-epoch rates
    adagrad_k: float = 1.0  # ADAGRAD damping constant [LC]
    frame_rand: bool = True  # FRAMERAND
    seed: int = 0
    weight_decay: float = 0.0  # WEIGHTDECAY: L2 penalty added to grads
    grad_clip: float = 0.0  # GRADCLIP: elementwise gradient clamp [LC]


def make_cache(
    utt_feats: List[np.ndarray], utt_targets: List[np.ndarray], context: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Splice + concatenate all utterances into one frame-level dataset.

    The HNCache role: targets are per-frame tied-state ids from forced
    alignment.
    """
    xs, ys = [], []
    for f, t in zip(utt_feats, utt_targets):
        if f.shape[0] != t.shape[0]:
            HError(7730, "make_cache: feature/target length mismatch")
        xs.append(np.asarray(splice(jnp.asarray(f, jnp.float32), context)))
        ys.append(t.astype(np.int32))
    return np.concatenate(xs), np.concatenate(ys)


def _regularise(grads, params, wd, clip):
    """WEIGHTDECAY adds the L2 term to the gradients; GRADCLIP clamps
    them elementwise (HNTrainSGD.c update options [LC])."""
    if wd:
        grads = jax.tree.map(lambda g, p: g + wd * p, grads, params)
    if clip:
        grads = jax.tree.map(lambda g: jnp.clip(g, -clip, clip), grads)
    return grads


def _sgd_body(params, vel, x, y, acts, lr, momentum, wd=0.0, clip=0.0):
    def loss_fn(p):
        logits = forward(p, list(acts), x, return_logits=True)
        logp = jax.nn.log_softmax(logits, axis=-1)
        ce = -jnp.take_along_axis(logp, y[:, None], axis=1).mean()
        acc = jnp.mean((jnp.argmax(logits, axis=1) == y).astype(jnp.float32))
        return ce, acc

    (ce, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    grads = _regularise(grads, params, wd, clip)
    new_vel = jax.tree.map(lambda v, g: momentum * v - lr * g, vel, grads)
    new_params = jax.tree.map(lambda p, v: p + v, params, new_vel)
    return new_params, new_vel, ce, acc


@functools.partial(jax.jit,
                   static_argnames=("acts", "lr", "momentum", "wd", "clip"))
def _sgd_step(params, vel, x, y, acts, lr, momentum, wd=0.0, clip=0.0):
    return _sgd_body(params, vel, x, y, acts, lr, momentum, wd, clip)


def _adagrad_body(params, ssg, x, y, acts, lr, k, wd=0.0, clip=0.0):
    def loss_fn(p):
        logits = forward(p, list(acts), x, return_logits=True)
        logp = jax.nn.log_softmax(logits, axis=-1)
        ce = -jnp.take_along_axis(logp, y[:, None], axis=1).mean()
        acc = jnp.mean((jnp.argmax(logits, axis=1) == y).astype(jnp.float32))
        return ce, acc

    (ce, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    grads = _regularise(grads, params, wd, clip)
    new_ssg = jax.tree.map(lambda s, g: s + g * g, ssg, grads)
    new_params = jax.tree.map(
        lambda p, g, s: p - lr * g / jnp.sqrt(k + s), params, grads, new_ssg)
    return new_params, new_ssg, ce, acc


@functools.partial(jax.jit,
                   static_argnames=("acts", "lr", "k", "wd", "clip"))
def _sgd_step_adagrad(params, ssg, x, y, acts, lr, k, wd=0.0, clip=0.0):
    """AdaGrad update (HNTrainSGD.c AdaGrad scheduler): per-parameter
    rate lr / sqrt(k + sum of squared gradients). [LC k default]"""
    return _adagrad_body(params, ssg, x, y, acts, lr, k, wd, clip)


@functools.partial(jax.jit,
                   static_argnames=("acts", "adagrad", "wd", "clip"))
def _train_epoch(params, st, xd, yd, idx_mat, lr, k_or_mom, acts,
                 adagrad, wd=0.0, clip=0.0):
    """One epoch as lax.scan over minibatch index rows.

    The frame cache (xd, yd) stays device-resident (the HNCache role)
    and the whole epoch runs as ONE dispatch instead of one per
    minibatch — at HTK-scale nets (a few matmuls per 256-frame batch)
    per-step dispatch dominated wall-clock. lr is a traced operand so
    NEWBOB halving/ramping never recompiles. Returns summed per-batch
    mean CE/accuracy like the per-batch loop accumulated."""
    def step(carry, ib):
        params, st, ce, acc = carry
        x = jnp.take(xd, ib, axis=0)
        y = jnp.take(yd, ib, axis=0)
        if adagrad:
            p2, s2, c, a = _adagrad_body(params, st, x, y, acts, lr,
                                         k_or_mom, wd, clip)
        else:
            p2, s2, c, a = _sgd_body(params, st, x, y, acts, lr,
                                     k_or_mom, wd, clip)
        return (p2, s2, ce + c, acc + a), None

    (params, st, ce, acc), _ = jax.lax.scan(
        step, (params, st, jnp.float32(0.0), jnp.float32(0.0)), idx_mat)
    return params, st, ce, acc


@functools.partial(jax.jit,
                   static_argnames=("acts", "lr", "momentum", "wd", "clip"))
def _sgd_step_soft(params, vel, x, c, acts, lr, momentum, wd=0.0, clip=0.0):
    """Sequence-discriminative step: c = gamma_num - gamma_den per frame
    and state; dF/dlogit = -(c) exactly because each frame's c sums to 0
    (the softmax coupling term vanishes), so the MMI gradient is plain
    soft-target backprop."""
    def loss_fn(p):
        logits = forward(p, list(acts), x, return_logits=True)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -(c * logp).sum(axis=1).mean()

    loss, grads = jax.value_and_grad(loss_fn)(params)
    grads = _regularise(grads, params, wd, clip)
    new_vel = jax.tree.map(lambda v, g: momentum * v - lr * g, vel, grads)
    new_params = jax.tree.map(lambda p, v: p + v, params, new_vel)
    return new_params, new_vel, loss


@functools.partial(jax.jit, static_argnames=("acts",))
def _eval_step(params, x, y, acts):
    logits = forward(params, list(acts), x, return_logits=True)
    logp = jax.nn.log_softmax(logits, axis=-1)
    ce = -jnp.take_along_axis(logp, y[:, None], axis=1).sum()
    acc = jnp.sum((jnp.argmax(logits, axis=1) == y).astype(jnp.float32))
    return ce, acc


def train_ann(
    ann: ANNDef,
    x: np.ndarray,
    y: np.ndarray,
    cfg: SGDConfig,
    holdout: float = 0.1,
    trace: int = 0,
) -> ANNDef:
    """Train in place; returns the ANN with updated weights + priors."""
    n = x.shape[0]
    rng = np.random.default_rng(cfg.seed)
    perm = rng.permutation(n)
    n_cv = max(1, int(n * holdout))
    cv_idx, tr_idx = perm[:n_cv], perm[n_cv:]
    xtr, ytr = x[tr_idx], y[tr_idx]
    xcv, ycv = jnp.asarray(x[cv_idx]), jnp.asarray(y[cv_idx])

    acts = tuple(l.activation for l in ann.layers)
    params = ann_params(ann)
    vel = jax.tree.map(jnp.zeros_like, params)  # momentum or AdaGrad state

    def cv_loss(p):
        ce, acc = _eval_step(p, xcv, ycv, acts)
        return float(ce) / n_cv, float(acc) / n_cv

    lr = cfg.lr
    prev_cv = None
    ramping = False
    bs = cfg.batch_size
    # device-resident frame cache (HNCache): epochs then run as one
    # lax.scan dispatch; fall back to per-batch shipping past ~4 GB
    use_cache = xtr.nbytes + ytr.nbytes < (4 << 30)
    if use_cache:
        xd = jnp.asarray(xtr)
        yd = jnp.asarray(ytr)
    for epoch in range(cfg.n_epochs):
        if cfg.scheduler == "LIST" and cfg.lr_list:
            lr = cfg.lr_list[min(epoch, len(cfg.lr_list) - 1)]
        elif cfg.scheduler == "EXPDECAY":
            lr = cfg.lr * (cfg.decay_factor ** epoch)
        order = rng.permutation(len(xtr)) if cfg.frame_rand else np.arange(len(xtr))
        tot_ce = 0.0
        tot_acc = 0.0
        nb = 0
        # the final partial minibatch trains too (a corpus smaller than
        # MINIBATCHSIZE must still train, as in HNCache's last batch)
        adagrad = cfg.scheduler == "ADAGRAD"
        k_or_mom = cfg.adagrad_k if adagrad else cfg.momentum
        nb_full = len(order) // bs
        if use_cache and nb_full:
            # device-resident cache + one scan dispatch per epoch
            idx_mat = jnp.asarray(
                order[: nb_full * bs].reshape(nb_full, bs))
            params, vel, ce_s, acc_s = _train_epoch(
                params, vel, xd, yd, idx_mat, jnp.float32(lr),
                jnp.float32(k_or_mom), acts, adagrad,
                wd=cfg.weight_decay, clip=cfg.grad_clip)
            tot_ce += float(ce_s)
            tot_acc += float(acc_s)
            nb += nb_full
            tail = order[nb_full * bs :]
        else:
            tail = order
        # the final partial minibatch trains too (HNCache's last batch);
        # without the cache this loop is the whole epoch
        for i in range(0, len(tail), bs):
            idx = tail[i : i + bs]
            if adagrad:
                params, vel, ce, acc = _sgd_step_adagrad(
                    params, vel, jnp.asarray(xtr[idx]),
                    jnp.asarray(ytr[idx]), acts, lr, cfg.adagrad_k,
                    wd=cfg.weight_decay, clip=cfg.grad_clip,
                )
            else:
                params, vel, ce, acc = _sgd_step(
                    params, vel, jnp.asarray(xtr[idx]),
                    jnp.asarray(ytr[idx]), acts, lr, cfg.momentum,
                    wd=cfg.weight_decay, clip=cfg.grad_clip,
                )
            tot_ce += float(ce)
            tot_acc += float(acc)
            nb += 1
        cv_ce, cv_acc = cv_loss(params)
        if trace:
            print(
                f"  epoch {epoch + 1}: lr={lr:.5f} train CE={tot_ce / max(nb,1):.4f} "
                f"acc={tot_acc / max(nb,1):.3f} | cv CE={cv_ce:.4f} acc={cv_acc:.3f}"
            )
        if cfg.scheduler == "NEWBOB" and prev_cv is not None:
            improvement = prev_cv - cv_ce
            if ramping and improvement < cfg.newbob_stop:
                break
            if improvement < cfg.newbob_ramp:
                ramping = True
            if ramping:
                lr *= cfg.decay_factor
        prev_cv = cv_ce

    # write back + priors from target frequencies
    for l, (W, b) in zip(ann.layers, params):
        l.weight = np.asarray(W)
        l.bias = np.asarray(b)
    K = ann.out_dim
    counts = np.bincount(y, minlength=K).astype(np.float64) + 1.0
    ann.target_priors = (counts / counts.sum()).astype(np.float32)
    return ann


def hybrid_outp(ann: ANNDef, feats: np.ndarray, prior_scale: float = 1.0):
    """(T, D) -> (T, K) hybrid scores: log P(s|x) - scale*log P(s).

    The hybrid-decoding observation model (HNForward / hybrid HVite):
    scaled posteriors replace GMM b_j(o_t).
    """
    x = splice(jnp.asarray(feats, jnp.float32), ann.context)
    acts = tuple(l.activation for l in ann.layers)
    logits = forward(ann_params(ann), list(acts), x, return_logits=True)
    logpost = jax.nn.log_softmax(logits, axis=-1)
    if ann.target_priors is not None:
        logpost = logpost - prior_scale * jnp.log(
            jnp.asarray(ann.target_priors)[None, :]
        )
    return logpost


# ---------------------------------------------------------------------------
# Sequence-discriminative (MMI) training — HNTrainSGD.c's sequence mode
# ---------------------------------------------------------------------------


def make_phone_loop(comp, loop_prob: float = None):
    """Denominator phone-loop HMM over every model in the set.

    The HNTrainSGD sequence criterion needs denominator occupancies; HTK
    gets them from denominator lattices (HFBLat). Here the denominator
    is the classic weak-LM phone loop: all models in parallel, uniform
    loop-back transitions — built as ONE dense (Q, Q) logA so the
    generic forward/backward scans run it unchanged. Returns
    (comp_state, logA, a0, aE). Tee (zero-emitting) models are excluded
    from the loop. Dense (Q, Q) is fine at phone-set sizes; a tied-state
    denominator at triphone scale should use lattices (tools/hmmirest).
    """
    from ..utils.logmath import LZERO as _LZ

    sizes, offs, en, ex = [], [], [], []
    q = 0
    for mid in range(comp.n_models):
        n = int(comp.model_nstates[mid])
        e = n - 2
        if e <= 0:
            continue
        lt = comp.log_transp[comp.model_transp[mid]]
        offs.append(q)
        sizes.append(e)
        en.append(lt[0, 1 : 1 + e])
        ex.append(lt[1 : 1 + e, n - 1])
        q += e
    M = len(sizes)
    if M == 0:
        HError(7330, "make_phone_loop: no emitting models")
    lp = -np.log(M) if loop_prob is None else loop_prob

    comp_state = np.zeros(q, np.int32)
    logA = np.full((q, q), _LZ, np.float64)
    a0 = np.full(q, _LZ, np.float64)
    aE = np.full(q, _LZ, np.float64)
    k = 0
    for mid in range(comp.n_models):
        n = int(comp.model_nstates[mid])
        e = n - 2
        if e <= 0:
            continue
        o = offs[k]
        comp_state[o : o + e] = comp.model_states[mid, :e]
        lt = comp.log_transp[comp.model_transp[mid]]
        logA[o : o + e, o : o + e] = lt[1 : 1 + e, 1 : 1 + e]
        a0[o : o + e] = en[k] + lp
        aE[o : o + e] = ex[k]
        k += 1
    # loop-back: every model exit reaches every model entry
    for i in range(M):
        oi, ei = offs[i], sizes[i]
        for j in range(M):
            oj, ej = offs[j], sizes[j]
            cross = ex[i][:, None] + lp + en[j][None, :]
            logA[oi : oi + ei, oj : oj + ej] = np.logaddexp(
                logA[oi : oi + ei, oj : oj + ej], cross)
    return (comp_state, logA.astype(np.float32), a0.astype(np.float32),
            aE.astype(np.float32))


def _gamma_phys(scores, comp_state, logA, a0, aE, n_states):
    """FB over an HMM graph with external state scores; returns
    ((T, S_phys) occupancies, logP)."""
    from .fb import backward_scan, forward_scan
    from ..utils.logmath import exp_or_zero, ladd_reduce

    T = scores.shape[0]
    cs = jnp.asarray(comp_state)
    outp = scores[:, cs]
    t_real = jnp.asarray(T, jnp.int32)
    alphas = forward_scan(outp, jnp.asarray(logA), jnp.asarray(a0), t_real)
    betas = backward_scan(outp, jnp.asarray(logA), jnp.asarray(aE), t_real)
    logp = ladd_reduce(alphas[T - 1] + jnp.asarray(aE), axis=0)
    gamma = exp_or_zero(alphas + betas - logp)  # (T, Q)
    gp = jax.ops.segment_sum(gamma.T, cs, n_states).T  # (T, S)
    return gp, logp


def mmi_frame_targets(ann, comp, feats, names, loop, prior_scale=1.0):
    """Per-frame MMI soft targets c = gamma_num - gamma_den over physical
    states, plus the utterance's MMI objective contribution
    (logP_num - logP_den), with the CURRENT net's hybrid scores."""
    from ..algo.composite import build_composite

    scores = hybrid_outp(ann, feats, prior_scale)  # (T, S_phys)
    hmm = build_composite(comp, [comp.model_id(n) for n in names])
    gnum, lpn = _gamma_phys(scores, hmm.comp_state,
                            hmm.logA.astype(np.float32),
                            hmm.a0.astype(np.float32),
                            hmm.aE.astype(np.float32), comp.n_states)
    gden, lpd = _gamma_phys(scores, loop[0], loop[1], loop[2], loop[3],
                            comp.n_states)
    return np.asarray(gnum - gden), float(lpn - lpd)


def train_ann_sequence(ann, comp, utt_feats, names_list, cfg, n_iters=4,
                       trace=0):
    """Sequence-MMI fine-tuning (HNTrainSGD sequence criterion).

    Alternates: (E) recompute numerator/denominator occupancies with the
    current net over every utterance, (M) one SGD pass over the frame
    pool with the soft-target MMI gradient. The reported objective
    sum(logP_num - logP_den) must rise (asserted in tests) — the EM-like
    monotonicity check HTK recipes eyeball for HMMIRest."""
    loop = make_phone_loop(comp)
    bs = cfg.batch_size
    acts = tuple(l.activation for l in ann.layers)
    objs = []
    for it in range(n_iters):
        cs, obj = [], 0.0
        for feats, names in zip(utt_feats, names_list):
            c, o = mmi_frame_targets(ann, comp, feats, names, loop)
            cs.append(c)
            obj += o
        objs.append(obj)
        if trace:
            print(f"  MMI iter {it}: objective {obj:.2f}")
        x = np.concatenate([
            np.asarray(splice(jnp.asarray(f, jnp.float32), ann.context))
            for f in utt_feats])
        c = np.concatenate(cs)
        params = ann_params(ann)
        vel = jax.tree.map(jnp.zeros_like, params)
        order = np.random.default_rng(cfg.seed + it).permutation(len(x))
        for i in range(0, len(order), bs):
            idx = order[i : i + bs]
            params, vel, _loss = _sgd_step_soft(
                params, vel, jnp.asarray(x[idx]), jnp.asarray(c[idx]),
                acts, cfg.lr, cfg.momentum,
                wd=cfg.weight_decay, clip=cfg.grad_clip)
        for l, (W, b) in zip(ann.layers, params):
            l.weight = np.asarray(W)
            l.bias = np.asarray(b)
    return ann, objs
