"""Benchmark harness — prints cumulative JSON lines, the last one final.

Headline metric: HVite-style word-loop Viterbi decode real-time factor
(xRT) per chip at BASELINE config #4 scale: 1,000-word vocabulary,
back-off bigram LM on the links, tied-state 8-mixture word-internal
triphones (2,000 physical tied states, 39-dim), 5 s utterances, decoded
through the uniform-row LV network (algo/lvnet). `vs_baseline` reports
the 0.01 xRT target / actual, so values > 1.0 beat the target.

Covers all five BASELINE.json configs:
  #1 hcopy_mfcc_xrt / hcopy_kframes_per_sec — batched waveform->MFCC_E_D_A
  #2 herest_bw_utt_per_sec_per_chip — Baum-Welch accumulation
  #3 (device half == #2's 8-mix models; tree surgery is host-side, see
     recipes/full)
  #4 hvite_1kvocab_bigram_xrt_per_chip — the headline
  #5 hdecode_5kvocab_xrt (lattice pass) + mmi_utt_per_sec/ebw_update_s
     (discriminative half) + 20k/50k/100k-vocab LV rows

Runs in one process on JAX's default backend and exits non-zero when
that is not a GPU, unless JAX_PLATFORMS=cpu asks for the CPU explicitly.
Sections share a time budget (env BENCH_BUDGET_S, default 1200 s).

Features are synthetic noise: xRT measures compute, not WER (WER
pipelines are exercised in tests/ on synthesized speech).
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np

SMOKE = os.environ.get("BENCH_SMOKE") == "1"

# set by main() from BENCH_BUDGET_S: monotonic deadline for optional
# (big-vocab) sections
_DEADLINE = None


def _left():
    return math.inf if _DEADLINE is None else _DEADLINE - time.monotonic()


def _import_jax():
    global jax, jnp
    import jax as _jax
    import jax.numpy as _jnp

    jax, jnp = _jax, _jnp


def build_model(n_phones=40, nstates=5, dim=39, nmix=8, seed=0):
    from htk_jax.models.hmmset import compile_hmmset

    cl, names = build_monophone_set(n_phones, nstates, dim, nmix, seed)
    return compile_hmmset(cl), names


def build_monophone_set(n_phones=40, nstates=5, dim=39, nmix=8, seed=0):
    """Random monophone HMMSet (names ph0..): returns (hset, names)."""
    from htk_jax.models.proto import clone_proto, make_proto

    rng = np.random.default_rng(seed)
    hs = make_proto(nstates=nstates, dim=dim, parm_kind="MFCC_E_D_A", nmix=nmix)
    names = [f"ph{i}" for i in range(n_phones)]
    cl = clone_proto(hs, "proto", names)
    for h in cl.hmms.values():
        for si in h.states:
            for mp in si.streams[0].mixes:
                mp.mean = rng.normal(size=dim).astype(np.float32) * 2
                mp.var = (0.5 + rng.random(dim)).astype(np.float32)
                mp.fix_gconst()
    return cl, names


def build_tied_triphone_system(n_words, n_phones=40, n_tied=2000, nmix=8,
                               dim=39, seed=0, lm_order=2):
    """build_tied_triphone_set with the HMMSet compiled: returns
    (comp, vocab, words, lm)."""
    from htk_jax.models.hmmset import compile_hmmset

    hset, vocab, words, lm = build_tied_triphone_set(
        n_words, n_phones, n_tied, nmix, dim, seed, lm_order)
    return compile_hmmset(hset), vocab, words, lm


def build_tied_triphone_set(n_words, n_phones=40, n_tied=2000, nmix=8,
                            dim=39, seed=0, lm_order=2):
    """Synthetic tied-state word-internal triphone system at config-#4
    scale: a pool of `n_tied` shared 8-mix states (the decision-tree
    tying outcome), word-internal triphones drawing 3 emitting states
    each from the pool, a random 3-5 phone lexicon, and a back-off
    bigram LM (`lm_order=3`: plus ~8 favoured trigram successors per
    bigram and non-trivial trigram back-off weights — the single-pass
    guidance / rescoring testbed). The pool states are ~s macros, so the
    set saves as a tied MMF. Returns (hset, vocab, words, lm)."""
    from htk_jax.io.dictionary import Vocab
    from htk_jax.io.lm import NGramLM
    from htk_jax.io.mmf import HMMSet, HMMDef, MixPDF, StateInfo, StreamElem
    from htk_jax.io.parmkind import str2parmkind
    from htk_jax.models.proto import left_to_right_transp

    rng = np.random.default_rng(seed)
    phones = [f"p{i}" for i in range(n_phones)]

    # lexicon over monophone strings
    lex = {}
    words = []
    for i in range(n_words):
        w = f"w{i}"
        n_ph = int(rng.integers(3, 6))
        lex[w] = [phones[j] for j in rng.integers(0, n_phones, n_ph)]
        words.append(w)

    # word-internal triphone names per pron
    def internal(ph):
        out = []
        n = len(ph)
        for k, p in enumerate(ph):
            l = ph[k - 1] if k > 0 else None
            r = ph[k + 1] if k < n - 1 else None
            if l and r:
                out.append(f"{l}-{p}+{r}")
            elif r:
                out.append(f"{p}+{r}")
            elif l:
                out.append(f"{l}-{p}")
            else:
                out.append(p)
        return out

    vocab = Vocab()
    tri_names = set()
    for w in words:
        tri = internal(lex[w])
        vocab.add_pron(w, tri)
        tri_names.update(tri)

    # shared tied-state pool
    pool = []
    for _ in range(n_tied):
        se = StreamElem(
            weights=[1.0 / nmix] * nmix,
            mixes=[
                MixPDF(
                    mean=(rng.normal(size=dim) * 2).astype(np.float32),
                    var=(0.5 + rng.random(dim)).astype(np.float32),
                )
                for _ in range(nmix)
            ],
        )
        for mp in se.mixes:
            mp.fix_gconst()
        pool.append(StateInfo(streams=[se]))
    tp = left_to_right_transp(5)

    hset = HMMSet(vec_size=dim, parm_kind=str2parmkind("MFCC_E_D_A"))
    for k, st in enumerate(pool):
        hset.macros["s"][f"ST{k}"] = st
    for name in sorted(tri_names):
        picks = rng.integers(0, n_tied, 3)
        hset.hmms[name] = HMMDef(
            name=name, nstates=5,
            states=[pool[k] for k in picks], transp=tp)

    # back-off bigram LM: each word has ~20 favoured successors
    lm = NGramLM(order=2)
    uni = math.log(0.5 / n_words)
    for w in words:
        lm.unigrams[w] = (uni, math.log(0.5))
    lm.unigrams["!ENTER"] = (-99.0, math.log(0.5))
    lm.unigrams["!EXIT"] = (uni, 0.0)
    fanout = 20
    bi_bow = math.log(0.3) if lm_order >= 3 else 0.0
    for w in words:
        succ = rng.integers(0, n_words, fanout)
        for j in set(int(x) for x in succ):
            lm.bigrams[(w, words[j])] = (math.log(0.4 / fanout), bi_bow)
    if lm_order >= 3:
        # ~8 explicit trigram successors per bigram, each much likelier
        # than its back-off path — trigram context genuinely reranks
        lm.order = 3
        tri_fan = 8
        for (u, v) in list(lm.bigrams):
            if u == "!ENTER":
                continue
            succ = rng.integers(0, n_words, tri_fan)
            for j in set(int(x) for x in succ):
                lm.trigrams[(u, v, words[j])] = math.log(0.5 / tri_fan)
    return hset, vocab, words, lm


def synth_corpus(comp, vocab, words, n_utts, words_per, rng, noise=4.0):
    """Features synthesized FROM the model (state-mean walks + noise,
    as benchmarks/lattice_quality.py): pure-noise features make every
    word equally likely, so beam-pruned lattices blow up ~8x denser
    than the BASELINE lattice table at the same beam — lattice-path
    throughput is only meaningful at realistic density. Returns
    (feats list, transcript list)."""
    from htk_jax.algo.composite import build_composite

    mu_of = {}

    def state_mean(s):
        m = mu_of.get(int(s))
        if m is None:
            mixes = np.asarray(comp.state_mix[int(s)])
            m0 = int(mixes[mixes >= 0][0])
            m = np.asarray(comp.means[m0])
            mu_of[int(s)] = m
        return m

    feats, trans = [], []
    for _ in range(n_utts):
        k = int(words_per) if np.isscalar(words_per) else int(
            rng.integers(*words_per))
        seq = [words[j] for j in rng.integers(0, len(words), k)]
        frames = []
        for w in seq:
            for ph in vocab.get(w).prons[0].phones:
                ch = build_composite(comp, [comp.model_id(ph)])
                for s in np.asarray(ch.comp_state):
                    mu = state_mean(s)
                    for _ in range(3):
                        frames.append(mu + noise * rng.normal(
                            size=mu.shape))
        trans.append(seq)
        feats.append(np.stack(frames).astype(np.float32))
    return feats, trans


def bench_frontend(n_utts=64, secs=5.0, reps=3):
    """BASELINE config #1: batched waveform -> MFCC_E_D_A 39-dim
    extraction (25 ms window / 10 ms shift, 16 kHz). Returns
    (xrt, kframes_per_sec)."""
    import statistics

    from htk_jax.ops.dsp import FrontendConfig, compute_features_batch

    cfg = FrontendConfig()  # MFCC_E_D_A, 16 kHz, 25 ms/10 ms defaults
    rng = np.random.default_rng(9)
    n_samp = int(secs * 16000)
    jobs = [((rng.normal(size=n_samp) * 2000).astype(np.float32), cfg)
            for _ in range(n_utts)]
    out = compute_features_batch(jobs)  # warm up / compile
    n_frames = sum(f.shape[0] for f in out)
    audio_seconds = n_utts * secs
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = compute_features_batch(jobs)
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    return dt / audio_seconds, n_frames / dt / 1e3


def bench_decode_lv(comp, vocab, words, lm, T=500, batch=8, n_batches=2,
                    max_active=None, seed=2, reps=3, net=None):
    """Batched LV word-loop decode; returns xRT per chip (full pipeline:
    OutP + scan + host traceback). Median of `reps` timed passes."""
    import statistics

    from htk_jax.algo.decode import decode_batch
    from htk_jax.algo.lvnet import compile_lv_loop

    if net is None:
        net = compile_lv_loop(words, vocab, comp, lm=lm)
    rng = np.random.default_rng(seed)
    dim = comp.means.shape[1]
    feats = [rng.normal(size=(T, dim)).astype(np.float32)
             for _ in range(batch)]
    out = decode_batch(net, comp, feats, lm_scale=8.0, word_pen=-10.0,
                       max_active=max_active)  # warm up / compile
    assert any(r is not None for r in out)
    audio_seconds = n_batches * batch * T * 0.01
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n_batches):
            out = decode_batch(net, comp, feats, lm_scale=8.0,
                               word_pen=-10.0, max_active=max_active)
        times.append(time.perf_counter() - t0)

    # device-pipeline xRT: the ONE jitted program (OutP + scan +
    # traceback) with operands resident — excludes per-call host work
    from htk_jax.algo.decode import _BEAM_OFF, _lv_pipeline

    pipe = _lv_pipeline(net, comp, "highest", max_active, False)
    x = jnp.asarray(np.stack(feats))
    tr = jnp.asarray([T] * batch, jnp.int32)
    args = (jnp.asarray(8.0, jnp.float32), jnp.asarray(-10.0, jnp.float32),
            jnp.asarray(_BEAM_OFF, jnp.float32))
    r = pipe(x, tr, *args)
    jax.block_until_ready(r[0])
    dts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        r = pipe(x, tr, *args)
        jax.block_until_ready(r[0])
        dts.append(time.perf_counter() - t0)
    dev_xrt = statistics.median(dts) / (batch * T * 0.01)
    return statistics.median(times) / audio_seconds, net, dev_xrt


def build_net(comp, names, vocab_size=100, seed=1):
    from htk_jax.algo.net import compile_network
    from htk_jax.io.dictionary import Vocab
    from htk_jax.tools.hbuild import word_loop_lattice

    rng = np.random.default_rng(seed)
    v = Vocab()
    words = []
    for i in range(vocab_size):
        w = f"w{i}"
        n_ph = int(rng.integers(3, 6))
        v.add_pron(w, [names[j] for j in rng.integers(0, len(names), n_ph)])
        words.append(w)
    lat = word_loop_lattice(words)
    return compile_network(lat, v, comp)


def bench_decode(comp, net, n_utts=16, T=500, dim=39, batch=8, seed=2):
    """Batched decode throughput on the round-1 100-word loop."""
    from htk_jax.algo.decode import run_decode_batch
    from htk_jax.ops.outp import all_state_outp

    rng = np.random.default_rng(seed)
    comp_state = jnp.asarray(net.comp_state)
    means = jnp.asarray(comp.means)
    variances = jnp.asarray(comp.variances)
    gconsts = jnp.asarray(comp.gconsts)
    state_mix = jnp.asarray(comp.state_mix)
    state_logw = jnp.asarray(comp.state_logw)

    @jax.jit
    def outp_batch(feats):  # (B, T, D)
        def one(x):
            logb, _ = all_state_outp(
                x, means, variances, gconsts, state_mix, state_logw,
                precision="default",
            )
            return logb[:, comp_state]

        return jax.vmap(one)(feats)

    def decode_batch_(feats):
        return run_decode_batch(outp_batch(feats), net, 1.0, -10.0)

    feats = jnp.asarray(rng.normal(size=(batch, T, dim)).astype(np.float32))
    out = decode_batch_(feats)
    jax.block_until_ready(out)
    n_batches = max(1, n_utts // batch)
    t0 = time.perf_counter()
    for _ in range(n_batches):
        out = decode_batch_(feats)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    audio_seconds = n_batches * batch * T * 0.01
    return dt / audio_seconds


def bench_herest(comp, names, n_utts=16, T=500, dim=39, seed=3):
    """BW accumulation throughput (utt/s/chip), device-composite path."""
    from htk_jax.algo.trainer import (DeviceCompositeTrainer,
                                      prepare_utterance_ids)

    rng = np.random.default_rng(seed)
    # transcript length must fit the utterance: each model needs >= 3
    # emitting frames (SMOKE's short T made every utterance pathless)
    n_seq = min(40, T // 15)
    utts = []
    for i in range(n_utts):
        seq = [names[j] for j in rng.integers(0, len(names), n_seq)]
        feats = rng.normal(size=(T, dim)).astype(np.float32)
        utts.append(prepare_utterance_ids(comp, f"u{i}", feats, seq))
    tr = DeviceCompositeTrainer(comp, precision="default")
    tr.accumulate(utts[:8], batch_size=8)  # warm up (same padded shapes)
    t0 = time.perf_counter()
    n_pass = 4
    for _ in range(n_pass):
        accs = tr.accumulate(utts, batch_size=8)
    jax.block_until_ready(accs.occ)
    dt = time.perf_counter() - t0
    return n_pass * n_utts / dt


def bench_hdecode_batch(comp, vocab, words, lm, n_utts=64, seed=3, reps=2,
                        net=None):
    """HDecode pass-1 throughput: 64 mixed-length utterances through the
    bucketed batched lattice generator vs the per-utterance loop.
    Returns (batched_xrt, sequential_xrt). Every distinct length is a
    fresh compile on the sequential leg, so it only runs under
    BENCH_SEQ_LEG=1 and sequential_xrt is None otherwise."""
    import statistics

    from htk_jax.algo.decode import generate_lattice, generate_lattice_batch
    from htk_jax.algo.lvnet import compile_lv_loop

    if net is None:
        net = compile_lv_loop(words, vocab, comp, lm=lm)
    rng = np.random.default_rng(seed)
    # mixed-length utterances synthesized FROM the model — realistic
    # lattice density (the host record walk is proportional to arcs)
    feats, _trans = synth_corpus(comp, vocab, words, n_utts, (8, 19), rng)
    lens = np.asarray([f.shape[0] for f in feats])
    audio = float(lens.sum()) * 0.01
    order = sorted(range(n_utts), key=lambda i: int(lens[i]))
    bsz = 16

    def run_batched():
        # pad_to 256: mixed lengths land in ~3 padded shapes instead of
        # ~5 — cold compiles dominate this section
        for i0 in range(0, n_utts, bsz):
            idx = order[i0:i0 + bsz]
            generate_lattice_batch(net, comp, [feats[j] for j in idx],
                                   lm_scale=8.0, lattice_beam=150.0,
                                   pad_to=256)

    run_batched()  # compile
    tb = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run_batched()
        tb.append(time.perf_counter() - t0)
    # sequential loop: 2 utterances, one rep (it is the slow side being
    # replaced, and every distinct length is a fresh compile — the very
    # cost bucketed batching removes; 2 utts bound the section's time)
    seq_xrt = None
    if os.environ.get("BENCH_SEQ_LEG") == "1":
        t0 = time.perf_counter()
        for f in feats[:2]:
            generate_lattice(net, comp, f, lm_scale=8.0,
                             lattice_beam=150.0)
        seq_audio = float(sum(f.shape[0] for f in feats[:2])) * 0.01
        seq_xrt = (time.perf_counter() - t0) / seq_audio
    return statistics.median(tb) / audio, seq_xrt


def bench_mmi(comp, vocab, words, lm, net=None, n_utts=8, T=500, seed=5):
    """BASELINE config #5, discriminative half: per-utterance MMI pass
    (numerator transcript FB + denominator lattice generation + lattice
    FB accumulation) and the EBW update. The denominator runs the tool's
    blocked ArcFB path: all arcs of all lattices in the block, scored
    and accumulated in jitted 256-wide launches. Returns
    (mmi_utt_per_sec, ebw_update_s, n_arcs)."""
    from htk_jax.algo.ebw import EBWConfig, ebw_update
    from htk_jax.algo.fb import zero_accs
    from htk_jax.algo.decode import generate_lattice_batch
    from htk_jax.algo.latops import arc_posteriors
    from htk_jax.algo.lvnet import compile_lv_loop
    from htk_jax.algo.trainer import Trainer, prepare_utterance
    from htk_jax.tools.hmmirest import ArcFB, lattice_arc_utts

    if net is None:
        net = compile_lv_loop(words, vocab, comp, lm=lm)
    rng = np.random.default_rng(seed)
    trainer = Trainer(comp)
    arcfb = ArcFB(trainer, comp)
    period = 100000
    n_arcs = [0, 0]  # [lattice arcs, unique mini-utterances after dedup]

    feats, trans = synth_corpus(comp, vocab, words, n_utts,
                                max(3, T // 40), rng)

    def mmi_pass():
        num = zero_accs(comp.n_mix, comp.dim, comp.n_states, comp.max_mix,
                        trainer.tr_flat)
        den = zero_accs(comp.n_mix, comp.dim, comp.n_states, comp.max_mix,
                        trainer.tr_flat)
        # numerator: all transcript composite FBs in one batched call
        # (HERest/HMMIRest batch their numerator accumulation)
        utts = []
        for i in range(n_utts):
            phones = [p for w in trans[i]
                      for p in vocab.get(w).prons[0].phones]
            utts.append(prepare_utterance(comp, f"u{i}", feats[i], phones))
        accs = trainer.accumulate(utts, batch_size=8)
        num = jax.tree.map(lambda a, b: a + b, num, accs)
        # denominator: batched lattice generation (the HVite -z bucket
        # path) + blocked arc FB exactly as HMMIRest's flush() runs it
        lats = generate_lattice_batch(net, comp, feats, lm_scale=8.0,
                                      lattice_beam=150.0)
        fbank = arcfb.load_block(feats)
        all_utts, per_lat = [], []
        for i, lat in enumerate(lats):
            utts_i, a2n = lattice_arc_utts(
                lat, vocab, comp, feats[i], period, f"u{i}", arcfb, utt=i)
            per_lat.append((lat, a2n))
            all_utts.extend(utts_i)
        n_arcs[0] = sum(len(a2n) for _l, a2n in per_lat)
        n_arcs[1] = len(all_utts)
        arc_ll = arcfb.score(fbank, all_utts)
        wts = {}
        for lat, a2n in per_lat:
            for a in lat.arcs:
                nm = a2n.get(a.id)
                if nm is not None and nm in arc_ll:
                    a.aclike = arc_ll[nm]
            _lp, post = arc_posteriors(lat, lmscale=8.0, wdpenalty=0.0)
            gam = {aid: (float(np.exp(min(g, 0.0))) if g > -30 else 0.0)
                   for aid, g in post.items()}
            for aid, nm in a2n.items():
                wts[nm] = wts.get(nm, 0.0) + gam.get(aid, 0.0)
        den = arcfb.accumulate(fbank, all_utts, wts, den)
        return num, den

    num, den = mmi_pass()  # warm up / compile
    t0 = time.perf_counter()
    num, den = mmi_pass()
    dt = time.perf_counter() - t0

    t1 = time.perf_counter()
    ebw_update(comp, num, den, EBWConfig())
    ebw_s = time.perf_counter() - t1
    audio_s = sum(f.shape[0] for f in feats) * 0.01
    return n_utts / dt, ebw_s, n_arcs[0], n_arcs[1], dt / audio_s


def bench_bigvocab(n_words, max_active, seed=11, reps=3, B=8, T=500,
                   on_leg=None):
    """50k/100k-vocab factored cross-word LV decode (exact and top-A)
    at the big-vocab scales. Returns dict of xRT values.
    `on_leg(partial_dict)` is called after EVERY leg so results survive
    a section-watchdog kill mid-function."""
    import statistics

    from htk_jax.algo.decode import decode_batch
    from htk_jax.algo.lvnet import compile_lv_loop

    comp, vocab, words, lm = build_tied_triphone_system(
        n_words, n_tied=2000, seed=seed)
    net = compile_lv_loop(words, vocab, comp, lm=lm, factored=True)
    rng = np.random.default_rng(3)
    dim = comp.means.shape[1]
    feats = [rng.normal(size=(T, dim)).astype(np.float32)
             for _ in range(B)]
    audio = B * T * 0.01
    out = {}
    # adaptive = certificate-exact top-A (scores == exact; on this
    # noise corpus the certificate usually trips, so it measures the
    # fallback machinery's overhead vs plain exact)
    def run(name, ma, nt):
        # per-leg deadline guard: returning early keeps the legs already
        # measured instead of dying on the section watchdog mid-leg
        if _left() < 75:
            out[name + "_skipped"] = True
        else:
            try:
                decode_batch(nt, comp, feats, lm_scale=12.0,
                             max_active=ma)
                ts = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    decode_batch(nt, comp, feats, lm_scale=12.0,
                                 max_active=ma)
                    ts.append(time.perf_counter() - t0)
                out[name] = statistics.median(ts) / audio
            except TimeoutError:
                # the section watchdog fired mid-leg: the alarm is
                # one-shot, so swallowing it would leave the rest of the
                # section unguarded — surface the partials and re-raise
                out[name + "_error"] = "TimeoutError: section watchdog"
                if on_leg is not None:
                    on_leg(out)
                raise
            except Exception as e:  # pragma: no cover - backend-specific
                out[name + "_error"] = f"{type(e).__name__}: {e}"[:200]
        if on_leg is not None:
            on_leg(out)

    run("topA", max_active, net)
    run("adaptive", -max_active, net)
    run("exact", None, net)
    return out


def main():
    global _DEADLINE
    _import_jax()
    from htk_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    _DEADLINE = time.monotonic() + float(
        os.environ.get("BENCH_BUDGET_S", "1200"))
    backend = jax.default_backend()
    if backend != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        sys.exit(f"bench: no GPU (JAX backend is {backend}); set "
                 "JAX_PLATFORMS=cpu to run on the CPU")
    target = 0.01
    extra = {"backend": backend}
    if SMOKE:
        extra["smoke"] = True

    import signal

    sec_s = {}
    extra["sec_s"] = sec_s
    state = {"xrt_1k": None}

    def _emit(final=False):
        """Print the cumulative JSON snapshot NOW (flush) — the driver
        takes the LAST parseable line, so every completed section is
        evidence even if the process is killed mid-run."""
        ok_ = state["xrt_1k"] is not None and state["xrt_1k"] > 0
        snap = dict(extra)
        if not final:
            snap["partial"] = True
        print(json.dumps({
            "metric": "hvite_1kvocab_bigram_xrt_per_chip",
            "value": round(state["xrt_1k"], 6) if ok_ else -1.0,
            "unit": "xRT",
            "vs_baseline": round(target / state["xrt_1k"], 3) if ok_
            else 0.0,
            "extra": snap,
        }), flush=True)

    def _alarm(signum, frame):  # pragma: no cover - timing dependent
        raise TimeoutError("section watchdog")

    only = os.environ.get("BENCH_SECTIONS")
    only = set(only.split(",")) if only else None

    def section(key, min_s, fn, store=None, max_s=None):
        """Run one guarded bench section: skip when the deadline is too
        close, bound it with a SIGALRM watchdog, record (not raise)
        failures, and emit the cumulative JSON snapshot after — the
        JSON line must always come out with whatever was measured.
        `store(result)` folds the section's values into `extra` BEFORE
        that snapshot, so a kill right after a section never loses its
        numbers. BENCH_SECTIONS=a,b re-measures only the named sections
        (dev/debug knob). `max_s` caps a section known to degrade badly
        so it can never starve later sections."""
        if only is not None and key not in only:
            return None
        if _left() < min_s:
            extra[key + "_skipped"] = True
            return None
        # watchdog: a section may overrun its estimate but never eat
        # the whole remaining budget (leave 30 s for later emits)
        cap = max(30, int(min(_left(), 86400.0)) - 30)
        if max_s is not None:
            cap = min(cap, max_s)
        t0 = time.monotonic()
        old = None
        try:
            old = signal.signal(signal.SIGALRM, _alarm)
            signal.alarm(cap)
        except ValueError:  # not main thread; run unguarded
            old = None
        try:
            r = fn()
            if r is not None and store is not None:
                store(r)
            return r
        except Exception as e:  # pragma: no cover - depends on backend
            extra[key + "_error"] = f"{type(e).__name__}: {e}"[:300]
            return None
        finally:
            if old is not None:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, old)
            sec_s[key] = round(time.monotonic() - t0, 1)
            _emit()

    _emit()  # first snapshot immediately: proves liveness + backend

    # headline first: config #4 — 1k-vocab back-off bigram, tied-state
    # 8-mix triphones (the driver's `value` field)
    n1k = 100 if SMOKE else 1000
    comp1, vocab1, words1, lm1 = build_tied_triphone_system(
        n1k, n_tied=(200 if SMOKE else 2000))
    T1 = 100 if SMOKE else 500
    def _store_1k(r):
        state["xrt_1k"], n, dev_1k = r
        extra["hvite_1kvocab_device_xrt"] = round(dev_1k, 6)
        extra["net_1k_states"] = int(n.n_states)

    section("hvite_1k", 0, lambda: bench_decode_lv(
        comp1, vocab1, words1, lm1, T=T1, batch=(2 if SMOKE else 8)),
        store=_store_1k)

    # SECTION ORDER: after the headline, the rarely-measured rows run
    # before the continuity rows, so a budget kill costs old numbers.

    # config #5 scale: 5k vocab with histogram pruning (runs early only
    # because it builds net5, which mmi reuses; it is also itself a
    # BASELINE row)
    n5k = 200 if SMOKE else 5000
    comp5, vocab5, words5, lm5 = build_tied_triphone_system(
        n5k, n_tied=(200 if SMOKE else 2000), seed=7)
    net5 = None

    def _store_5k(r):
        xrt_5k, n, dev_5k = r
        extra["hdecode_5kvocab_xrt"] = round(xrt_5k, 6)
        extra["hdecode_5kvocab_device_xrt"] = round(dev_5k, 6)
        extra["net_5k_states"] = int(n.n_states)

    r = section("hdecode_5k", 120, lambda: bench_decode_lv(
        comp5, vocab5, words5, lm5, T=(100 if SMOKE else 500),
        batch=(2 if SMOKE else 16), n_batches=1, max_active=128),
        store=_store_5k)
    if r:
        net5 = r[1]

    # config #5 discriminative half: MMI accumulation + EBW update —
    # first on-chip capture of this row (dark rounds 1-4); the blocked
    # ArcFB path turned the old per-16-arc eager dispatch into a few
    # jitted 256-wide launches per pass
    section("mmi", 150, lambda: bench_mmi(
        comp5, vocab5, words5, lm5, net=net5,
        n_utts=(1 if SMOKE else 4), T=(100 if SMOKE else 500)),
        store=lambda r: extra.update(
            mmi_utt_per_sec=round(r[0], 3),
            ebw_update_s=round(r[1], 3),
            mmi_den_arcs=int(r[2]),
            mmi_unique_arc_utts=int(r[3]),
            mmi_xrt=round(r[4], 5)), max_s=420)

    # HDecode batch path: 64 mixed-length utterances through the
    # bucketed batched lattice generator. Runs right after mmi: it
    # reuses net5. The sequential leg is env-gated off.
    section("hdecode_batch", 120, lambda: bench_hdecode_batch(
        comp5, vocab5, words5, lm5, n_utts=(8 if SMOKE else 64), net=net5),
        store=lambda r: extra.update(
            {"hdecode_5k_batch64_xrt": round(r[0], 6)} | (
                {} if r[1] is None else
                {"hdecode_5k_seq_lattice_xrt": round(r[1], 6)})),
        max_s=360)

    # big-vocab rows with the top-A, adaptive-exact and exact legs;
    # deadline-gated per section
    for n_words, ma, key, est_s in ((20000, 128, "20k", 150),
                                    (50000, 256, "50k", 240),
                                    (100000, 256, "100k", 420)):
        if SMOKE:
            extra[f"hdecode_{key}_skipped"] = True
            continue
        def _store_big(r, key=key, ma=ma):
            for mode, label in (("topA", f"topA{ma}"),
                                ("adaptive", f"adaptive{ma}"),
                                ("exact", "exact")):
                if mode in r:
                    extra[f"hdecode_{key}_{label}_xrt"] = round(
                        r[mode], 6)
                elif mode + "_error" in r:
                    extra[f"hdecode_{key}_{label}_error"] = (
                        r[mode + "_error"])

        section(f"hdecode_{key}", est_s + 60,
                lambda n=n_words, m=ma, s=_store_big: bench_bigvocab(
                    n, m, on_leg=s),
                store=_store_big, max_s=est_s + 240)

    # round-4: single-pass trigram guidance on the 5k config — the
    # HLVRec-LM.c role (pass 1 scores word ends under each token's
    # trigram context); measured against the plain factored decode
    def _triguide():
        comp3, vocab3, words3, lm3 = build_tied_triphone_system(
            n5k, n_tied=(200 if SMOKE else 2000), seed=7, lm_order=3)
        from htk_jax.algo.lvnet import compile_lv_loop

        net3 = compile_lv_loop(words3, vocab3, comp3, lm=lm3,
                               trigram=True)
        netf = compile_lv_loop(words3, vocab3, comp3, lm=lm3,
                               factored=True)
        x3, _n, _d = bench_decode_lv(comp3, vocab3, words3, lm3,
                                     T=(100 if SMOKE else 500),
                                     batch=(2 if SMOKE else 8),
                                     n_batches=1, max_active=128,
                                     net=net3)
        xf, _n2, _d2 = bench_decode_lv(comp3, vocab3, words3, lm3,
                                       T=(100 if SMOKE else 500),
                                       batch=(2 if SMOKE else 8),
                                       n_batches=1, max_active=128,
                                       net=netf)
        return x3, xf

    section("triguide_5k", 150, _triguide, store=lambda r: extra.update(
        hdecode_5k_triguide_xrt=round(r[0], 6),
        hdecode_5k_plain_factored_xrt=round(r[1], 6)))

    # config #1: batched MFCC frontend (min_s values on these three
    # continuity rows reflect warm-cache costs — 4-8 s each measured —
    # so a tight tail still attempts them; the watchdog bounds overrun)
    section("hcopy", 30, lambda: bench_frontend(
        n_utts=(8 if SMOKE else 64), secs=(1.0 if SMOKE else 5.0)),
        store=lambda r: extra.update(
            hcopy_mfcc_xrt=round(r[0], 6),
            hcopy_kframes_per_sec=round(r[1], 1)))

    # round-1 continuity numbers (config #2: BW throughput)
    comp0, names0 = build_model()
    section("hvite_100w", 45, lambda: bench_decode(
        comp0, build_net(comp0, names0), T=(100 if SMOKE else 500),
        batch=(2 if SMOKE else 8)),
        store=lambda r: extra.update(hvite_100w_loop_xrt=round(r, 6)))
    section("herest", 45, lambda: bench_herest(
        comp0, names0, n_utts=(4 if SMOKE else 16),
        T=(100 if SMOKE else 500)),
        store=lambda r: extra.update(
            herest_bw_utt_per_sec_per_chip=round(r, 2)))

    extra["note"] = ("headline = BASELINE config #4 (1k-vocab back-off "
                     "bigram, tied-state 8-mix triphones); vs_baseline = "
                     "0.01 xRT target / measured")
    _emit(final=True)


if __name__ == "__main__":
    main()
