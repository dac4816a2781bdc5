"""HMMIRest — MMI discriminative training (lattice-based EBW).

Mirrors `HTKTools/HMMIRest.c` (SURVEY.md §3.5): numerator (reference) and
denominator (recognition-lattice) occupancies accumulate separately, then
Extended Baum-Welch updates the Gaussians.

Batched lattice forward-backward (HArc/HFBLat role): every word arc of
the denominator lattice becomes a mini-utterance (its pronunciation's
phone chain over its time span); arcs batch through the same FB scans as
HERest, a host-side DAG forward-backward turns per-arc log-likelihoods
into arc posteriors, and a second weighted FB pass accumulates
gamma-scaled statistics. Exact for HVite-style time-marked lattices.

Deviation from HTK: lattices here are *word* lattices (HVite -z output)
plus a dictionary (-d), instead of HTK's phone-marked lattices; the
phone-level information HTK pre-marks is recovered by per-arc alignment
on the fly. [LC]

Usage: HMMIRest [options] hmmList trainFiles...

  -H mmf   load HMM macro file (repeatable)   -M dir  output directory
  -q dir   numerator lattice dir (else -I MLF transcriptions are used)
  -r dir   denominator lattice dir (required)
  -d dict  dictionary for word->phone expansion
  -I mlf   numerator transcriptions (phone level, as HERest)
  -s f     LM scale for lattice posteriors (default 1.0)
  -u tmvw  update flags (accepted; EBW updates m,v,w)
  Config (HMMIREST module): E (default 2.0), ISMOOTHTAU (default 0),
  MINVAR
  Standard: -A -C -D -S -T -V
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional

import numpy as np

from ..algo.composite import build_composite
from ..algo.ebw import EBWConfig, ebw_update
from ..algo.fb import zero_accs
from ..algo.latops import arc_posteriors
from ..algo.trainer import Trainer, prepare_utterance
from ..io.dictionary import read_dict
from ..io.mlf import MLF, find_labels
from ..io.mmf import load_hmm_list, load_mmf, save_mmf
from ..io.slf import NULL_WORD, read_slf
from ..models.hmmset import compile_hmmset, write_back
from ..utils.cli import Option, parse_args, tool_main
from ..utils.errors import HError, HRError
from ._common import open_speech_file, preload_corpus

USAGE = "Usage: HMMIRest [options] hmmList trainFiles..."

OPTS = {
    "H": Option("H", 1, "load MMF", repeatable=True),
    "M": Option("M", 1, "output directory"),
    "q": Option("q", 1, "numerator lattice dir"),
    "r": Option("r", 1, "denominator lattice dir"),
    "d": Option("d", 1, "dictionary"),
    "I": Option("I", 1, "numerator MLF", repeatable=True),
    "L": Option("L", 1, "label dir"),
    "X": Option("X", 1, "label ext"),
    "s": Option("s", 1, "LM scale", typ=float),
    "u": Option("u", 1, "update flags"),
}


class ArcUtt(NamedTuple):
    """One unique arc mini-utterance, by reference into the block's
    feature bank — no per-arc host arrays at all."""

    name: str
    utt: int  # index into the current block's feature bank
    t0: int
    t1: int
    ids: tuple  # phone-id tuple (composite registry key)


def lattice_arc_utts(lat, vocab, comp, feats, period, stem, arcfb, utt=0):
    """Word arcs -> (unique ArcUtt list, {arc id: utt name}).

    Arcs sharing (pronunciation, start frame, end frame) collapse to ONE
    mini-utterance (the `HArc.c` arc-sharing role): identical FB
    problems score identically, and their posterior weights sum linearly
    into the accumulators. Dense HVite/HDecode lattices repeat the same
    word over the same span under many predecessor contexts.

    Composites register with `arcfb` (device composite bank); the
    returned ArcUtts carry only (utt index, frame span, registry key).
    """
    words_of = {n.id: n.word for n in lat.nodes}
    times_of = {n.id: n.time for n in lat.nodes}
    utts = []
    arc2name = {}
    seen = {}
    T = feats.shape[0]
    for a in lat.arcs:
        w = a.word if a.word is not None else words_of.get(a.end)
        if not w or w == NULL_WORD:
            continue
        t0 = int(round(times_of[a.start] * 1e7 / period))
        t1 = int(round(times_of[a.end] * 1e7 / period))
        t0 = max(0, min(t0, T - 1))
        t1 = max(t0 + 1, min(t1, T))
        wd = vocab.get(w)
        if wd is None:
            HRError(8621, "HMMIRest: word %s not in dictionary", w)
            continue
        # word-internal context expansion (HNet.c FindModel order): on a
        # triphone set, raw monophone prons would score STALE monophone
        # models — the den statistics then systematically disagree with
        # the (triphone) numerator and the EBW update corrupts the set
        phones = arcfb.phone_map(wd.prons[0].phones)
        try:
            ids = tuple(comp.model_id(p) for p in phones)
        except Exception:
            continue
        hmm = arcfb.composite(ids)
        if hmm is None:
            continue
        if t1 - t0 < hmm.n_states // max(len(phones), 1):
            t1 = min(T, t0 + max(hmm.n_states, 1))
        key = (ids, t0, t1)
        nm = seen.get(key)
        if nm is None:
            nm = f"{stem}:{a.id}"
            seen[key] = nm
            utts.append(ArcUtt(name=nm, utt=utt, t0=t0, t1=t1, ids=ids))
        arc2name[a.id] = nm
    return utts, arc2name


def _bucket(n: int, base: int = 32) -> int:
    b = base
    while b < n:
        b = b * 2 if b < 512 else b + 256
    return b


class ArcFB:
    """Device-resident arc scoring/accumulation — the `HFBLat.c : DoFBLat`
    role (SURVEY §2.5 row 6).

    Three design layers, each removing a host<->device cliff
    (benchmarks/mmi_profile.py):

    1. JITTED wide batches (not eager 16-arc dispatch loops): arcs are
       tiny (one word: ~9-15 composite states, ~10-100 frames), bucketed
       by padded (T, Q) and launched ~1024 wide.
    2. Per-launch transfer is FOUR int32 vectors (utt index, start
       frame, frame count, composite id). The block's feature matrices
       upload ONCE as a (U, Tmax+pad, D) bank; every distinct composite
       uploads ONCE into a per-Q-bucket device bank. The previous design
       shipped (B, T, D) frame slices + (B, Q, Q) transition planes per
       launch.
    3. fb_batch's global scatter keeps accumulator intermediates at
       (B*Q*maxmix), not (B, M, D), and gather_outp scores only the
       ~Q*maxmix Gaussians an arc touches (all-M scoring at width 1024
       is a multi-GB (B, T, M) plane).
    """

    def __init__(self, trainer, comp, batch: int = 1024):
        from ..algo.net import word_internal_phone_map

        self.trainer = trainer
        self.comp = comp
        self.batch = int(batch)
        self.phone_map = word_internal_phone_map(comp.names)
        self.composite_cache: dict = {}  # ids -> CompositeHMM
        self._members: dict = {}  # qb -> [ids] in bank order
        self._comp_idx: dict = {}  # ids -> (qb, index)
        self._banks: dict = {}  # qb -> dict of device arrays
        self._dirty: set = set()
        self._params = trainer.params()
        self._score_steps: dict = {}  # (Tb, Qb) -> jitted fn
        self._acc_steps: dict = {}

    # -- composite registry / device banks --------------------------------
    def composite(self, ids):
        hmm = self.composite_cache.get(ids)
        if hmm is None:
            try:
                hmm = build_composite(self.comp, list(ids))
            except Exception:
                return None
            self.composite_cache[ids] = hmm
            qb = _bucket(hmm.n_states, 16)
            mem = self._members.setdefault(qb, [])
            self._comp_idx[ids] = (qb, len(mem))
            mem.append(ids)
            self._dirty.add(qb)
        return hmm

    def _bank(self, qb):
        if qb in self._dirty or qb not in self._banks:
            import jax.numpy as jnp

            from ..utils.logmath import LZERO

            mem = self._members[qb]
            N = len(mem)
            S = self.comp.n_states
            comp_state = np.full((N, qb), S, np.int32)
            q_mask = np.zeros((N, qb), bool)
            logA = np.full((N, qb, qb), LZERO, np.float32)
            a0 = np.full((N, qb), LZERO, np.float32)
            aE = np.full((N, qb), LZERO, np.float32)
            tr_seg = np.full((N, qb, qb), -1, np.int32)
            entry_seg = np.full((N, qb), -1, np.int32)
            exit_seg = np.full((N, qb), -1, np.int32)
            for i, ids in enumerate(mem):
                h = self.composite_cache[ids]
                q = h.n_states
                comp_state[i, :q] = np.minimum(h.comp_state, S)
                q_mask[i, :q] = True
                logA[i, :q, :q] = h.logA
                a0[i, :q] = h.a0
                aE[i, :q] = h.aE
                tr_seg[i, :q, :q] = h.tr_seg
                entry_seg[i, :q] = h.entry_seg
                exit_seg[i, :q] = h.exit_seg
            self._banks[qb] = {
                "comp_state": jnp.asarray(comp_state),
                "q_mask": jnp.asarray(q_mask),
                "logA": jnp.asarray(logA),
                "a0": jnp.asarray(a0), "aE": jnp.asarray(aE),
                "tr_seg": jnp.asarray(tr_seg),
                "entry_seg": jnp.asarray(entry_seg),
                "exit_seg": jnp.asarray(exit_seg),
            }
            self._dirty.discard(qb)
        return self._banks[qb]

    def load_block(self, feats_list):
        """Upload a block's feature matrices as one padded device bank.

        The bank carries `pad = bucket(Tmax)` zero frames at the end so
        any (t0, t0+Tb) dynamic slice is in bounds."""
        import jax.numpy as jnp

        U = len(feats_list)
        D = self.comp.dim
        Tmax = max(int(f.shape[0]) for f in feats_list)
        pad = _bucket(Tmax)
        bank = np.zeros((U, Tmax + pad, D), np.float32)
        for u, f in enumerate(feats_list):
            bank[u, : f.shape[0]] = f
        return jnp.asarray(bank)

    # -- jitted steps ------------------------------------------------------
    def _make_score_step(self, Tb):
        import functools

        import jax

        from ..algo.fb import loglik_batch

        comp = self.comp
        slot_blocks = tuple(comp.slot_blocks) or None
        D = comp.dim

        @jax.jit
        def step(params, fbank, cbank, utt_idx, t0, t_real, cidx):
            means, variances, gconsts, state_mix, state_logw, state_sw = params

            def slice_one(u, s0):
                return jax.lax.dynamic_slice(fbank, (u, s0, 0),
                                             (1, Tb, D))[0]

            feats = jax.vmap(slice_one)(utt_idx, t0)
            return loglik_batch(
                feats, t_real, cbank["comp_state"][cidx],
                cbank["q_mask"][cidx], cbank["logA"][cidx],
                cbank["a0"][cidx], cbank["aE"][cidx],
                means=means, variances=variances, gconsts=gconsts,
                state_mix=state_mix, state_logw=state_logw,
                state_sw=state_sw, slot_blocks=slot_blocks,
                gather_outp=True,
            )

        return step

    def _make_acc_step(self, Tb):
        import jax

        from ..algo.fb import fb_batch

        comp = self.comp
        slot_blocks = tuple(comp.slot_blocks) or None
        D = comp.dim
        n_states, tr_flat = comp.n_states, self.trainer.tr_flat

        @jax.jit
        def step(params, fbank, cbank, utt_idx, t0, t_real, cidx, weights):
            means, variances, gconsts, state_mix, state_logw, state_sw = params

            def slice_one(u, s0):
                return jax.lax.dynamic_slice(fbank, (u, s0, 0),
                                             (1, Tb, D))[0]

            feats = jax.vmap(slice_one)(utt_idx, t0)
            return fb_batch(
                feats, t_real, cbank["comp_state"][cidx],
                cbank["q_mask"][cidx], cbank["logA"][cidx],
                cbank["a0"][cidx], cbank["aE"][cidx],
                cbank["tr_seg"][cidx], cbank["entry_seg"][cidx],
                cbank["exit_seg"][cidx], weights,
                means=means, variances=variances, gconsts=gconsts,
                state_mix=state_mix, state_logw=state_logw,
                state_sw=state_sw, slot_blocks=slot_blocks,
                n_states=n_states, tr_flat=tr_flat,
                gather_outp=True,
            )

        return step

    def _buckets(self, utts):
        """Group ArcUtts by (Tb, Qb); width scales down with Tb so the
        per-launch activation footprint stays roughly constant."""
        groups: dict = {}
        for u in utts:
            qb, _i = self._comp_idx[u.ids]
            tb = _bucket(u.t1 - u.t0)
            groups.setdefault((tb, qb), []).append(u)
        out = []
        for (tb, qb), us in sorted(groups.items()):
            bw = max(32, (self.batch * 32) // tb)
            for i0 in range(0, len(us), bw):
                out.append((tb, qb, bw, us[i0:i0 + bw]))
        return out

    def _idx_arrays(self, batch, bw):
        utt_idx = np.zeros(bw, np.int32)
        t0 = np.zeros(bw, np.int32)
        t_real = np.zeros(bw, np.int32)  # 0 = padding (fb_batch drops)
        cidx = np.zeros(bw, np.int32)
        for i, u in enumerate(batch):
            utt_idx[i] = u.utt
            t0[i] = u.t0
            t_real[i] = u.t1 - u.t0
            cidx[i] = self._comp_idx[u.ids][1]
        return utt_idx, t0, t_real, cidx

    def score(self, fbank, utts) -> dict:
        """Batched per-arc acoustic log-likelihoods: {utt name: ll}."""
        import jax.numpy as jnp

        arc_ll = {}
        pending = []
        for tb, qb, bw, batch in self._buckets(utts):
            step = self._score_steps.get((tb,))
            if step is None:
                step = self._score_steps[(tb,)] = self._make_score_step(tb)
            cbank = self._bank(qb)
            utt_idx, t0, t_real, cidx = self._idx_arrays(batch, bw)
            lls = step(self._params, fbank, cbank,
                       jnp.asarray(utt_idx), jnp.asarray(t0),
                       jnp.asarray(t_real), jnp.asarray(cidx))
            # collect device arrays; materialise after all dispatches so
            # host index prep overlaps device compute
            pending.append((batch, lls))
        for batch, lls in pending:
            for u, ll in zip(batch, np.asarray(lls)[: len(batch)]):
                arc_ll[u.name] = float(ll)
        return arc_ll

    def accumulate(self, fbank, utts, weights_by_name, total):
        """Weight-scaled FB accumulation over arc mini-utterances.

        `weights_by_name[u.name]` carries each mini-utterance's summed
        arc-posterior weight (duplicate arcs fold linearly)."""
        import jax
        import jax.numpy as jnp

        for tb, qb, bw, batch in self._buckets(utts):
            weights = np.zeros(bw, np.float32)
            any_w = False
            for i, u in enumerate(batch):
                w = float(weights_by_name.get(u.name, 0.0))
                weights[i] = w
                any_w = any_w or w > 0
            if not any_w:
                continue
            step = self._acc_steps.get((tb,))
            if step is None:
                step = self._acc_steps[(tb,)] = self._make_acc_step(tb)
            cbank = self._bank(qb)
            utt_idx, t0, t_real, cidx = self._idx_arrays(batch, bw)
            _logps, accs = step(self._params, fbank, cbank,
                                jnp.asarray(utt_idx), jnp.asarray(t0),
                                jnp.asarray(t_real), jnp.asarray(cidx),
                                jnp.asarray(weights))
            total = jax.tree.map(lambda a, b: a + b, total, accs)
        return total


def accumulate_lattice(lat, vocab, comp, trainer, feats, period, stem,
                       lm_scale, total, arcfb=None):
    """MMI denominator: arc-posterior-weighted accumulation (HFBLat role)."""
    if arcfb is None:
        arcfb = ArcFB(trainer, comp)
    fbank = arcfb.load_block([feats])
    utts, arc2name = lattice_arc_utts(lat, vocab, comp, feats, period, stem,
                                      arcfb, utt=0)
    if not utts:
        return total, 0.0
    arc_ll = arcfb.score(fbank, utts)
    for a in lat.arcs:
        nm = arc2name.get(a.id)
        if nm is not None:
            a.aclike = arc_ll[nm]
    logp, post = arc_posteriors(lat, lmscale=lm_scale, wdpenalty=0.0)
    wname: dict = {}
    for aid, g in post.items():
        nm = arc2name.get(aid)
        if nm is not None and g > -30:
            wname[nm] = wname.get(nm, 0.0) + float(np.exp(min(g, 0.0)))
    total = arcfb.accumulate(fbank, utts, wname, total)
    return total, logp


def run(argv: List[str]) -> int:
    ta = parse_args("HMMIRest", argv, OPTS, min_args=1, usage=USAGE)
    cfg = ta.config
    hmm_list_file = ta.args[0]
    files = ta.script + ta.args[1:]
    if not files:
        HError(1030, "HMMIRest: no training files\n%s", USAGE)
    mmfs = ta.get_all("H")
    if not mmfs:
        HError(1030, "HMMIRest: at least one -H mmf required")
    if not ta.has("r"):
        HError(1030, "HMMIRest: denominator lattice dir (-r) required")

    hset = load_mmf(mmfs, cfg=ta.config)
    load_hmm_list(hmm_list_file, ta.config)
    comp = compile_hmmset(hset)
    vocab = read_dict(ta.get("d"), ta.config) if ta.has("d") else None
    mlfs = [MLF.load(p, ta.config) for p in ta.get_all("I")]
    lm_scale = float(ta.get("s", 1.0) or 1.0)

    ecfg = EBWConfig(
        e=cfg.flt_("E", 2.0, module="HMMIREST"),
        tau_i=cfg.flt_("ISMOOTHTAU", 0.0, module="HMMIREST"),
        min_var=cfg.flt_("MINVAR", 1e-6, module="HMMIREST"),
    )
    # LATPROBSCALE (HFBLat.c probScale, typically 1/grammar-scale):
    # scales the WHOLE lattice score exponent before posteriors, so the
    # denominator's occupancy mass spreads over competitors instead of
    # sitting one-hot on the best path — without it EBW over-sharpens
    kappa = cfg.flt_("LATPROBSCALE", 1.0, module="HMMIREST")

    trainer = Trainer(comp)
    num_total = zero_accs(comp.n_mix, comp.dim, comp.n_states, comp.max_mix,
                          trainer.tr_flat)
    den_total = zero_accs(comp.n_mix, comp.dim, comp.n_states, comp.max_mix,
                          trainer.tr_flat)

    import jax

    mode = (cfg.str_("DISCRMODE", "MMI", module="HMMIREST") or "MMI").upper()
    period = int(cfg.flt_("TARGETRATE", 100000.0, module="HPARM"))
    total_acc_exp = 0.0
    null_words = (set() if vocab is None else {
        w.name for w in vocab.words.values() if w.prons[0].out_sym == ""})

    # Utterances accumulate in BLOCKS (HMMIREST: ACCBLOCK, default 8):
    # arc mini-utterances from every lattice in the block share one
    # length-bucketed scoring pass and one accumulation pass, cutting
    # kernel-launch count ~ACCBLOCK-fold (each launch pays fixed
    # dispatch latency on an accelerator). Per-lattice posterior math
    # is unchanged — only the device batching crosses utterances.
    # ARCBATCH (default 256) sets the padded width of each jitted arc
    # launch; arcs are tiny so wide is cheap.
    acc_block = int(cfg.int_("ACCBLOCK", 8, module="HMMIREST") or 8)
    arc_batch = int(cfg.int_("ARCBATCH", 256, module="HMMIREST") or 256)
    arcfb = ArcFB(trainer, comp, batch=arc_batch)
    pend: List[dict] = []
    # per-side lattice total logP under the CURRENT model — the MMI
    # criterion num-den delta across iterations is the training
    # regression signal (HFBLat.c prints the same totals)
    lat_lp = {"num_lat": 0.0, "den_lat": 0.0}

    def flush():
        nonlocal num_total, den_total, total_acc_exp
        if not pend:
            return
        from ..algo.latops import arc_mpe_weights

        # 1) upload the block's feature bank, expand every lattice
        # (host builds only index tuples); role tags keep numerator/
        # denominator arc names distinct per utterance
        fbank = arcfb.load_block([it["data"] for it in pend])
        jobs = []
        all_utts = []
        for ui, it in enumerate(pend):
            for role, tag in (("num_lat", "#n"), ("den_lat", "#d")):
                lat = it.get(role)
                if lat is None:
                    continue
                utts, a2n = lattice_arc_utts(
                    lat, vocab, comp, it["data"], period, it["stem"] + tag,
                    arcfb, utt=ui)
                if not utts:
                    continue
                jobs.append((role, lat, utts, a2n, it))
                all_utts.extend(utts)
        # 2) ONE blocked scoring pass for every arc in the block
        arc_ll = arcfb.score(fbank, all_utts) if all_utts else {}
        num_utts: List = []
        den_utts: List = []
        num_w: dict = {}
        den_w: dict = {}
        for role, lat, utts, a2n, it in jobs:
            for a in lat.arcs:
                nm = a2n.get(a.id)
                if nm is not None and nm in arc_ll:
                    a.aclike = arc_ll[nm]
            if it.get("mpe_ref") is not None:
                weights, c_avg = arc_mpe_weights(
                    lat, it["mpe_ref"], lmscale=lm_scale * kappa,
                    wdpenalty=0.0, null_words=null_words, acscale=kappa)
                num_utts.extend(utts)
                den_utts.extend(utts)
                # duplicate arcs fold linearly; positive parts feed the
                # numerator bucket, negative the denominator
                for aid, nm in a2n.items():
                    w = weights.get(aid, 0.0)
                    num_w[nm] = num_w.get(nm, 0.0) + (w if w > 0 else 0.0)
                    den_w[nm] = den_w.get(nm, 0.0) + (-w if w < 0 else 0.0)
                total_acc_exp += c_avg
                if ta.trace >= 2:
                    print(f"  {it['stem']}: expected accuracy {c_avg:.3f}")
                continue
            logp, post = arc_posteriors(lat, lmscale=lm_scale * kappa,
                                        wdpenalty=0.0, acscale=kappa)
            lat_lp[role] += float(logp)
            gam = {aid: (float(np.exp(min(g, 0.0))) if g > -30 else 0.0)
                   for aid, g in post.items()}
            t_utts, t_w = ((num_utts, num_w) if role == "num_lat"
                           else (den_utts, den_w))
            t_utts.extend(utts)
            for aid, nm in a2n.items():
                t_w[nm] = t_w.get(nm, 0.0) + gam.get(aid, 0.0)
            if role == "den_lat" and ta.trace >= 2:
                print(f"  {it['stem']}: den logP {logp:.2f}")
        # 3) ONE blocked accumulation pass per side (weights keyed by
        # arc-utterance name — arc ids collide across lattices)
        if num_utts:
            num_total = arcfb.accumulate(fbank, num_utts, num_w, num_total)
        if den_utts:
            den_total = arcfb.accumulate(fbank, den_utts, den_w, den_total)
        # 4) transcript numerators: one batched composite-FB call
        tutts = [it["num_utt"] for it in pend if it.get("num_utt")]
        if tutts:
            accs = trainer.accumulate(tutts, batch_size=acc_block)
            num_total = jax.tree.map(lambda a, b: a + b, num_total, accs)
        pend.clear()

    pre = preload_corpus(files, cfg)
    for fn in files:
        data, _p, _k, e = pre.get(fn) or open_speech_file(fn, cfg)
        stem = os.path.splitext(os.path.basename(e.logical))[0]

        den_path = os.path.join(ta.get("r"), f"{stem}.lat")
        if not os.path.exists(den_path):
            HRError(12030, "HMMIRest: no denominator lattice for %s", stem)
            continue
        den_lat = read_slf(den_path, ta.config)
        if vocab is None:
            HError(1030, "HMMIRest: word lattices need a dictionary (-d)")
        item = {"stem": stem, "data": data, "den_lat": den_lat}

        if mode in ("MPE", "MWE"):
            # MPE/MWE: positive/negative accuracy-weighted arc
            # occupancies from the same lattice
            # (algo/latops.arc_mpe_weights); needs a *timed* word
            # reference (e.g. HVite -a output).
            tr = find_labels(e.logical, mlfs, ta.get("L"), ta.get("X", "lab"))
            ref = [
                (l.name, (l.start or 0) / 1e7, (l.end or 0) / 1e7)
                for l in tr.labels
            ]
            if not any(r[2] > r[1] for r in ref):
                HError(12040, "HMMIRest MPE: reference MLF for %s has no "
                              "times (align with HVite -a first)", stem)
            item["mpe_ref"] = ref
        elif ta.has("q"):
            item["num_lat"] = read_slf(
                os.path.join(ta.get("q"), f"{stem}.lat"), ta.config)
        else:
            tr = find_labels(e.logical, mlfs, ta.get("L"), ta.get("X", "lab"))
            names = [l.name for l in tr.labels]
            item["num_utt"] = prepare_utterance(comp, stem, data, names)
        pend.append(item)
        if len(pend) >= acc_block:
            flush()
    flush()

    num_lp = float(np.asarray(num_total.total_logp))
    den_occ = float(np.asarray(den_total.occ).sum())
    num_occ = float(np.asarray(num_total.occ).sum())
    if ta.trace:
        print(f"HMMIRest: num occ {num_occ:.1f}, den occ {den_occ:.1f}, "
              f"num logP {num_lp:.2f}")
        if mode == "MMI":
            # the MMI objective under the INPUT model (lattices fixed):
            # numerator path logP (kappa-scaled to match the
            # denominator's exponent) minus the denominator lattice
            # total — this must RISE across HMMIRest iterations
            # (tests/test_e2e_latt.py pins it)
            num_side = (lat_lp["num_lat"] if ta.has("q")
                        else kappa * num_lp)
            print(f"HMMIRest: MMI criterion {num_side - lat_lp['den_lat']:.2f}"
                  f" (num {num_side:.2f}, den {lat_lp['den_lat']:.2f})")

    var_floor = hset.macros["v"].get("varFloor1")
    m, v, w = ebw_update(comp, num_total, den_total, ecfg, var_floor)
    write_back(comp, means=m, variances=v, weights=w)

    out_dir = ta.get("M", ".")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, os.path.basename(mmfs[0]))
    save_mmf(hset, out, binary=ta.binary)
    if ta.trace:
        print(f"HMMIRest: saved {out}")
    return 0


main = tool_main(run)

if __name__ == "__main__":
    raise SystemExit(main())
