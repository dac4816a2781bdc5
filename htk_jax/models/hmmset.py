"""Struct-of-arrays compilation of an HMMSet for device compute.

The device replacement for HTK's pointer-linked model structures
(`HTKLib/HModel.c` HMMSet/HLink/StateInfo/MixPDF): all Gaussians live in
one (M, D) block, all states in index tables, so GMM log-likelihoods for
*all* states x *all* frames evaluate as one matmul (ops/outp.py)
instead of HModel.c OutP's per-state scalar loops.

Macro tying (shared ~s/~m/~t structures) is preserved exactly: Python
object identity in the parsed MMF becomes shared row indices here, so a
tied state is one row of `state_mix` referenced by many models and
accumulator updates to it sum contributions from every sharer — the same
semantics as HTK's shared-pointer accumulators.

Only single-stream DIAGC sets are compiled for device use in this round
(the north-star configs); multi-stream and full-covariance sets still
load/save via io.mmf.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io.mmf import HMMSet, HMMDef, MixPDF, StateInfo
from ..utils.errors import HError
from ..utils.logmath import LZERO

MINMIX = 1e-5


@dataclass
class CompiledHMMSet:
    """Device-ready arrays for a single-stream diagonal-covariance HMMSet."""

    # Gaussian block (M physical mixture components, all streams packed).
    # Multi-stream packing: a stream-s Gaussian occupies only its stream's
    # column slice; other columns hold mean 0 / variance PAD_VAR so its
    # quadratic contribution outside the slice vanishes and OutP stays a
    # single matmul over the full feature vector.
    means: np.ndarray  # (M, D) f32
    variances: np.ndarray  # (M, D) f32
    gconsts: np.ndarray  # (M,) f32 (computed over the stream's slice only)
    # State block (S physical emitting states); slots are grouped in
    # per-stream blocks (slot_blocks) along the maxmix axis
    state_mix: np.ndarray  # (S, n_slots) int32 index into Gaussian block
    state_logw: np.ndarray  # (S, n_slots) f32 log mixture weights (LZERO pad)
    # Transition block (Tn physical transition matrices)
    log_transp: np.ndarray  # (Tn, Nmax, Nmax) f32 log probs (LZERO pad)
    # Model block (H logical HMMs)
    model_nstates: np.ndarray  # (H,) int32 total states incl. entry/exit
    model_states: np.ndarray  # (H, Nmax-2) int32 physical state ids (-1 pad)
    model_transp: np.ndarray  # (H,) int32 index into transition block
    names: List[str] = field(default_factory=list)
    name_to_id: Dict[str, int] = field(default_factory=dict)

    # discrete sets: per-state codeword log-prob table instead of Gaussians
    discrete: bool = False
    dprob_table: Optional[np.ndarray] = None  # (S, K_total) f32 log probs
    dprob_blocks: List = field(default_factory=list)  # [(k0, k1)] per stream

    # full-covariance sets (FULLC/LLTC): decode/align-only scorer inputs
    full_cov: bool = False
    fc_proj: Optional[np.ndarray] = None  # (M, D, D) precision Cholesky L
    fc_mu: Optional[np.ndarray] = None  # (M, D) mu @ L per Gaussian

    # multi-stream structure (single-stream sets: one block covering all)
    n_streams: int = 1
    stream_slices: List = field(default_factory=list)  # [(d0, d1)] per stream
    slot_blocks: List = field(default_factory=list)  # [(j0, j1)] per stream
    mix_stream: Optional[np.ndarray] = None  # (M,) int32 stream of each Gaussian
    state_sw: Optional[np.ndarray] = None  # (S, n_slots) stream-weight exponents

    # back-references for writing updates into the parsed MMF
    _mix_objs: List[MixPDF] = field(default_factory=list)
    _state_objs: List[StateInfo] = field(default_factory=list)
    _transp_objs: List[np.ndarray] = field(default_factory=list)
    _hset: Optional[HMMSet] = None

    @property
    def n_mix(self) -> int:
        return self.means.shape[0]

    @property
    def dim(self) -> int:
        return self.means.shape[1]

    @property
    def n_states(self) -> int:
        return self.state_mix.shape[0]

    @property
    def max_mix(self) -> int:
        return self.state_mix.shape[1]

    @property
    def n_models(self) -> int:
        return len(self.names)

    @property
    def nmax(self) -> int:
        return self.log_transp.shape[1]

    def model_id(self, name: str) -> int:
        i = self.name_to_id.get(name)
        if i is None:
            HError(7035, "CompiledHMMSet: no HMM named %s", name)
        return i


PAD_VAR = 1.0e30  # variance outside a Gaussian's stream slice (1/var ~ 0)


def compile_hmmset(hset: HMMSet) -> CompiledHMMSet:
    """Flatten a parsed HMMSet into SoA arrays (identity-based tying).

    Multi-stream sets pack every stream's Gaussians into the one Gaussian
    block: a stream-s component's mean/variance live in its stream's
    column slice (mean 0 / variance PAD_VAR elsewhere), its gConst is
    computed over that slice only, and each state's mixture slots are
    laid out in per-stream blocks (slot_blocks) with stream-weight
    exponents in state_sw. b_j(o) = sum_s sw_js * logsumexp over block s.
    """
    n_streams = len(hset.swidth)
    widths = list(hset.swidth)
    D = hset.vec_size or sum(widths)
    if sum(widths) != D:
        HError(7060, "compile_hmmset: stream widths %s != vecsize %d",
               widths, D)
    offs = np.concatenate([[0], np.cumsum(widths)]).astype(int)
    stream_slices = [(int(offs[s]), int(offs[s + 1])) for s in range(n_streams)]

    mix_ids: Dict[int, int] = {}
    mixes: List[MixPDF] = []
    mix_stream_l: List[int] = []
    state_ids: Dict[int, int] = {}
    states: List[StateInfo] = []
    transp_ids: Dict[int, int] = {}
    transps: List[np.ndarray] = []

    names = list(hset.hmms.keys())
    nmax = max(h.nstates for h in hset.hmms.values())

    # discrete set? (DPROB tables instead of Gaussians)
    first_state = next(iter(hset.hmms.values())).states[0]
    if first_state.streams[0].dprobs is not None:
        return _compile_discrete(hset, names, nmax, n_streams, stream_slices)

    for h in hset.hmms.values():
        for si in h.states:
            if id(si) not in state_ids:
                state_ids[id(si)] = len(states)
                states.append(si)
                for s in range(n_streams):
                    for mp in si.streams[s].mixes:
                        if mp is not None and id(mp) not in mix_ids:
                            if mp.cov_kind not in ("DIAGC", "FULLC", "LLTC"):
                                HError(
                                    7060,
                                    "compile_hmmset: covariance kind %s not "
                                    "device-supported", mp.cov_kind,
                                )
                            mix_ids[id(mp)] = len(mixes)
                            mixes.append(mp)
                            mix_stream_l.append(s)
        if id(h.transp) not in transp_ids:
            transp_ids[id(h.transp)] = len(transps)
            transps.append(h.transp)

    M = len(mixes)
    S = len(states)

    def live_mixes(se):
        return sum(1 for w, m in zip(se.weights, se.mixes)
                   if m is not None and w >= MINMIX)

    maxmix_s = [
        max(max(live_mixes(si.streams[s]) for si in states), 1)
        for s in range(n_streams)
    ]
    slot_offs = np.concatenate([[0], np.cumsum(maxmix_s)]).astype(int)
    slot_blocks = [(int(slot_offs[s]), int(slot_offs[s + 1]))
                   for s in range(n_streams)]
    n_slots = int(slot_offs[-1])

    means = np.zeros((M, D), np.float32)
    variances = np.full((M, D), PAD_VAR, np.float32)
    gconsts = np.zeros((M,), np.float32)
    for i, mp in enumerate(mixes):
        s = mix_stream_l[i]
        d0, d1 = stream_slices[s]
        if len(mp.mean) != d1 - d0:
            HError(7023, "compile_hmmset: stream %d Gaussian width %d != %d",
                   s + 1, len(mp.mean), d1 - d0)
        means[i, d0:d1] = mp.mean
        if mp.cov_kind == "DIAGC":
            variances[i, d0:d1] = mp.var
            # gConst over the stream's own dims (HModel.c per-stream gConst)
            gconsts[i] = float(
                (d1 - d0) * math.log(2 * math.pi)
                + np.sum(np.log(np.maximum(mp.var.astype(np.float64), 1e-38)))
            )
            mp.gconst = gconsts[i]
        else:
            # FULLC/LLTC: mp.var holds the precision matrix (or its LLT
            # factor); the diagonal-covariance arrays get placeholder
            # diag(Sigma) and the real scorer uses fc_proj/fc_mu below
            gconsts[i] = float(mp.fix_gconst())

    state_mix = np.full((S, n_slots), -1, np.int32)
    state_logw = np.full((S, n_slots), LZERO, np.float32)
    state_sw = np.zeros((S, n_slots), np.float32)
    for si_idx, si in enumerate(states):
        for s in range(n_streams):
            j0, _j1 = slot_blocks[s]
            j = j0
            sw = 1.0
            if si.stream_weights is not None and len(si.stream_weights) >= s + 1:
                sw = float(si.stream_weights[s])
            for w, mp in zip(si.streams[s].weights, si.streams[s].mixes):
                if mp is None or w < MINMIX:
                    continue
                state_mix[si_idx, j] = mix_ids[id(mp)]
                state_logw[si_idx, j] = np.log(w)
                j += 1
            state_sw[si_idx, slot_blocks[s][0] : slot_blocks[s][1]] = sw
    maxmix = n_slots

    Tn = len(transps)
    log_transp = np.full((Tn, nmax, nmax), LZERO, np.float32)
    for i, tp in enumerate(transps):
        n = tp.shape[0]
        with np.errstate(divide="ignore"):
            lt = np.where(tp > 0, np.log(np.maximum(tp, 1e-38)), LZERO)
        log_transp[i, :n, :n] = lt

    H = len(names)
    model_nstates = np.zeros((H,), np.int32)
    model_states = np.full((H, nmax - 2), -1, np.int32)
    model_transp = np.zeros((H,), np.int32)
    for hi, name in enumerate(names):
        h = hset.hmms[name]
        model_nstates[hi] = h.nstates
        for k, si in enumerate(h.states):
            model_states[hi, k] = state_ids[id(si)]
        model_transp[hi] = transp_ids[id(h.transp)]

    # full-covariance sets: per-Gaussian Cholesky factor of the precision
    # matrix, embedded in full-D columns so the scorer stays one batched
    # contraction (ops/outp.full_cov_mix_scores); diag Gaussians in a
    # mixed set embed 1/sqrt(var) on the diagonal
    full_cov = any(mp.cov_kind != "DIAGC" for mp in mixes)
    fc_proj = fc_mu = None
    if full_cov:
        fc_proj = np.zeros((M, D, D), np.float32)
        fc_mu = np.zeros((M, D), np.float32)
        for i, mp in enumerate(mixes):
            s = mix_stream_l[i]
            d0, d1 = stream_slices[s]
            if mp.cov_kind == "DIAGC":
                rt = 1.0 / np.sqrt(mp.var.astype(np.float64))
                fc_proj[i, d0:d1, d0:d1] = np.diag(rt)
                fc_mu[i, d0:d1] = mp.mean.astype(np.float64) * rt
                continue
            if mp.cov_kind == "LLTC":
                # stored triangular factor of the precision (read back
                # from the symmetrised trimat) [LC]
                Lf = np.tril(mp.var.astype(np.float64))
                P = Lf @ Lf.T
            else:  # FULLC: <INVCOVAR> is the precision matrix itself
                P = mp.var.astype(np.float64)
            L = np.linalg.cholesky(P)  # P = L L^T -> quad = ||L^T(x-mu)||^2
            fc_proj[i, d0:d1, d0:d1] = L  # y = x @ L computes L^T x
            fc_mu[i, d0:d1] = mp.mean.astype(np.float64) @ L
            variances[i, d0:d1] = np.maximum(
                np.diag(np.linalg.inv(P)), 1e-10).astype(np.float32)

    return CompiledHMMSet(
        full_cov=full_cov,
        fc_proj=fc_proj,
        fc_mu=fc_mu,
        n_streams=n_streams,
        stream_slices=stream_slices,
        slot_blocks=slot_blocks,
        mix_stream=np.asarray(mix_stream_l, np.int32),
        state_sw=state_sw,
        means=means,
        variances=variances,
        gconsts=gconsts,
        state_mix=state_mix,
        state_logw=state_logw,
        log_transp=log_transp,
        model_nstates=model_nstates,
        model_states=model_states,
        model_transp=model_transp,
        names=names,
        name_to_id={n: i for i, n in enumerate(names)},
        _mix_objs=mixes,
        _state_objs=states,
        _transp_objs=transps,
        _hset=hset,
    )


def _compile_discrete(hset, names, nmax, n_streams, stream_slices):
    """Discrete-HMM compile: per-state codeword log-prob table (HVQ path)."""
    from ..io.mmf import dprob_to_logp

    state_ids: Dict[int, int] = {}
    states: List[StateInfo] = []
    transp_ids: Dict[int, int] = {}
    transps: List[np.ndarray] = []
    for h in hset.hmms.values():
        for si in h.states:
            if id(si) not in state_ids:
                state_ids[id(si)] = len(states)
                states.append(si)
        if id(h.transp) not in transp_ids:
            transp_ids[id(h.transp)] = len(transps)
            transps.append(h.transp)
    S = len(states)
    sizes = [len(states[0].streams[s].dprobs) for s in range(n_streams)]
    k_offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    dprob_blocks = [(int(k_offs[s]), int(k_offs[s + 1]))
                    for s in range(n_streams)]
    table = np.full((S, int(k_offs[-1])), LZERO, np.float32)
    state_sw = np.ones((S, n_streams), np.float32)
    for i, si in enumerate(states):
        for s in range(n_streams):
            k0, k1 = dprob_blocks[s]
            table[i, k0:k1] = dprob_to_logp(si.streams[s].dprobs)
            if si.stream_weights is not None and len(si.stream_weights) > s:
                state_sw[i, s] = float(si.stream_weights[s])

    Tn = len(transps)
    log_transp = np.full((Tn, nmax, nmax), LZERO, np.float32)
    for i, tp in enumerate(transps):
        n = tp.shape[0]
        with np.errstate(divide="ignore"):
            log_transp[i, :n, :n] = np.where(
                tp > 0, np.log(np.maximum(tp, 1e-38)), LZERO
            )

    H = len(names)
    model_nstates = np.zeros((H,), np.int32)
    model_states = np.full((H, nmax - 2), -1, np.int32)
    model_transp = np.zeros((H,), np.int32)
    for hi, name in enumerate(names):
        h = hset.hmms[name]
        model_nstates[hi] = h.nstates
        for k, si in enumerate(h.states):
            model_states[hi, k] = state_ids[id(si)]
        model_transp[hi] = transp_ids[id(h.transp)]

    return CompiledHMMSet(
        discrete=True,
        dprob_table=table,
        dprob_blocks=dprob_blocks,
        n_streams=n_streams,
        stream_slices=stream_slices,
        state_sw=state_sw,
        means=np.zeros((0, hset.vec_size or 1), np.float32),
        variances=np.zeros((0, hset.vec_size or 1), np.float32),
        gconsts=np.zeros((0,), np.float32),
        state_mix=np.full((S, 1), -1, np.int32),
        state_logw=np.full((S, 1), LZERO, np.float32),
        log_transp=log_transp,
        model_nstates=model_nstates,
        model_states=model_states,
        model_transp=model_transp,
        names=list(names),
        name_to_id={n: i for i, n in enumerate(names)},
        _state_objs=states,
        _transp_objs=transps,
        _hset=hset,
    )


def write_back_retrained(
    comp: CompiledHMMSet,
    means2: np.ndarray,  # (M, D2)
    vars2: np.ndarray,  # (M, D2)
    new_parm_kind: int,
    g_var: Optional[np.ndarray] = None,
) -> HMMSet:
    """Write single-pass-retrained Gaussians (HERest -r) into the set.

    The second channel's width D2 may differ from the current models'
    (that is the point of single-pass retraining: switch frontends
    without realigning). Every mean/variance is replaced wholesale, the
    set's vecSize/parmKind become the new channel's, and the varFloor
    macro (if present) is rebuilt as 1% of the new channel's global
    variance (the HCompV convention). Single-stream sets only — HTK's
    -r path is likewise a plain single-channel retrain.
    """
    import math as _math

    if comp.stream_slices and len(comp.stream_slices) > 1:
        HError(7060, "write_back_retrained: single-pass retraining "
                     "supports single-stream sets only")
    D2 = int(means2.shape[1])
    for i, mp in enumerate(comp._mix_objs):
        mp.mean = np.asarray(means2[i], np.float32).copy()
        mp.var = np.asarray(vars2[i], np.float32).copy()
        mp.gconst = float(
            D2 * _math.log(2 * _math.pi)
            + np.sum(np.log(np.maximum(mp.var.astype(np.float64), 1e-38)))
        )
    hs = comp._hset
    hs.vec_size = D2
    hs.parm_kind = int(new_parm_kind)
    if hs.stream_widths:
        hs.stream_widths = [D2]
    vmac = hs.macros.get("v", {})
    if "varFloor1" in vmac and g_var is not None:
        vmac["varFloor1"] = np.asarray(0.01 * g_var, np.float32)
    return hs


def write_back_discrete(comp: CompiledHMMSet, table_logp: np.ndarray) -> HMMSet:
    """Write an updated codeword log-prob table back into the HMMSet."""
    from ..io.mmf import logp_to_dprob

    for i, si in enumerate(comp._state_objs):
        for s, (k0, k1) in enumerate(comp.dprob_blocks):
            si.streams[s].dprobs = logp_to_dprob(table_logp[i, k0:k1])
    comp.dprob_table = np.asarray(table_logp, np.float32)
    return comp._hset


def write_back(
    comp: CompiledHMMSet,
    means: Optional[np.ndarray] = None,
    variances: Optional[np.ndarray] = None,
    weights: Optional[np.ndarray] = None,
    transps: Optional[np.ndarray] = None,
) -> HMMSet:
    """Write updated SoA parameters back into the parsed HMMSet objects.

    `weights` is (S, maxmix) linear weights; `transps` is (Tn, Nmax, Nmax)
    linear probabilities. Shared objects are updated once (they are the
    same Python objects everywhere they are tied). Returns the HMMSet for
    saving via io.mmf.save_mmf.
    """
    if comp.full_cov and (means is not None or variances is not None):
        HError(7060, "write_back: full-covariance sets are decode/align-"
                     "only here — train/adapt with DIAGC models")
    if means is not None or variances is not None:
        import math as _math

        ms = (comp.mix_stream if comp.mix_stream is not None
              else np.zeros(len(comp._mix_objs), np.int32))
        for i, mp in enumerate(comp._mix_objs):
            d0, d1 = comp.stream_slices[int(ms[i])] if comp.stream_slices \
                else (0, comp.dim)
            if means is not None:
                mp.mean = np.asarray(means[i, d0:d1], np.float32).copy()
                comp.means[i, d0:d1] = mp.mean
            if variances is not None:
                mp.var = np.asarray(variances[i, d0:d1], np.float32).copy()
                comp.variances[i, d0:d1] = mp.var
            # per-stream gConst over the stream's own dims
            mp.gconst = float(
                (d1 - d0) * _math.log(2 * _math.pi)
                + np.sum(np.log(np.maximum(mp.var.astype(np.float64), 1e-38)))
            )
        comp.gconsts = np.array([m.gconst for m in comp._mix_objs], np.float32)
    if weights is not None:
        blocks = comp.slot_blocks or [(0, comp.max_mix)]
        for si_idx, si in enumerate(comp._state_objs):
            for s, (j0, _j1) in enumerate(blocks):
                se = si.streams[s]
                j = j0
                for k, (w, mp) in enumerate(zip(se.weights, se.mixes)):
                    if mp is None or w < MINMIX:
                        continue
                    se.weights[k] = float(weights[si_idx, j])
                    j += 1
        with np.errstate(divide="ignore"):
            comp.state_logw = np.where(
                comp.state_mix >= 0,
                np.log(np.maximum(np.asarray(weights, np.float32), 1e-38)),
                LZERO,
            ).astype(np.float32)
    if transps is not None:
        for i, tp in enumerate(comp._transp_objs):
            n = tp.shape[0]
            tp[:, :] = np.asarray(transps[i, :n, :n], np.float32)
        with np.errstate(divide="ignore"):
            comp.log_transp = np.where(
                transps > 0, np.log(np.maximum(transps, 1e-38)), LZERO
            ).astype(np.float32)
    return comp._hset
