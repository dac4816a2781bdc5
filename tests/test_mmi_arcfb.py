"""Numerical parity of the device-resident ArcFB against per-arc
reference FB (HFBLat.c DoFBLat semantics).

The round-5 ArcFB moved the MMI arc path fully on-device (feature bank
+ composite banks + index-only launches). These tests pin its
accumulators to the per-utterance fb_utterance reference on the SAME
arc set, so a banking/indexing bug cannot hide behind a small-corpus
100%-WER e2e test.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from htk_jax.algo.fb import fb_utterance, zero_accs
from htk_jax.algo.trainer import Trainer
from htk_jax.models.hmmset import compile_hmmset
from htk_jax.models.proto import clone_proto, make_proto
from htk_jax.tools.hmmirest import ArcFB, ArcUtt


@pytest.fixture(scope="module")
def comp():
    rng = np.random.default_rng(3)
    hs = make_proto(nstates=5, dim=8, parm_kind="USER", nmix=2)
    cl = clone_proto(hs, "proto", ["aa", "iy", "uw", "sil"])
    for h in cl.hmms.values():
        for si in h.states:
            for mp in si.streams[0].mixes:
                mp.mean = rng.normal(size=8).astype(np.float32)
                mp.var = (0.5 + rng.random(8)).astype(np.float32)
                mp.fix_gconst()
    return compile_hmmset(cl)


def _reference_accumulate(comp, trainer, feats_list, arcs, weights):
    """Per-arc fb_utterance with host-sliced features (the pre-round-5
    path's math, unbatched)."""
    from htk_jax.algo.composite import build_composite
    from htk_jax.algo.trainer import UttData, pad_batch

    total = zero_accs(comp.n_mix, comp.dim, comp.n_states, comp.max_mix,
                      trainer.tr_flat)
    params = trainer.params()
    for (u, t0, t1, ids), w in zip(arcs, weights):
        hmm = build_composite(comp, list(ids))
        ud = UttData(name="x", feats=feats_list[u][t0:t1], hmm=hmm)
        arrs = pad_batch([ud], comp.n_states)
        logp, accs = fb_utterance(
            jnp.asarray(arrs["feats"][0]), jnp.asarray(arrs["t_real"][0]),
            jnp.asarray(arrs["comp_state"][0]), jnp.asarray(arrs["q_mask"][0]),
            jnp.asarray(arrs["logA"][0]), jnp.asarray(arrs["a0"][0]),
            jnp.asarray(arrs["aE"][0]), jnp.asarray(arrs["tr_seg"][0]),
            jnp.asarray(arrs["entry_seg"][0]),
            jnp.asarray(arrs["exit_seg"][0]),
            weight=jnp.float32(w),
            means=params[0], variances=params[1], gconsts=params[2],
            state_mix=params[3], state_logw=params[4], state_sw=params[5],
            slot_blocks=tuple(comp.slot_blocks) or None,
            n_states=comp.n_states, tr_flat=trainer.tr_flat,
        )
        import jax

        total = jax.tree.map(lambda a, b: a + b, total, accs)
    return total


def test_arcfb_score_and_accumulate_match_reference(comp):
    rng = np.random.default_rng(7)
    trainer = Trainer(comp)
    arcfb = ArcFB(trainer, comp, batch=64)

    # three utterances of different lengths, arcs of varied spans and
    # pronunciations (incl. duplicates of the same (ids, t0, t1))
    feats_list = [rng.normal(size=(T, 8)).astype(np.float32) * 0.5
                  for T in (40, 57, 33)]
    prons = [("aa",), ("aa", "iy"), ("uw", "iy", "aa"), ("sil",)]
    id_of = {p: tuple(comp.model_id(x) for x in p) for p in prons}
    arcs = []
    for u, T in enumerate((40, 57, 33)):
        for _ in range(17):
            p = prons[int(rng.integers(len(prons)))]
            ids = id_of[p]
            span = int(rng.integers(9 * len(p), 9 * len(p) + 16))
            t0 = int(rng.integers(0, max(1, T - span)))
            t1 = min(T, t0 + span)
            arcs.append((u, t0, t1, ids))
    weights = rng.random(len(arcs)).astype(np.float64)

    # device-resident path: register + dedupe identical (ids, t0, t1)
    utts, w_by_name = [], {}
    seen = {}
    for k, (u, t0, t1, ids) in enumerate(arcs):
        arcfb.composite(ids)
        key = (ids, t0, t1, u)
        nm = seen.get(key)
        if nm is None:
            nm = f"a{k}"
            seen[key] = nm
            utts.append(ArcUtt(name=nm, utt=u, t0=t0, t1=t1, ids=ids))
        w_by_name[nm] = w_by_name.get(nm, 0.0) + float(weights[k])
    fbank = arcfb.load_block(feats_list)

    # scores match per-arc forward loglik
    lls = arcfb.score(fbank, utts)
    from htk_jax.algo.composite import build_composite
    from htk_jax.algo.fb import loglik_utterance
    from htk_jax.algo.trainer import UttData, pad_batch

    params = trainer.params()
    for uu in utts:
        hmm = build_composite(comp, list(uu.ids))
        ud = UttData(name="x", feats=feats_list[uu.utt][uu.t0:uu.t1],
                     hmm=hmm)
        arrs = pad_batch([ud], comp.n_states)
        ref = float(loglik_utterance(
            jnp.asarray(arrs["feats"][0]), jnp.asarray(arrs["t_real"][0]),
            jnp.asarray(arrs["comp_state"][0]),
            jnp.asarray(arrs["q_mask"][0]),
            jnp.asarray(arrs["logA"][0]), jnp.asarray(arrs["a0"][0]),
            jnp.asarray(arrs["aE"][0]),
            means=params[0], variances=params[1], gconsts=params[2],
            state_mix=params[3], state_logw=params[4],
            state_sw=params[5],
            slot_blocks=tuple(comp.slot_blocks) or None))
        assert lls[uu.name] == pytest.approx(ref, rel=1e-5, abs=1e-3), \
            f"{uu.name}: {lls[uu.name]} vs {ref}"

    # accumulators match the per-arc reference (weights folded; the
    # device path sums duplicates' weights linearly — same algebra)
    total = zero_accs(comp.n_mix, comp.dim, comp.n_states, comp.max_mix,
                      trainer.tr_flat)
    total = arcfb.accumulate(fbank, utts, w_by_name, total)
    ref = _reference_accumulate(comp, trainer, feats_list, arcs, weights)
    for name in ("occ", "sum_x", "sum_xx", "wt_occ", "tr"):
        got = np.asarray(getattr(total, name))
        want = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(
            got, want, rtol=2e-4, atol=2e-3,
            err_msg=f"accumulator {name} diverged")


def test_arcfb_padding_rows_are_inert(comp):
    """A launch whose batch is mostly padding must contribute nothing
    from the padded rows (t_real == 0 gating in fb_batch)."""
    rng = np.random.default_rng(11)
    trainer = Trainer(comp)
    arcfb = ArcFB(trainer, comp, batch=4096)  # one launch, heavy padding
    feats_list = [rng.normal(size=(30, 8)).astype(np.float32) * 0.5]
    ids = (comp.model_id("aa"),)
    arcfb.composite(ids)
    utts = [ArcUtt(name="only", utt=0, t0=2, t1=20, ids=ids)]
    fbank = arcfb.load_block(feats_list)
    total = zero_accs(comp.n_mix, comp.dim, comp.n_states, comp.max_mix,
                      trainer.tr_flat)
    total = arcfb.accumulate(fbank, utts, {"only": 1.0}, total)
    assert float(np.asarray(total.n_utts)) == 1.0
    # occupancy mass == weighted frame count of the single real arc
    assert float(np.asarray(total.occ).sum()) == pytest.approx(18.0,
                                                               rel=1e-4)
