"""Multi-stream HMM tests: compile packing, OutP product, FB parity, EM."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from htk_jax.algo.reestimate import UpdateFlags, reestimate
from htk_jax.algo.trainer import Trainer, prepare_utterance
from htk_jax.io.mmf import load_mmf, save_mmf
from htk_jax.models.hmmset import PAD_VAR, compile_hmmset, write_back
from htk_jax.models.proto import clone_proto, make_proto
from htk_jax.ops.outp import all_state_outp
from htk_jax.utils.logmath import LZERO


def ms_set(seed=0, widths=(3, 2), nmix=1):
    dim = sum(widths)
    hs = make_proto(nstates=4, dim=dim, parm_kind="USER",
                    nmix=nmix, stream_widths=list(widths))
    cl = clone_proto(hs, "proto", ["a", "b"])
    rng = np.random.default_rng(seed)
    for h in cl.hmms.values():
        for si in h.states:
            for s, se in enumerate(si.streams):
                w = widths[s]
                for mp in se.mixes:
                    mp.mean = rng.normal(size=w).astype(np.float32)
                    mp.var = (0.5 + rng.random(w)).astype(np.float32)
                    mp.fix_gconst()
    return cl


class TestCompile:
    def test_packing(self):
        cl = ms_set()
        comp = compile_hmmset(cl)
        assert comp.n_streams == 2
        assert comp.stream_slices == [(0, 3), (3, 5)]
        assert comp.slot_blocks == [(0, 1), (1, 2)]
        # stream-0 Gaussians padded with PAD_VAR on stream-1 columns
        s0 = comp.mix_stream == 0
        assert np.all(comp.variances[s0][:, 3:] == PAD_VAR)
        assert np.all(comp.means[s0][:, 3:] == 0.0)
        s1 = comp.mix_stream == 1
        assert np.all(comp.variances[s1][:, :3] == PAD_VAR)

    def test_outp_matches_naive_product(self):
        cl = ms_set(seed=1)
        comp = compile_hmmset(cl)
        rng = np.random.default_rng(2)
        x = rng.normal(size=(6, 5)).astype(np.float32)
        logb, _ = all_state_outp(
            jnp.asarray(x), jnp.asarray(comp.means),
            jnp.asarray(comp.variances), jnp.asarray(comp.gconsts),
            jnp.asarray(comp.state_mix), jnp.asarray(comp.state_logw),
            slot_blocks=tuple(comp.slot_blocks),
            state_sw=jnp.asarray(comp.state_sw),
        )
        logb = np.asarray(logb)
        # naive: product over streams of single-Gaussian likelihoods
        sid = 0
        for h in cl.hmms.values():
            for si in h.states:
                for t in range(6):
                    want = 0.0
                    for s, (d0, d1) in enumerate(comp.stream_slices):
                        mp = si.streams[s].mixes[0]
                        xs = x[t, d0:d1].astype(np.float64)
                        lp = -0.5 * (
                            (d1 - d0) * math.log(2 * math.pi)
                            + np.sum(np.log(mp.var.astype(np.float64)))
                            + np.sum((xs - mp.mean) ** 2 / mp.var)
                        )
                        want += lp
                    # find this state's physical index
                    pass
        # simpler: check against manual computation per physical state
        for q in range(comp.n_states):
            si = comp._state_objs[q]
            for t in range(6):
                want = 0.0
                for s, (d0, d1) in enumerate(comp.stream_slices):
                    mp = si.streams[s].mixes[0]
                    xs = x[t, d0:d1].astype(np.float64)
                    want += -0.5 * (
                        (d1 - d0) * math.log(2 * math.pi)
                        + np.sum(np.log(mp.var.astype(np.float64)))
                        + np.sum((xs - mp.mean) ** 2 / mp.var)
                    )
                assert logb[t, q] == pytest.approx(want, rel=1e-4, abs=1e-3)

    def test_stream_weight_exponents(self):
        cl = ms_set(seed=3)
        for h in cl.hmms.values():
            for si in h.states:
                si.stream_weights = np.array([2.0, 0.5], np.float32)
        comp = compile_hmmset(cl)
        rng = np.random.default_rng(4)
        x = rng.normal(size=(3, 5)).astype(np.float32)
        logb, _ = all_state_outp(
            jnp.asarray(x), jnp.asarray(comp.means),
            jnp.asarray(comp.variances), jnp.asarray(comp.gconsts),
            jnp.asarray(comp.state_mix), jnp.asarray(comp.state_logw),
            slot_blocks=tuple(comp.slot_blocks),
            state_sw=jnp.asarray(comp.state_sw),
        )
        logb = np.asarray(logb)
        q = 0
        si = comp._state_objs[q]
        for t in range(3):
            want = 0.0
            for s, (d0, d1), gamma in [(0, comp.stream_slices[0], 2.0),
                                       (1, comp.stream_slices[1], 0.5)]:
                mp = si.streams[s].mixes[0]
                xs = x[t, d0:d1].astype(np.float64)
                lp = -0.5 * ((d1 - d0) * math.log(2 * math.pi)
                             + np.sum(np.log(mp.var.astype(np.float64)))
                             + np.sum((xs - mp.mean) ** 2 / mp.var))
                want += gamma * lp
            assert logb[t, q] == pytest.approx(want, rel=1e-4, abs=1e-3)


class TestTraining:
    def test_em_monotonic_multistream(self):
        cl = ms_set(seed=5, nmix=2)
        comp = compile_hmmset(cl)
        rng = np.random.default_rng(6)
        utts = []
        for i in range(5):
            T = int(rng.integers(15, 35))
            feats = (rng.normal(size=(T, 5)) + 0.5).astype(np.float32)
            utts.append(prepare_utterance(comp, f"u{i}", feats,
                                          ["a", "b"] if i % 2 else ["b", "a"]))
        logps = []
        for it in range(3):
            tr = Trainer(comp)
            accs = tr.accumulate(utts, batch_size=4)
            logps.append(float(accs.total_logp))
            m, v, w, t = reestimate(comp, accs, UpdateFlags.parse("tmvw"),
                                    min_var=1e-4)
            write_back(comp, means=m, variances=v, weights=w, transps=t)
            utts = [prepare_utterance(comp, u.name, u.feats,
                                      [comp.names[i] for i in u.hmm.model_ids])
                    for u in utts]
        assert np.all(np.diff(logps) > -1e-2), logps
        assert logps[-1] > logps[0]
        # padded variance columns stay PAD_VAR through write_back
        s0 = comp.mix_stream == 0
        assert np.all(comp.variances[s0][:, 3:] == PAD_VAR)

    def test_mmf_roundtrip_multistream(self, tmp_path):
        cl = ms_set(seed=7, nmix=2)
        p = str(tmp_path / "ms.mmf")
        save_mmf(cl, p)
        h2 = load_mmf(p)
        assert h2.swidth == [3, 2]
        comp2 = compile_hmmset(h2)
        assert comp2.n_streams == 2
        comp1 = compile_hmmset(cl)
        rng = np.random.default_rng(8)
        x = rng.normal(size=(4, 5)).astype(np.float32)

        def outp(c):
            lb, _ = all_state_outp(
                jnp.asarray(x), jnp.asarray(c.means), jnp.asarray(c.variances),
                jnp.asarray(c.gconsts), jnp.asarray(c.state_mix),
                jnp.asarray(c.state_logw),
                slot_blocks=tuple(c.slot_blocks),
                state_sw=jnp.asarray(c.state_sw),
            )
            return np.asarray(lb)

        np.testing.assert_allclose(outp(comp1), outp(comp2), atol=1e-3)
