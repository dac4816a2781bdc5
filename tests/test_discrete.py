"""Discrete (VQ) HMM tests: MMF round-trip, training EM, decoding."""

import numpy as np
import pytest

from htk_jax.algo.fb_discrete import (DiscreteTrainer, discrete_state_scores,
                                      reestimate_discrete)
from htk_jax.algo.trainer import prepare_utterance
from htk_jax.io.mmf import (dprob_to_logp, load_mmf, logp_to_dprob, save_mmf)
from htk_jax.models.hmmset import (compile_hmmset, write_back,
                                   write_back_discrete)
from htk_jax.models.proto import clone_proto, make_discrete_proto
from htk_jax.utils.logmath import LZERO


def discrete_set(K=8, seed=0):
    hs = make_discrete_proto(nstates=4, codebook_sizes=[K])
    cl = clone_proto(hs, "proto", ["a", "b"])
    rng = np.random.default_rng(seed)
    # bias each model's states toward distinct codewords
    for nm, h in cl.hmms.items():
        for si in h.states:
            p = np.full(K, 0.02)
            fav = rng.integers(0, K, 2)
            p[fav] += 1.0
            p /= p.sum()
            si.streams[0].dprobs = logp_to_dprob(np.log(p))
    return cl


class TestDProb:
    def test_roundtrip(self):
        p = np.array([0.5, 0.25, 0.125, 0.125])
        d = logp_to_dprob(np.log(p))
        lp = dprob_to_logp(d)
        np.testing.assert_allclose(np.exp(lp), p, rtol=1e-3)

    def test_floor(self):
        d = logp_to_dprob(np.array([LZERO]))
        assert d[0] == 32767
        assert dprob_to_logp(d)[0] == LZERO


class TestDiscreteMMF:
    def test_roundtrip_with_rle(self, tmp_path):
        cl = discrete_set()
        p = str(tmp_path / "d.mmf")
        save_mmf(cl, p)
        txt = open(p).read()
        assert "<DPROB>" in txt
        h2 = load_mmf(p)
        c1 = compile_hmmset(cl)
        c2 = compile_hmmset(h2)
        assert c2.discrete
        np.testing.assert_allclose(c1.dprob_table, c2.dprob_table, atol=1e-3)

    def test_rle_syntax(self, tmp_path):
        hs = make_discrete_proto(nstates=3, codebook_sizes=[16])
        p = str(tmp_path / "u.mmf")
        save_mmf(hs, p)
        txt = open(p).read()
        # uniform table -> run-length encoded as one value*16
        assert "*16" in txt
        h2 = load_mmf(p)
        c2 = compile_hmmset(h2)
        np.testing.assert_allclose(
            np.exp(c2.dprob_table[0]), 1.0 / 16, rtol=1e-2
        )


class TestDiscreteTraining:
    def make_corpus(self, comp, n=6, seed=1):
        rng = np.random.default_rng(seed)
        utts = []
        for i in range(n):
            seq = ["a", "b"] if i % 2 else ["b", "a"]
            T = int(rng.integers(16, 30))
            # sample codewords from each model's favoured distribution
            idx = np.zeros((T, 1), np.float32)
            per = T // len(seq)
            t = 0
            for nm in seq:
                h = comp._hset.hmms[nm]
                p = np.exp(dprob_to_logp(h.states[0].streams[0].dprobs))
                p /= p.sum()
                for _ in range(per):
                    if t < T:
                        idx[t, 0] = 1 + rng.choice(len(p), p=p)
                        t += 1
            while t < T:
                idx[t, 0] = 1
                t += 1
            utts.append(prepare_utterance(comp, f"u{i}", idx, seq))
        return utts

    def test_em_monotonic(self):
        cl = discrete_set(seed=2)
        comp = compile_hmmset(cl)
        utts = self.make_corpus(comp)
        fixed = [(u.name, u.feats, [comp.names[i] for i in u.hmm.model_ids])
                 for u in utts]
        logps = []
        for _ in range(3):
            tr = DiscreteTrainer(comp)
            accs = tr.accumulate(utts)
            logps.append(float(accs.total_logp))
            table, new_tr = reestimate_discrete(comp, accs)
            write_back_discrete(comp, table)
            write_back(comp, transps=new_tr)
            comp = compile_hmmset(cl)
            utts = [prepare_utterance(comp, nm, fx, seq)
                    for nm, fx, seq in fixed]
        assert np.all(np.diff(logps) > -1e-2), logps
        assert logps[-1] > logps[0]

    def test_state_scores(self):
        cl = discrete_set(seed=3)
        comp = compile_hmmset(cl)
        idx = np.array([[1], [2], [3]], np.int64)
        sc = discrete_state_scores(comp, idx)
        assert sc.shape == (3, comp.dprob_table.shape[0])
        # matches direct table lookup
        for t in range(3):
            np.testing.assert_allclose(
                sc[t], comp.dprob_table[:, idx[t, 0] - 1], atol=1e-5
            )
