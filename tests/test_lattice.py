"""Lattice ops + EBW tests."""

import math

import numpy as np
import pytest

from htk_jax.algo.ebw import EBWConfig, ebw_update
from htk_jax.algo.fb import Accumulators
from htk_jax.algo.latops import arc_posteriors, best_path, prune, topo_order
from htk_jax.io.slf import Lattice, LArc, LNode, NULL_WORD

from test_fb import small_set


def diamond_lattice():
    """start -> {a | b} -> end, a better than b."""
    lat = Lattice()
    lat.nodes = [
        LNode(id=0, word=NULL_WORD),
        LNode(id=1, word="a", time=1.0),
        LNode(id=2, word="b", time=1.0),
        LNode(id=3, word=NULL_WORD, time=2.0),
    ]
    lat.arcs = [
        LArc(id=0, start=0, end=1, aclike=-10.0, lmlike=0.0),
        LArc(id=1, start=0, end=2, aclike=-12.0, lmlike=0.0),
        LArc(id=2, start=1, end=3, aclike=0.0, lmlike=0.0),
        LArc(id=3, start=2, end=3, aclike=0.0, lmlike=0.0),
    ]
    return lat


class TestLatOps:
    def test_topo_and_best_path(self):
        lat = diamond_lattice()
        order = topo_order(lat)
        assert order[0] == 0 and order[-1] == 3
        score, path = best_path(lat)
        assert [w for w, _t, _a in path] == ["a"]
        assert score == pytest.approx(-10.0)

    def test_posteriors_sum_to_one_per_cut(self):
        lat = diamond_lattice()
        total, post = arc_posteriors(lat)
        # the two parallel arcs' posteriors must sum to 1
        pa = math.exp(post[0])
        pb = math.exp(post[1])
        assert pa + pb == pytest.approx(1.0, rel=1e-6)
        assert pa > pb
        # total = logsumexp of both paths
        assert total == pytest.approx(np.logaddexp(-10.0, -12.0), rel=1e-6)

    def test_prune(self):
        lat = diamond_lattice()
        out = prune(lat, beam=1.0)  # b path is ~2 nats worse -> pruned
        words = {n.word for n in out.nodes}
        assert "b" not in words
        assert "a" in words

    def test_cycle_detection(self):
        from htk_jax.utils.errors import HTKError

        lat = diamond_lattice()
        lat.arcs.append(LArc(id=4, start=3, end=0))
        with pytest.raises(HTKError):
            topo_order(lat)


class TestEBW:
    def test_update_moves_toward_num(self):
        comp = small_set(nmix=1, seed=7)
        M, D = comp.n_mix, comp.dim
        S, mm = comp.state_mix.shape
        tr_flat = comp.log_transp.size

        # numerator says means should be at +1 relative to current;
        # denominator is diffuse at current means
        occ_n = np.full(M, 10.0, np.float32)
        target = comp.means + 1.0
        num = Accumulators(
            occ=occ_n,
            sum_x=(occ_n[:, None] * target).astype(np.float32),
            sum_xx=(occ_n[:, None] * (target**2 + comp.variances)).astype(np.float32),
            wt_occ=np.full((S, mm), 10.0, np.float32),
            tr=np.zeros(tr_flat, np.float32),
            total_logp=np.float32(0), total_frames=np.float32(0),
            n_utts=np.float32(1),
        )
        occ_d = np.full(M, 5.0, np.float32)
        den = Accumulators(
            occ=occ_d,
            sum_x=(occ_d[:, None] * comp.means).astype(np.float32),
            sum_xx=(occ_d[:, None] * (comp.means**2 + comp.variances)).astype(
                np.float32),
            wt_occ=np.full((S, mm), 5.0, np.float32),
            tr=np.zeros(tr_flat, np.float32),
            total_logp=np.float32(0), total_frames=np.float32(0),
            n_utts=np.float32(1),
        )
        m, v, w = ebw_update(comp, num, den, EBWConfig())
        # means move toward the numerator target, not past it
        delta = m - comp.means
        assert np.all(delta > 0.1)
        assert np.all(delta < 2.0)
        assert np.all(v > 0)

    def test_ismoothing_dampens(self):
        comp = small_set(nmix=1, seed=8)
        M, D = comp.n_mix, comp.dim
        S, mm = comp.state_mix.shape
        tr_flat = comp.log_transp.size
        occ = np.full(M, 4.0, np.float32)
        target = comp.means + 2.0
        mk = lambda o, mu: Accumulators(
            occ=o, sum_x=(o[:, None] * mu).astype(np.float32),
            sum_xx=(o[:, None] * (mu**2 + comp.variances)).astype(np.float32),
            wt_occ=np.full((S, mm), 4.0, np.float32),
            tr=np.zeros(tr_flat, np.float32),
            total_logp=np.float32(0), total_frames=np.float32(0),
            n_utts=np.float32(1))
        num = mk(occ, target)
        den = mk(occ * 0.5, comp.means)
        m1, _, _ = ebw_update(comp, num, den, EBWConfig(tau_i=0.0))
        m2, _, _ = ebw_update(comp, num, den, EBWConfig(tau_i=50.0))
        # I-smoothing interpolates toward the numerator's ML estimate
        d1 = np.abs(m1 - target).mean()
        d2 = np.abs(m2 - target).mean()
        assert d2 < d1


class TestMPE:
    def test_mpe_weights_sign(self):
        """Correct arc gets positive MPE weight, wrong arc negative."""
        from htk_jax.algo.latops import arc_mpe_weights
        from htk_jax.io.slf import Lattice, LArc, LNode, NULL_WORD

        lat = Lattice()
        lat.nodes = [
            LNode(id=0, word=NULL_WORD, time=0.0),
            LNode(id=1, word="right", time=1.0),
            LNode(id=2, word="wrong", time=1.0),
            LNode(id=3, word=NULL_WORD, time=1.0),
        ]
        lat.arcs = [
            LArc(id=0, start=0, end=1, aclike=-10.0),
            LArc(id=1, start=0, end=2, aclike=-10.5),  # near-competitive
            LArc(id=2, start=1, end=3, aclike=0.0),
            LArc(id=3, start=2, end=3, aclike=0.0),
        ]
        ref = [("right", 0.0, 1.0)]
        weights, c_avg = arc_mpe_weights(lat, ref)
        assert weights[0] > 0.01  # correct word arc pushed up
        assert weights[1] < -0.01  # competitor pushed down
        assert -1.0 < c_avg < 1.0
        # weights roughly balance (sum-to-zero property of MPE)
        assert abs(weights[0] + weights[1]) < 0.05

    def test_mpe_zero_when_certain(self):
        """A lattice with only the correct path yields ~zero weights."""
        from htk_jax.algo.latops import arc_mpe_weights
        from htk_jax.io.slf import Lattice, LArc, LNode, NULL_WORD

        lat = Lattice()
        lat.nodes = [
            LNode(id=0, word=NULL_WORD, time=0.0),
            LNode(id=1, word="right", time=1.0),
            LNode(id=2, word=NULL_WORD, time=1.0),
        ]
        lat.arcs = [
            LArc(id=0, start=0, end=1, aclike=-10.0),
            LArc(id=1, start=1, end=2, aclike=0.0),
        ]
        weights, c_avg = arc_mpe_weights(lat, [("right", 0.0, 1.0)])
        assert abs(weights[0]) < 1e-6
        assert c_avg == pytest.approx(1.0)


class TestOracleError:
    def _lat(self):
        from htk_jax.io.slf import Lattice, LArc, LNode, NULL_WORD

        lat = Lattice()
        lat.nodes = [LNode(id=0, word=NULL_WORD),
                     LNode(id=1, word="A"), LNode(id=2, word="B"),
                     LNode(id=3, word="C"), LNode(id=4, word=NULL_WORD)]
        lat.arcs = [LArc(id=0, start=0, end=1),
                    LArc(id=1, start=0, end=2),
                    LArc(id=2, start=1, end=3),
                    LArc(id=3, start=2, end=3),
                    LArc(id=4, start=3, end=4)]
        return lat

    def test_oracle_zero_when_path_exists(self):
        from htk_jax.algo.latops import oracle_error

        lat = self._lat()
        assert oracle_error(lat, ["A", "C"]) == (0, 2)
        assert oracle_error(lat, ["B", "C"]) == (0, 2)

    def test_oracle_counts_min_edits(self):
        from htk_jax.algo.latops import oracle_error

        lat = self._lat()
        # best path differs by one substitution
        assert oracle_error(lat, ["A", "D"]) == (1, 2)
        # deletion (ref word no path covers) and insertion
        assert oracle_error(lat, ["A", "C", "E"]) == (1, 3)
        assert oracle_error(lat, ["C"]) == (1, 1)
        assert oracle_error(lat, []) == (2, 0)
