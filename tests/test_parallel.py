"""Parallel-training invariants (SURVEY.md §4): serial == sharded == acc-files."""

import jax
import numpy as np
import pytest

from htk_jax.algo.trainer import Trainer, prepare_utterance
from htk_jax.parallel.acc_files import dump_accs, load_accs, sum_accs
from htk_jax.parallel.mesh import ShardedTrainer, make_mesh

from test_fb import small_set


def corpus(comp_set, n=10, seed=0):
    rng = np.random.default_rng(seed)
    utts = []
    for i in range(n):
        T = int(rng.integers(12, 50))
        feats = (rng.normal(size=(T, 3)) * 1.5).astype(np.float32)
        seq = [["a", "b"], ["b", "a"], ["a", "b", "a"]][i % 3]
        utts.append(prepare_utterance(comp_set, f"u{i}", feats, seq))
    return utts


class TestShardedEqualsSerial:
    def test_psum_matches_serial(self):
        assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
        comp_set = small_set(nmix=2, seed=1)
        utts = corpus(comp_set)
        serial = Trainer(comp_set).accumulate(utts, batch_size=4)
        sharded = ShardedTrainer(comp_set, make_mesh(8)).accumulate(
            utts, batch_size=1
        )
        for f in serial._fields:
            np.testing.assert_allclose(
                np.asarray(getattr(serial, f)),
                np.asarray(getattr(sharded, f)),
                rtol=5e-5,
                atol=5e-5,
                err_msg=f,
            )

    def test_acc_files_roundtrip(self, tmp_path):
        comp_set = small_set(nmix=1, seed=2)
        utts = corpus(comp_set, n=6)
        t = Trainer(comp_set)
        # split corpus into 3 shards, dump, reload, sum (HERest -p N / -p 0)
        shards = [utts[0:2], utts[2:4], utts[4:6]]
        paths = []
        for i, sh in enumerate(shards):
            accs = t.accumulate(sh)
            p = str(tmp_path / f"HER{i + 1}.acc")
            dump_accs(accs, p)
            paths.append(p)
        combined = sum_accs([load_accs(p) for p in paths])
        whole = t.accumulate(utts)
        for f in whole._fields:
            np.testing.assert_allclose(
                np.asarray(getattr(whole, f)),
                np.asarray(getattr(combined, f)),
                rtol=5e-5,
                atol=5e-5,
                err_msg=f,
            )
