"""Device composite assembly must match the host builder exactly."""

import jax.numpy as jnp
import numpy as np
import pytest

from htk_jax.algo.composite import build_composite
from htk_jax.algo.composite_device import make_assembler
from htk_jax.models.hmmset import compile_hmmset
from htk_jax.models.proto import clone_proto, make_proto
from htk_jax.utils.logmath import LZERO

from test_fb import small_set


def tee_set(seed=4):
    """Set with a tee 'sp' model (entry->exit prob) plus two normal ones."""
    hs = make_proto(nstates=5, dim=3, parm_kind="USER")
    cl = clone_proto(hs, "proto", ["a", "b", "sp"])
    rng = np.random.default_rng(seed)
    for h in cl.hmms.values():
        for si in h.states:
            mp = si.streams[0].mixes[0]
            mp.mean = rng.normal(size=3).astype(np.float32)
            mp.var = (0.5 + rng.random(3)).astype(np.float32)
            mp.fix_gconst()
    sp = cl.hmms["sp"]
    sp.nstates = 3
    sp.states = sp.states[:1]
    tp = np.zeros((3, 3), np.float32)
    tp[0, 1] = 0.6
    tp[0, 2] = 0.4
    tp[1, 1] = 0.5
    tp[1, 2] = 0.5
    sp.transp = tp
    return compile_hmmset(cl)


def compare(comp, seq_names, Kpad):
    ids = [comp.model_id(n) for n in seq_names]
    host = build_composite(comp, ids)
    asm = make_assembler(comp)
    ids_pad = np.full((1, Kpad), -1, np.int32)
    ids_pad[0, : len(ids)] = ids
    dev = {k: np.asarray(v[0]) for k, v in asm(jnp.asarray(ids_pad)).items()}

    emax = comp.nmax - 2
    Q = host.n_states
    # map host composite states (packed) to device slots (block layout)
    slot = []
    q = 0
    for k, mid in enumerate(ids):
        e = int(comp.model_nstates[mid]) - 2
        for i in range(e):
            slot.append(k * emax + i)
    slot = np.asarray(slot)
    assert len(slot) == Q

    np.testing.assert_array_equal(dev["comp_state"][slot], host.comp_state)
    # all other device slots are dead
    dead = np.setdiff1d(np.arange(Kpad * emax), slot)
    assert not dev["q_mask"][dead].any()
    assert dev["q_mask"][slot].all()

    np.testing.assert_allclose(
        dev["logA"][np.ix_(slot, slot)], host.logA, atol=2e-4
    )
    np.testing.assert_allclose(dev["a0"][slot], host.a0, atol=2e-4)
    np.testing.assert_allclose(dev["aE"][slot], host.aE, atol=2e-4)
    np.testing.assert_array_equal(
        dev["tr_seg"][np.ix_(slot, slot)], host.tr_seg
    )
    np.testing.assert_array_equal(dev["entry_seg"][slot], host.entry_seg)
    np.testing.assert_array_equal(dev["exit_seg"][slot], host.exit_seg)
    # dead rows never accumulate
    assert (dev["entry_seg"][dead] == -1).all()


class TestDeviceComposite:
    def test_uniform_topology(self):
        comp = small_set(nmix=2, seed=1)
        compare(comp, ["a", "b", "a", "b", "b"], Kpad=8)

    def test_with_tee(self):
        comp = tee_set()
        compare(comp, ["a", "sp", "b"], Kpad=6)
        compare(comp, ["a", "sp", "sp", "b"], Kpad=6)
        compare(comp, ["sp", "a", "b", "sp"], Kpad=6)

    def test_single_model(self):
        comp = small_set(nmix=1, seed=2)
        compare(comp, ["a"], Kpad=4)


class TestDeviceCompositeTrainer:
    def test_matches_host_trainer(self):
        from htk_jax.algo.trainer import (DeviceCompositeTrainer, Trainer,
                                          prepare_utterance,
                                          prepare_utterance_ids)

        comp = small_set(nmix=2, seed=3)
        rng = np.random.default_rng(7)
        host_utts, dev_utts = [], []
        for i in range(5):
            T = int(rng.integers(12, 40))
            feats = rng.normal(size=(T, 3)).astype(np.float32)
            seq = [["a", "b"], ["b", "a", "b"]][i % 2]
            host_utts.append(prepare_utterance(comp, f"u{i}", feats, seq))
            dev_utts.append(prepare_utterance_ids(comp, f"u{i}", feats, seq))
        a1 = Trainer(comp).accumulate(host_utts, batch_size=4)
        a2 = DeviceCompositeTrainer(comp).accumulate(dev_utts, batch_size=4)
        for f in a1._fields:
            np.testing.assert_allclose(
                np.asarray(getattr(a1, f)), np.asarray(getattr(a2, f)),
                rtol=5e-4, atol=5e-4, err_msg=f,
            )
