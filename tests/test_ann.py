"""ANN stack tests: forward/splice, training convergence, file round-trip."""

import numpy as np
import pytest

from htk_jax.algo.nnet import SGDConfig, hybrid_outp, make_cache, train_ann
from htk_jax.models.ann import (ANNDef, Layer, ann_params, forward, init_ann,
                                load_ann, save_ann, splice)


class TestForward:
    def test_splice(self):
        import jax.numpy as jnp

        x = jnp.arange(12.0).reshape(4, 3)
        s = splice(x, 1)
        assert s.shape == (4, 9)
        # first frame: left context clamps to frame 0
        np.testing.assert_allclose(np.asarray(s[0]), [0, 1, 2, 0, 1, 2, 3, 4, 5])

    def test_forward_shapes(self):
        ann = init_ann("t", in_dim=6, hidden=[16], out_dim=5, context=2)
        x = np.random.default_rng(0).normal(size=(10, 6)).astype(np.float32)
        out = hybrid_outp(ann, x, prior_scale=0.0)
        assert out.shape == (10, 5)
        # log posteriors normalise
        np.testing.assert_allclose(np.exp(np.asarray(out)).sum(1), 1.0, rtol=1e-4)


class TestTraining:
    def test_learns_separable_targets(self):
        rng = np.random.default_rng(1)
        # 3 classes at distinct centroids
        feats, targets = [], []
        for k in range(3):
            f = (rng.normal(size=(100, 4)) + 6 * k).astype(np.float32)
            feats.append(f)
            targets.append(np.full(100, k, np.int32))
        ann = init_ann("t", in_dim=4, hidden=[16], out_dim=3, context=0,
                       activation="RELU", seed=0)
        x, y = make_cache(feats, targets, context=0)
        cfg = SGDConfig(lr=0.05, n_epochs=25, batch_size=32, seed=0,
                        scheduler="FIXED")
        train_ann(ann, x, y, cfg)
        out = np.asarray(hybrid_outp(ann, np.concatenate(feats), prior_scale=0.0))
        acc = (out.argmax(1) == y).mean()
        # mechanics check: training moves from chance (~0.33) to high acc
        # (end-to-end learning quality is covered by the hybrid pipeline)
        assert acc > 0.9
        assert ann.target_priors is not None
        np.testing.assert_allclose(ann.target_priors.sum(), 1.0, rtol=1e-5)

    def test_file_roundtrip(self, tmp_path):
        ann = init_ann("net", in_dim=5, hidden=[8, 8], out_dim=4, context=1)
        ann.target_priors = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
        ann.target_names = ["a", "b", "c", "d"]
        p = str(tmp_path / "ann")
        save_ann(ann, p)
        a2 = load_ann(p)
        assert a2.context == 1
        assert len(a2.layers) == 3
        assert a2.layers[-1].activation == "SOFTMAX"
        np.testing.assert_allclose(a2.layers[0].weight, ann.layers[0].weight,
                                   rtol=1e-5)
        np.testing.assert_allclose(a2.target_priors, ann.target_priors,
                                   rtol=1e-5)
        assert a2.target_names == ["a", "b", "c", "d"]
        # outputs identical after round-trip
        x = np.random.default_rng(2).normal(size=(6, 5)).astype(np.float32)
        o1 = np.asarray(hybrid_outp(ann, x))
        o2 = np.asarray(hybrid_outp(a2, x))
        np.testing.assert_allclose(o1, o2, atol=1e-5)


class TestSchedulers:
    def _data(self):
        rng = np.random.default_rng(1)
        feats, targets = [], []
        for k in range(3):
            f = (rng.normal(size=(100, 4)) + 6 * k).astype(np.float32)
            feats.append(f)
            targets.append(np.full(100, k, np.int32))
        return make_cache(feats, targets, context=0), np.concatenate(feats)

    def test_adagrad_learns(self):
        (x, y), allf = self._data()
        ann = init_ann("t", in_dim=4, hidden=[16], out_dim=3, context=0,
                       activation="RELU", seed=0)
        cfg = SGDConfig(lr=0.1, n_epochs=40, batch_size=32, seed=0,
                        scheduler="ADAGRAD")
        train_ann(ann, x, y, cfg)
        out = np.asarray(hybrid_outp(ann, allf, prior_scale=0.0))
        assert (out.argmax(1) == y).mean() > 0.9

    def test_list_schedule_learns(self):
        (x, y), allf = self._data()
        ann = init_ann("t", in_dim=4, hidden=[16], out_dim=3, context=0,
                       activation="RELU", seed=0)
        cfg = SGDConfig(lr=0.0, n_epochs=20, batch_size=32, seed=0,
                        scheduler="LIST",
                        lr_list=[0.1] * 5 + [0.05] * 5 + [0.02] * 5
                                + [0.01] * 5)
        train_ann(ann, x, y, cfg)
        out = np.asarray(hybrid_outp(ann, allf, prior_scale=0.0))
        assert (out.argmax(1) == y).mean() > 0.9

    def test_weight_decay_shrinks_weights(self):
        """WEIGHTDECAY pulls the solution toward smaller weights while
        still learning the (easily separable) classes."""
        (x, y), allf = self._data()

        def norms(wd):
            ann = init_ann("t", in_dim=4, hidden=[16], out_dim=3,
                           context=0, activation="RELU", seed=0)
            cfg = SGDConfig(lr=0.05, n_epochs=25, batch_size=32, seed=0,
                            scheduler="FIXED", weight_decay=wd)
            train_ann(ann, x, y, cfg)
            out = np.asarray(hybrid_outp(ann, allf, prior_scale=0.0))
            acc = (out.argmax(1) == y).mean()
            return sum(float(np.square(l.weight).sum())
                       for l in ann.layers), acc

        n0, acc0 = norms(0.0)
        n1, acc1 = norms(1e-2)
        assert acc0 > 0.9 and acc1 >= 0.85
        assert n1 < 0.8 * n0, (n0, n1)

    def test_grad_clip_bounds_first_update(self):
        """With GRADCLIP = c, no parameter may move farther than lr*c
        in the first (zero-velocity) step."""
        from htk_jax.algo.nnet import _sgd_step, ann_params
        import jax, jax.numpy as jnp

        (x, y), _allf = self._data()
        ann = init_ann("t", in_dim=4, hidden=[16], out_dim=3, context=0,
                       activation="RELU", seed=0)
        params = ann_params(ann)
        vel = jax.tree.map(jnp.zeros_like, params)
        acts = tuple(l.activation for l in ann.layers)
        clip, lr = 0.01, 0.1
        new_p, _v, _ce, _acc = _sgd_step(
            params, vel, jnp.asarray(x[:64]), jnp.asarray(y[:64]),
            acts, lr, 0.0, wd=0.0, clip=clip)
        for (w0, b0), (w1, b1) in zip(params, new_p):
            assert float(jnp.abs(w1 - w0).max()) <= lr * clip + 1e-7
            assert float(jnp.abs(b1 - b0).max()) <= lr * clip + 1e-7


class TestSequenceMMI:
    def test_mmi_objective_rises(self):
        """Sequence training: the MMI objective (num - den logP) must
        increase over iterations (the EM-style monotonicity check)."""
        from htk_jax.algo.nnet import train_ann_sequence
        from test_decode import emit_frames, separable_set
        from htk_jax.algo.viterbi import align
        from htk_jax.algo.composite import build_composite

        comp = separable_set()
        rng = np.random.default_rng(3)
        seqs = [["sil", "aa", "iy", "sil"], ["sil", "iy", "aa", "iy", "sil"],
                ["sil", "aa", "aa", "sil"], ["sil", "iy", "sil"]]
        # noisier frames so the CE net is imperfect and MMI has headroom
        utt_feats = [emit_frames(s, seed=i + 10, dim=3) +
                     rng.normal(size=(8 * len(s), 3)).astype(np.float32)
                     for i, s in enumerate(seqs)]

        # frame-CE pretraining on forced-alignment targets
        targets = []
        for f, names in zip(utt_feats, seqs):
            hmm = build_composite(comp, [comp.model_id(n) for n in names])
            res = align(comp, hmm, f)
            targets.append(hmm.comp_state[res.states].astype(np.int32))
        ann = init_ann("t", in_dim=3, hidden=[16], out_dim=comp.n_states,
                       context=1, activation="RELU", seed=0)
        x, y = make_cache(utt_feats, targets, context=1)
        train_ann(ann, x, y, SGDConfig(lr=0.05, n_epochs=5, batch_size=32,
                                       scheduler="FIXED", seed=0))

        cfg = SGDConfig(lr=0.005, momentum=0.5, batch_size=32, seed=0)
        _ann, objs = train_ann_sequence(ann, comp, utt_feats, seqs, cfg,
                                        n_iters=4)
        assert objs[-1] > objs[0], f"MMI objective fell: {objs}"
