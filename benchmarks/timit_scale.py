"""TIMIT-scale HERest iteration wall-clock (one chip).

Synthesises a 3,696-utterance TIMIT-sized corpus and times one full
embedded-reestimation pass; the n-card figure divides by n (accumulator
psum is the only cross-card op, so scaling is linear until transfer
binds). Run on the accelerator backend: python benchmarks/timit_scale.py
"""
import time, numpy as np, jax
import os, sys; sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench import build_model
from htk_jax.algo.trainer import DeviceCompositeTrainer, Trainer, prepare_utterance, prepare_utterance_ids
from htk_jax.algo.reestimate import reestimate, UpdateFlags
from htk_jax.models.hmmset import write_back

comp, names = build_model(n_phones=48, nstates=5, dim=39, nmix=1)
rng = np.random.default_rng(0)
N = 3696
t0 = time.perf_counter()
utts = []
for i in range(N):
    T = int(rng.integers(200, 400))     # 2-4 s
    n_ph = int(rng.integers(30, 50))
    seq = [names[j] for j in rng.integers(0, len(names), n_ph)]
    feats = rng.normal(size=(T, 39)).astype(np.float32)
    utts.append(prepare_utterance_ids(comp, f"u{i}", feats, seq))
t_prep = time.perf_counter() - t0
print(f"prep {N} utts: {t_prep:.1f}s", flush=True)

# device-side composite assembly (HERest DEVICECOMPOSITE): logA/segment
# maps built on-chip from model-id sequences — the fastest trainer path
tr = DeviceCompositeTrainer(comp, precision="default")
t0 = time.perf_counter()
accs = tr.accumulate(utts[:32], batch_size=16)  # warm compile
print(f"warmup: {time.perf_counter()-t0:.1f}s", flush=True)

t0 = time.perf_counter()
accs = tr.accumulate(utts, batch_size=16)
jax.block_until_ready(accs.occ)
t_acc = time.perf_counter() - t0
print(f"accumulate {N} utts: {t_acc:.1f}s -> {N/t_acc:.0f} utt/s/chip", flush=True)
t0 = time.perf_counter()
m, v, w, t = reestimate(comp, accs, UpdateFlags())
write_back(comp, means=m, variances=v, weights=w, transps=t)
print(f"update: {time.perf_counter()-t0:.1f}s", flush=True)
print(f"TOTAL single-chip iteration (excl. one-off prep): {t_acc:.1f}s")
print(f"4-card estimate: {t_acc/4:.1f}s/iteration x the sharding overhead "
      "factor MEASURED by benchmarks/mesh_scaling.py (serial vs "
      "shard_map+psum at equal work; the cross-chip op is one "
      "accumulator psum per batch)")
