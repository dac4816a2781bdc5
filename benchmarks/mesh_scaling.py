"""Measured data-parallel scaling on a virtual device mesh.

This harness MEASURES the sharded training program: the
same corpus is accumulated serially (Trainer) and through
ShardedTrainer's shard_map+psum program over 1/2/4/8-device meshes, on
identical work, and the wall-clocks and accumulator equality are
reported.

Caveat printed with the numbers: without multi-chip hardware the mesh
is XLA's virtual CPU host mesh (one machine's cores time-share the
devices), so wall-clock speedup here is bounded by host parallelism —
the number that generalises to real chips is the psum/sharding
OVERHEAD (t_sharded / t_serial at equal work; on real chips each shard
also gets 1/n of the work). The cross-chip op is a single accumulator
psum per batch (~MBs).

Run: python benchmarks/mesh_scaling.py   (self-forces an 8-CPU mesh)
"""
import os
import sys
import time

if os.environ.get("_HTKTPU_MESH_CHILD") != "1":
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if not f.startswith("--xla_force_host_platform_device_count")]
    flags.append("--xla_force_host_platform_device_count=8")
    env["XLA_FLAGS"] = " ".join(flags)
    env["_HTKTPU_MESH_CHILD"] = "1"
    os.execve(sys.executable, [sys.executable] + sys.argv, env)

import numpy as np  # noqa: E402
import jax  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from bench import build_model  # noqa: E402
from htk_jax.algo.trainer import Trainer, prepare_utterance  # noqa: E402
from htk_jax.parallel.mesh import ShardedTrainer, make_mesh  # noqa: E402

N = int(os.environ.get("MESH_SCALE_N", "128"))
GLOBAL_BATCH = 32

comp, names = build_model(n_phones=48, nstates=5, dim=39, nmix=1)
rng = np.random.default_rng(0)
utts = []
for i in range(N):
    T = int(rng.integers(200, 400))
    n_ph = int(rng.integers(30, 50))
    seq = [names[j] for j in rng.integers(0, len(names), n_ph)]
    feats = rng.normal(size=(T, 39)).astype(np.float32)
    utts.append(prepare_utterance(comp, f"u{i}", feats, seq))
print(f"devices: {jax.devices()}", flush=True)

results = {}
ref_occ = None
for n_dev in (1, 2, 4, 8):
    if n_dev == 1:
        tr = Trainer(comp, precision="default")
        bs = GLOBAL_BATCH
    else:
        tr = ShardedTrainer(comp, make_mesh(n_dev), precision="default")
        bs = GLOBAL_BATCH // n_dev
    accs = tr.accumulate(utts[:GLOBAL_BATCH], batch_size=bs)  # warm compile
    jax.block_until_ready(accs.occ)
    t0 = time.perf_counter()
    accs = tr.accumulate(utts, batch_size=bs)
    jax.block_until_ready(accs.occ)
    dt = time.perf_counter() - t0
    occ = np.asarray(accs.occ)
    if ref_occ is None:
        ref_occ = occ
    else:
        err = float(np.max(np.abs(occ - ref_occ) / (np.abs(ref_occ) + 1e-6)))
        assert err < 1e-4, f"sharded accumulators diverge: {err}"
    results[n_dev] = dt
    print(f"{n_dev}-device mesh: {dt:.2f}s for {N} utts "
          f"({N/dt:.1f} utt/s global){' [serial Trainer]' if n_dev == 1 else ''}",
          flush=True)

t1 = results[1]
print("\nsharding overhead at equal work (virtual CPU mesh; all devices "
      "share one host's cores):")
for n_dev in (2, 4, 8):
    print(f"  {n_dev}-way: t_sharded/t_serial = {results[n_dev]/t1:.3f} "
          f"(1.0 = free sharding; accumulators equal to serial, asserted)")
print("\nOn real chips each shard also receives 1/n of the corpus; the "
      "only cross-chip op is one accumulator psum per batch.")
