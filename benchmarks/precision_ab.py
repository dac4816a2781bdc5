"""A/B the HTKTPU:PRECISION modes on the OutP-dominated hot paths.

Interleaved reps in ONE process (never compare across runs). Two
workloads:

  - trainer: DeviceCompositeTrainer.accumulate, the HERest inner loop
    (OutP matmul + FB scan; OutP is the matmul part).
  - outp: the bare all_state_outp batch, isolating the matmul.

For each mode also reports the max |delta| vs highest on the per-frame
log-likelihoods, so the accuracy cost is recorded next to the
speedup.

Usage: python benchmarks/precision_ab.py   (SMOKE=1 for a tiny run)
"""

import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

SMOKE = os.environ.get("SMOKE") == "1"
MODES = ("highest", "high", "default")


def make_set(n_models=64, n_states=5, n_mix=8, dim=39, seed=0):
    from htk_jax.models.proto import clone_proto, make_proto
    from htk_jax.models.hmmset import compile_hmmset

    rng = np.random.default_rng(seed)
    hs = make_proto(nstates=n_states, dim=dim, parm_kind="MFCC_E_D_A",
                    nmix=n_mix)
    names = [f"m{i}" for i in range(n_models)]
    cl = clone_proto(hs, "proto", names)
    for h in cl.hmms.values():
        for si in h.states:
            for mp in si.streams[0].mixes:
                mp.mean = rng.normal(size=dim).astype(np.float32) * 2
                mp.var = (0.5 + rng.random(dim)).astype(np.float32)
                mp.fix_gconst()
    return compile_hmmset(cl), names


def bench_trainer(comp, names, mode, utts, reps):
    from htk_jax.algo.trainer import DeviceCompositeTrainer

    tr = DeviceCompositeTrainer(comp, precision=mode)
    accs = tr.accumulate(utts, batch_size=8)  # warm + compile
    jax.block_until_ready(accs.occ)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        accs = tr.accumulate(utts, batch_size=8)
        jax.block_until_ready(accs.occ)
        ts.append(time.perf_counter() - t0)
    return ts, np.asarray(accs.occ)


def bench_outp(comp, mode, feats, reps):
    from htk_jax.ops.outp import all_state_outp

    means = jnp.asarray(comp.means)
    variances = jnp.asarray(comp.variances)
    gconsts = jnp.asarray(comp.gconsts)
    state_mix = jnp.asarray(comp.state_mix)
    state_logw = jnp.asarray(comp.state_logw)

    @jax.jit
    def run(fb):
        def one(x):
            logb, _ = all_state_outp(x, means, variances, gconsts,
                                     state_mix, state_logw, precision=mode)
            return logb

        return jax.vmap(one)(fb)

    out = run(feats)
    jax.block_until_ready(out)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = run(feats)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return ts, np.asarray(out)


def main():
    n_utts = 4 if SMOKE else 16
    T = 100 if SMOKE else 500
    reps = 2 if SMOKE else 6
    dim = 39
    comp, names = make_set()

    from htk_jax.algo.trainer import prepare_utterance_ids

    rng = np.random.default_rng(3)
    utts = []
    for i in range(n_utts):
        seq = [names[j] for j in rng.integers(0, len(names), 40)]
        f = rng.normal(size=(T, dim)).astype(np.float32)
        utts.append(prepare_utterance_ids(comp, f"u{i}", f, seq))
    feats = jnp.asarray(rng.normal(size=(8, T, dim)).astype(np.float32))

    print(f"backend={jax.default_backend()} n_utts={n_utts} T={T} "
          f"reps={reps} (interleaved)")
    for label, fn, arg in (("trainer", bench_trainer, utts),
                           ("outp", bench_outp, feats)):
        # interleave: one rep of each mode per round
        times = {m: [] for m in MODES}
        outs = {}
        for r in range(reps):
            for m in MODES:
                ts, out = (fn(comp, names, m, arg, 1) if label == "trainer"
                           else fn(comp, m, arg, 1))
                times[m].extend(ts)
                outs[m] = out
        ref = outs["highest"].astype(np.float64)
        base = statistics.median(times["highest"])
        for m in MODES:
            d = float(np.max(np.abs(outs[m].astype(np.float64) - ref)))
            rel = float(np.max(np.abs(outs[m].astype(np.float64) - ref)
                               / (np.abs(ref) + 1e-9)))
            med = statistics.median(times[m])
            print(f"  {label:8s} {m:8s} {med * 1e3:8.2f} ms  "
                  f"speedup x{base / med:5.2f}  max|dlogP|={d:.3e} "
                  f"rel={rel:.2e}")


if __name__ == "__main__":
    main()
