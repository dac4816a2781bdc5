"""Frontend decomposition probe (BASELINE config #1, VERDICT r3 item 5).

Splits the batched MFCC frontend's wall-clock into its three legs to
decide whether a fused kernel could help:

  host    — dither + framing-buffer assembly (numpy, per 64-utt chunk)
  xfer    — host->device transfer of the padded sample buffer
  device  — the jitted frame->MFCC_E_D_A program on device-resident input

A fused kernel can only attack `device`; if `xfer`+`host` dominate, the
keep/drop decision is drop-with-rationale. Reference role: HTKLib/HParm.c hot loop (SURVEY
§3.1), HCopy extraction (BASELINE config #1).

Usage: python benchmarks/frontend_probe.py [n_utts secs reps]
"""

import statistics
import sys
import time

import numpy as np


def main(n_utts=64, secs=5.0, reps=5):
    import jax
    import jax.numpy as jnp

    from htk_jax.ops.dsp import (FrontendConfig, _bucket_len, _dithered,
                                 _extract_padded_batch, num_frames)

    cfg = FrontendConfig()
    rng = np.random.default_rng(9)
    n_samp = int(secs * 16000)
    waves = [(rng.normal(size=n_samp) * 2000).astype(np.float32)
             for _ in range(n_utts)]
    audio_s = n_utts * secs

    def host_leg():
        items = []
        for s in waves:
            d = _dithered(s, cfg)
            items.append((d, num_frames(len(d), cfg)))
        Tp = _bucket_len(items[0][1])
        need = (Tp - 1) * cfg.frame_shift + cfg.frame_size
        bufs, tss = [], []
        for i0 in range(0, len(items), 64):
            chunk = items[i0:i0 + 64]
            buf = np.zeros((64, need), np.float32)
            ts = np.ones(64, np.int32)
            for b, (s, T) in enumerate(chunk):
                n_copy = min(len(s), need)
                buf[b, :n_copy] = s[:n_copy]
                ts[b] = T
            bufs.append(buf)
            tss.append(ts)
        return bufs, tss, Tp

    fn = jax.jit(lambda b, t, Tp=None: None)  # placeholder, replaced below

    t_host, t_xfer, t_dev, t_back = [], [], [], []
    # warm-up: compile + first transfer
    bufs, tss, Tp = host_leg()
    extract = jax.jit(
        lambda b, t: _extract_padded_batch(b, t, cfg, Tp))
    dev_bufs = [jax.device_put(b) for b in bufs]
    dev_tss = [jax.device_put(t) for t in tss]
    outs = [extract(b, t) for b, t in zip(dev_bufs, dev_tss)]
    jax.block_until_ready(outs)

    for _ in range(reps):
        t0 = time.perf_counter()
        bufs, tss, Tp = host_leg()
        t1 = time.perf_counter()
        dev_bufs = [jax.device_put(b) for b in bufs]
        dev_tss = [jax.device_put(t) for t in tss]
        jax.block_until_ready(dev_bufs)
        t2 = time.perf_counter()
        outs = [extract(b, t) for b, t in zip(dev_bufs, dev_tss)]
        jax.block_until_ready(outs)
        t3 = time.perf_counter()
        host_out = [np.asarray(o) for o in outs]
        t4 = time.perf_counter()
        t_host.append(t1 - t0)
        t_xfer.append(t2 - t1)
        t_dev.append(t3 - t2)
        t_back.append(t4 - t3)

    med = lambda xs: statistics.median(xs)
    total = med(t_host) + med(t_xfer) + med(t_dev) + med(t_back)
    n_frames = sum(int(t) for ts in tss for t in ts if t > 1)
    print(f"backend={jax.default_backend()} utts={n_utts} secs={secs} "
          f"frames~{n_frames}")
    print(f"host   {med(t_host)*1e3:8.1f} ms  ({med(t_host)/total:5.1%})")
    print(f"xfer   {med(t_xfer)*1e3:8.1f} ms  ({med(t_xfer)/total:5.1%})")
    print(f"device {med(t_dev)*1e3:8.1f} ms  ({med(t_dev)/total:5.1%})")
    print(f"d2h    {med(t_back)*1e3:8.1f} ms  ({med(t_back)/total:5.1%})")
    print(f"total  {total*1e3:8.1f} ms -> xRT {total/audio_s:.6f}; "
          f"device-only xRT {med(t_dev)/audio_s:.6f}; "
          f"device kframes/s {n_frames/med(t_dev)/1e3:.1f}")


if __name__ == "__main__":
    a = [float(x) for x in sys.argv[1:]]
    main(*([int(a[0])] if a else []),
         *([a[1]] if len(a) > 1 else []),
         *([int(a[2])] if len(a) > 2 else []))
