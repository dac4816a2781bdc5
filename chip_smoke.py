#!/usr/bin/env python3
"""One run of the HTK pipeline on one GPU, checked against the CPU.

Each phase drives a tool through its own `run(argv)` on files generated
from --seed into a temporary directory, at the widths of configs #4/#5:
39-dim MFCC_E_D_A, 8-mixture Gaussians, 2,000 tied states, 1k and 5k
vocabularies, 5 s utterances.

  HCopy     16 synthesized waveforms -> MFCC_E_D_A (batched frontend)
  HERest    two iterations, 16 utterances, 40 monophones
  HVite -w  batched decode of 16 utterances on a 1k-word-loop SLF
  HDecode   5k vocabulary, trigram LM, trigram guidance, -u, -z lattices
  HMMIRest  one MMI iteration on those lattices
  HResults  scores the HVite and HDecode outputs

Every phase is run again, in this process, on jax.devices("cpu")[0] (the
plain reference) over a subset of the utterances, and compared within
the tolerance written beside it. The OutP error of each matmul precision
against a float64 numpy reference is printed too.

  python chip_smoke.py               # one GPU
  python chip_smoke.py --four-cards  # HERest data-parallel: 4 GPUs vs 1

The last line of stdout is one JSON object {"ok": true, "device": ...};
a run that finds no GPU, or whose phase fails or leaves its tolerance,
exits non-zero without it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np

# the CPU reference runs in this process, so the CPU backend must load
# beside the GPU one
if os.environ.get("JAX_PLATFORMS") and "cpu" not in os.environ[
        "JAX_PLATFORMS"].split(","):
    os.environ["JAX_PLATFORMS"] += ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bench import (build_monophone_set, build_tied_triphone_set,  # noqa: E402
                   synth_corpus)
from htk_jax.io import parmkind as pk  # noqa: E402
from htk_jax.io.dictionary import Vocab, write_dict  # noqa: E402
from htk_jax.io.htkfeat import read_htk_file, write_htk_file  # noqa: E402
from htk_jax.io.lm import write_arpa  # noqa: E402
from htk_jax.io.mlf import MLF  # noqa: E402
from htk_jax.io.mmf import load_mmf, save_mmf  # noqa: E402
from htk_jax.io.slf import write_slf  # noqa: E402
from htk_jax.io.wavefile import Waveform, write_wave  # noqa: E402
from htk_jax.models.hmmset import compile_hmmset  # noqa: E402
from htk_jax.ops.outp import all_state_outp  # noqa: E402
from htk_jax.tools import (hcopy, hdecode, herest, hmmirest,  # noqa: E402
                           hresults, hvite)
from htk_jax.tools.hbuild import word_loop_lattice  # noqa: E402
from htk_jax.utils.compile_cache import enable_compile_cache  # noqa: E402

FRAME = 100_000  # 10 ms in HTK's 100 ns units

# Tolerances against the CPU run, each with its reason.
# HCopy: per coefficient, relative to its largest magnitude in the
# utterance. The float32 FFTs of the two backends round differently; the
# float32 frontend alone is up to 1.7e-4 (absolute) from a float64 one
# on cepstra of magnitude ~30, so an absolute bound of 1e-4 would fail
# on rounding alone.
TOL_HCOPY = 1e-4
# HERest: logP per frame, relative: f32 sums in another order (GPU
# scatter-add).
TOL_HEREST = 1e-4
# HERest parameters and accumulators, relative to each one's largest
# magnitude. The forward-backward runs in float32 log space: at 500
# frames alpha reaches ~3e4, whose ulp is ~2e-3, so every posterior
# carries ~0.2% rounding that changes chaotically with the order of any
# sum. On the CPU alone, moving the input features by about one ulp
# moved the re-estimated parameters by up to 2.1e-3. The bound is the
# larger of this and twice the sensitivity measured in the same run.
TOL_HEREST_PARAMS = 5e-3
TOL_DECODE = 1e-4  # relative, scores; words and times must be identical
TOL_MMI = 1e-3     # relative: the objective sums lattice FBs of many arcs


@dataclass(frozen=True)
class Widths:
    n_utts: int = 16       # utterances per phase on the device
    n_ref: int = 2         # of those, compared with the CPU run
    secs: float = 5.0      # utterance length
    n_phones: int = 40
    nmix: int = 8
    n_tied: int = 2000
    vocab_hvite: int = 1000
    vocab_hdecode: int = 5000


FULL = Widths()
# tiny widths for the CPU tests of the phase functions
TINY = Widths(n_utts=3, n_ref=2, secs=0.6, n_phones=6, nmix=2, n_tied=24,
              vocab_hvite=12, vocab_hdecode=16)


@dataclass
class Ctx:
    work: str
    w: Widths
    seed: int
    dev: object   # the device under test
    ref: object   # the plain reference (the CPU)


class PhaseFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise PhaseFailure(msg)


# ---------------------------------------------------------------------------
# timing: compile seconds from XLA's own compile events; tracing and
# lowering count as run time


class _CompileClock:
    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_kw):
        if event == self.EVENT:
            self.total += duration


_CLOCK = None


@contextlib.contextmanager
def timed(out: dict):
    """Fill out["compile_s"] / out["run_s"] for the enclosed block."""
    global _CLOCK
    if _CLOCK is None:
        _CLOCK = _CompileClock()
    c0, t0 = _CLOCK.total, time.perf_counter()
    yield
    wall = time.perf_counter() - t0
    out["compile_s"] = out.get("compile_s", 0.0) + (_CLOCK.total - c0)
    out["run_s"] = out.get("run_s", 0.0) + wall - (_CLOCK.total - c0)


def run_tool(mod, argv, device, out=None):
    """mod.run(argv) with `device` as JAX's default device; returns the
    tool's stdout. A non-zero return or an HTK error raises."""
    buf = io.StringIO()
    clock = contextlib.nullcontext() if out is None else timed(out)
    with jax.default_device(device), contextlib.redirect_stdout(buf), clock:
        rc = mod.run(argv)
    check(rc in (0, None), f"{mod.__name__} returned {rc}")
    return buf.getvalue()


def rel_dev(a, b):
    """Largest |a - b| relative to the largest |b|."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _last_float(text, key):
    """The number after the last `key` in text."""
    i = text.rindex(key) + len(key)
    return float(text[i:].split()[0])


def _write_lines(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _write_mlf(path, transcripts, ext="lab"):
    lines = ["#!MLF!#"]
    for stem, labels in transcripts:
        lines.append(f'"*/{stem}.{ext}"')
        lines += labels
        lines.append(".")
    _write_lines(path, lines)


def _write_feats(d, stems, feats):
    os.makedirs(d, exist_ok=True)
    paths = []
    for stem, x in zip(stems, feats):
        p = os.path.join(d, stem + ".mfc")
        write_htk_file(p, x, FRAME, pk.str2parmkind("MFCC_E_D_A"))
        paths.append(p)
    return paths


def _save_set(hset, d, names):
    os.makedirs(d, exist_ok=True)
    save_mmf(hset, os.path.join(d, "hmmdefs"), binary=True)
    _write_lines(os.path.join(d, "hmmlist"), sorted(names))


def _set_params(mmf):
    c = compile_hmmset(load_mmf([mmf]))
    return {"means": c.means, "variances": c.variances,
            "logw": np.where(c.state_mix >= 0, c.state_logw, 0.0)}


def _mlf_entries(path):
    m = MLF.load(path)
    return {os.path.splitext(os.path.basename(k))[0]: tr.labels
            for k, tr in m.entries}


def _compare_recs(dev_mlf, ref_mlf, stems):
    """Word strings and times identical; scores within TOL_DECODE."""
    d, r = _mlf_entries(dev_mlf), _mlf_entries(ref_mlf)
    worst = 0.0
    for s in stems:
        check(s in d and s in r, f"{s}: missing from a recognition MLF")
        dw = [(l.name, l.start, l.end) for l in d[s]]
        rw = [(l.name, l.start, l.end) for l in r[s]]
        check(dw == rw, f"{s}: device {dw} != CPU {rw}")
        for a, b in zip(d[s], r[s]):
            if a.score is not None and b.score is not None:
                worst = max(worst, abs(a.score - b.score)
                            / max(abs(b.score), 1.0))
    check(worst <= TOL_DECODE, f"score deviation {worst:.3g} > {TOL_DECODE}")
    return worst


# ---------------------------------------------------------------------------
# data


def _speechlike(rng, n, fs=16000):
    """Voiced/unvoiced segments: harmonic stacks under a formant-ish
    envelope, noise bursts, and pauses; int16."""
    out = np.zeros(n)
    pos = 0
    while pos < n:
        seg = int(rng.integers(fs // 20, fs // 6))
        t = np.arange(min(seg, n - pos)) / fs
        kind = rng.random()
        if kind < 0.6:
            f0 = rng.uniform(90, 250)
            x = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6))
                    * np.exp(-((f0 * k - rng.uniform(300, 900)) / 700) ** 2)
                    for k in range(1, 30))
        elif kind < 0.85:
            x = rng.normal(size=len(t)) * 0.3
        else:
            x = rng.normal(size=len(t)) * 0.01
        out[pos:pos + len(t)] = x * np.hanning(len(t))
        pos += len(t)
    out = out / (np.max(np.abs(out)) + 1e-9) * 12000
    return out.astype(np.int16)


def make_monophone_data(ctx):
    """40-monophone 8-mix set, features walked from it, phone MLF."""
    w = ctx.w
    d = os.path.join(ctx.work, "mono")
    if os.path.isdir(d):
        return d
    hset, names = build_monophone_set(w.n_phones, 5, 39, w.nmix, ctx.seed)
    _save_set(hset, os.path.join(d, "hmm0"), names)
    comp = compile_hmmset(hset)
    v = Vocab()
    for n in names:
        v.add_pron(n, [n])
    rng = np.random.default_rng(ctx.seed + 1)
    per = max(2, round(w.secs * 100 / 9))  # 3 states x 3 frames a phone
    feats, trans = synth_corpus(comp, v, names, w.n_utts, per, rng,
                                noise=1.0)
    stems = [f"m{i:02d}" for i in range(w.n_utts)]
    paths = _write_feats(os.path.join(d, "feats"), stems, feats)
    _write_lines(os.path.join(d, "train.scp"), paths)
    _write_lines(os.path.join(d, "ref.scp"), paths[:w.n_ref])
    _write_mlf(os.path.join(d, "phones.mlf"), zip(stems, trans))
    return d


def make_tied_data(ctx, n_words, lm_order, tag):
    """Tied-triphone set over an n_words vocabulary, its LM, features
    synthesized from it, and word- and triphone-level MLFs."""
    w = ctx.w
    d = os.path.join(ctx.work, tag)
    if os.path.isdir(d):
        return d
    hset, vocab, words, lm = build_tied_triphone_set(
        n_words, w.n_phones, w.n_tied, w.nmix, 39, ctx.seed + n_words,
        lm_order)
    _save_set(hset, d, hset.hmms)
    write_dict(vocab, os.path.join(d, "dict"))
    write_arpa(lm, os.path.join(d, "lm.arpa"))
    write_slf(word_loop_lattice(words), os.path.join(d, "loop.slf"))
    comp = compile_hmmset(hset)
    rng = np.random.default_rng(ctx.seed + 2 + n_words)
    per = max(2, round(w.secs * 100 / 36))  # ~4 phones x 9 frames a word
    feats, trans = synth_corpus(comp, vocab, words, w.n_utts, per, rng)
    stems = [f"{tag}{i:02d}" for i in range(w.n_utts)]
    paths = _write_feats(os.path.join(d, "feats"), stems, feats)
    _write_lines(os.path.join(d, "test.scp"), paths)
    _write_lines(os.path.join(d, "ref.scp"), paths[:w.n_ref])
    _write_mlf(os.path.join(d, "words.mlf"), zip(stems, trans))
    tri = [[ph for wd in t for ph in vocab.get(wd).prons[0].phones]
           for t in trans]
    _write_mlf(os.path.join(d, "tri.mlf"), zip(stems, tri))
    return d


# ---------------------------------------------------------------------------
# phases


def phase_hcopy(ctx):
    w = ctx.w
    d = os.path.join(ctx.work, "hcopy")
    os.makedirs(os.path.join(d, "wav"), exist_ok=True)
    rng = np.random.default_rng(ctx.seed)
    n = int(w.secs * 16000)
    jobs = {"dev": [], "ref": []}
    for i in range(w.n_utts):
        src = os.path.join(d, "wav", f"w{i:02d}.wav")
        write_wave(src, Waveform(_speechlike(rng, n), 625))
        for side in jobs:
            jobs[side].append((src, os.path.join(d, side, f"w{i:02d}.mfc")))
    cfg = os.path.join(d, "cfg")
    _write_lines(cfg, ["SOURCEKIND = WAVEFORM", "SOURCEFORMAT = HTK",
                       "TARGETKIND = MFCC_E_D_A"])
    out = {"phase": "HCopy"}
    for side, dev, pairs in (("dev", ctx.dev, jobs["dev"]),
                             ("ref", ctx.ref, jobs["ref"][:w.n_ref])):
        os.makedirs(os.path.join(d, side), exist_ok=True)
        scp = os.path.join(d, side + ".scp")
        _write_lines(scp, [f"{a} {b}" for a, b in pairs])
        run_tool(hcopy, ["-C", cfg, "-S", scp], dev,
                 out if side == "dev" else None)
    worst = worst_abs = 0.0
    for (_, a), (_, b) in zip(jobs["dev"], jobs["ref"][:w.n_ref]):
        x, y = read_htk_file(a).data, read_htk_file(b).data
        check(x.shape == y.shape and x.shape[1] == 39,
              f"HCopy shapes {x.shape} vs {y.shape}")
        check(np.all(np.isfinite(x)), "HCopy: non-finite features")
        err = np.abs(x - y).max(axis=0)
        worst_abs = max(worst_abs, float(err.max()))
        worst = max(worst, float(np.max(err / np.maximum(
            np.abs(y).max(axis=0), 1.0))))
    for _, a in jobs["dev"]:
        check(np.all(np.isfinite(read_htk_file(a).data)),
              "HCopy: non-finite features")
    out.update(max_dev=worst, max_abs_dev=worst_abs, tol=TOL_HCOPY)
    check(worst <= TOL_HCOPY, f"HCopy deviation {worst:.3g} > {TOL_HCOPY}")
    return out


def phase_herest(ctx):
    d = make_monophone_data(ctx)
    j = lambda *p: os.path.join(d, *p)  # noqa: E731
    mlf, hl = j("phones.mlf"), j("hmm0", "hmmlist")
    out = {"phase": "HERest"}
    lps = []
    for it in (1, 2):
        txt = run_tool(herest, [
            "-T", "1", "-I", mlf, "-H", j(f"hmm{it - 1}", "hmmdefs"),
            "-M", j(f"hmm{it}"), "-S", j("train.scp"), hl], ctx.dev, out)
        lps.append(_last_float(txt, "per frame = "))
    out["logp_per_frame"] = lps
    check(lps[1] > lps[0], f"HERest: logP/frame did not rise {lps}")
    subs = {}
    for side, dev, scp in (("dev", ctx.dev, "ref.scp"),
                           ("ref", ctx.ref, "ref.scp"),
                           ("ulp", ctx.ref, _ulp_scp(d, "ref.scp"))):
        txt = run_tool(herest, [
            "-T", "1", "-I", mlf, "-H", j("hmm0", "hmmdefs"),
            "-M", j("sub_" + side), "-S", j(scp), hl], dev)
        subs[side] = (_last_float(txt, "per frame = "),
                      _set_params(j("sub_" + side, "hmmdefs")))
    lp_dev = rel_dev(subs["dev"][0], subs["ref"][0])
    out.update(_param_check(subs["dev"][1], subs["ref"][1],
                            subs["ulp"][1]), logp_dev=lp_dev,
               logp_tol=TOL_HEREST)
    check(lp_dev <= TOL_HEREST, f"HERest logP deviation {lp_dev:.3g}")
    return out


def _ulp_scp(d, scp):
    """A copy of scp's feature files with every value moved one ulp up
    or down at random; returns the new script's name."""
    rng = np.random.default_rng(7)
    os.makedirs(os.path.join(d, "ulp"), exist_ok=True)
    paths = []
    for p in open(os.path.join(d, scp)).read().split():
        f = read_htk_file(p)
        x = np.asarray(f.data, np.float32)
        away = np.where(rng.random(x.shape) < 0.5, -np.inf, np.inf)
        x = np.nextafter(x, away.astype(np.float32))
        q = os.path.join(d, "ulp", os.path.basename(p))
        write_htk_file(q, x, f.samp_period, f.parm_kind)
        paths.append(q)
    _write_lines(os.path.join(d, "ulp.scp"), paths)
    return "ulp.scp"


def _param_check(dev, ref, ulp):
    """Largest parameter deviation of dev from ref, held to
    TOL_HEREST_PARAMS or twice the ref's own one-ulp sensitivity (ulp
    vs ref)."""
    worst = max(rel_dev(dev[k], ref[k]) for k in ref)
    sens = max(rel_dev(ulp[k], ref[k]) for k in ref)
    tol = max(TOL_HEREST_PARAMS, 2 * sens)
    check(worst <= tol, f"HERest parameter deviation {worst:.3g} > "
          f"{tol:.3g} (one-ulp sensitivity {sens:.3g})")
    return {"max_dev": worst, "ulp_sensitivity": sens, "tol": tol}


def phase_hvite(ctx):
    d = make_tied_data(ctx, ctx.w.vocab_hvite, 2, "v1k")
    j = lambda *p: os.path.join(d, *p)  # noqa: E731
    out = {"phase": "HVite"}
    for side, dev, scp in (("dev", ctx.dev, "test.scp"),
                           ("ref", ctx.ref, "ref.scp")):
        run_tool(hvite, [
            "-T", "1", "-w", j("loop.slf"), "-p", "-20", "-i",
            j(f"rec_{side}.mlf"), "-H", j("hmmdefs"), "-S", j(scp),
            j("dict"), j("hmmlist")], dev, out if side == "dev" else None)
    recs = _mlf_entries(j("rec_dev.mlf"))
    check(len(recs) == ctx.w.n_utts and all(recs.values()),
          "HVite: an utterance has no result")
    stems = sorted(recs)[:ctx.w.n_ref]
    out.update(max_dev=_compare_recs(j("rec_dev.mlf"), j("rec_ref.mlf"),
                                     stems), tol=TOL_DECODE)
    return out


def phase_hdecode(ctx):
    d = make_tied_data(ctx, ctx.w.vocab_hdecode, 3, "d5k")
    j = lambda *p: os.path.join(d, *p)  # noqa: E731
    cfg = j("cfg")
    # the uniform-row LV network (auto from 800 words; forced for tiny
    # vocabularies); trigram guidance is on for a trigram LM
    _write_lines(cfg, ["HTKTPU: LVDECODE = T"])
    out = {"phase": "HDecode"}
    for side, dev, scp in (("dev", ctx.dev, "test.scp"),
                           ("ref", ctx.ref, "ref.scp")):
        os.makedirs(j(f"lat_{side}"), exist_ok=True)
        run_tool(hdecode, [
            "-T", "1", "-C", cfg, "-w", j("lm.arpa"), "-s", "8",
            "-p", "-10", "-u", "512", "-z", "lat", "-l", j(f"lat_{side}"),
            "-i", j(f"rec_{side}.mlf"), "-H", j("hmmdefs"), "-S", j(scp),
            j("dict"), j("hmmlist")], dev, out if side == "dev" else None)
    recs = _mlf_entries(j("rec_dev.mlf"))
    check(len(recs) == ctx.w.n_utts and all(recs.values()),
          "HDecode: an utterance has no result")
    lats = os.listdir(j("lat_dev"))
    check(len(lats) == ctx.w.n_utts, f"HDecode: {len(lats)} lattices")
    stems = sorted(recs)[:ctx.w.n_ref]
    out.update(max_dev=_compare_recs(j("rec_dev.mlf"), j("rec_ref.mlf"),
                                     stems), tol=TOL_DECODE)
    return out


def phase_hmmirest(ctx):
    d = os.path.join(ctx.work, "d5k")
    j = lambda *p: os.path.join(d, *p)  # noqa: E731
    check(os.path.isfile(j("rec_dev.mlf")),
          "HMMIRest needs the HDecode lattices")
    base = ["-T", "1", "-I", j("tri.mlf"), "-r", j("lat_dev"), "-d",
            j("dict"), "-s", "8", "-H", j("hmmdefs")]
    out = {"phase": "HMMIRest"}
    txt = run_tool(hmmirest, base + ["-M", j("mmi_all"), "-S",
                                     j("test.scp"), j("hmmlist")],
                   ctx.dev, out)
    out["criterion"] = _last_float(txt, "MMI criterion")
    m = _set_params(j("mmi_all", "hmmdefs"))
    check(all(np.all(np.isfinite(v)) for v in m.values()),
          "HMMIRest: non-finite parameters")
    crit = {}
    for side, dev in (("dev", ctx.dev), ("ref", ctx.ref)):
        txt = run_tool(hmmirest, base + ["-M", j("mmi_" + side), "-S",
                                         j("ref.scp"), j("hmmlist")], dev)
        crit[side] = _last_float(txt, "MMI criterion")
    worst = rel_dev(crit["dev"], crit["ref"])
    out.update(max_dev=worst, tol=TOL_MMI)
    check(worst <= TOL_MMI, f"HMMIRest deviation {worst:.3g}")
    return out


def _subset_mlf(src, dst, stems):
    m = _mlf_entries(src)
    _write_mlf(dst, [(s, [l.name for l in m[s]]) for s in stems], "rec")


def phase_hresults(ctx):
    out = {"phase": "HResults"}
    for tag in ("v1k", "d5k"):
        d = os.path.join(ctx.work, tag)
        j = lambda *p: os.path.join(d, *p)  # noqa: E731
        check(os.path.isfile(j("rec_ref.mlf")),
              f"HResults needs the {tag} recognition output")
        stems = sorted(_mlf_entries(j("rec_ref.mlf")))
        _subset_mlf(j("rec_dev.mlf"), j("rec_dev_sub.mlf"), stems)
        _subset_mlf(j("rec_ref.mlf"), j("rec_ref_sub.mlf"), stems)
        res = {}
        for name, dev, rec in (("all", ctx.dev, "rec_dev.mlf"),
                               ("dev", ctx.dev, "rec_dev_sub.mlf"),
                               ("ref", ctx.ref, "rec_ref_sub.mlf")):
            txt = run_tool(hresults, ["-I", j("words.mlf"), j("hmmlist"),
                                      j(rec)], dev,
                           out if name == "all" else None)
            res[name] = [ln for ln in txt.splitlines()
                         if ln.startswith("WORD:")]
        check(res["all"], f"HResults: no WORD line for {tag}")
        check(res["dev"] == res["ref"],
              f"HResults {tag}: {res['dev']} != {res['ref']}")
        out[tag] = res["all"][0]
    out.update(max_dev=0.0, tol=0.0)
    return out


def outp_errors(ctx):
    """OutP state log-likelihoods at each matmul precision against a
    float64 numpy reference, at the config-#4 shapes."""
    d = make_tied_data(ctx, ctx.w.vocab_hvite, 2, "v1k")
    c = compile_hmmset(load_mmf([os.path.join(d, "hmmdefs")]))
    x = read_htk_file(open(os.path.join(d, "test.scp")).readline()
                      .strip()).data.astype(np.float32)
    x64 = x.astype(np.float64)
    mu, var = c.means.astype(np.float64), c.variances.astype(np.float64)
    quad = (x64 ** 2) @ (1 / var).T - 2 * x64 @ (mu / var).T \
        + np.sum(mu * mu / var, axis=1)[None]
    g = -0.5 * (c.gconsts.astype(np.float64)[None] + quad)  # (T, M)
    sm = c.state_mix
    lw = np.where(sm >= 0, c.state_logw, -np.inf)
    terms = g[:, np.maximum(sm, 0)] + lw[None]  # (T, S, slots)
    top = terms.max(axis=2)
    ref = top + np.log(np.exp(terms - top[..., None]).sum(axis=2))
    errs = {}
    with jax.default_device(ctx.dev):
        for prec in ("highest", "high", "default"):
            f = jax.jit(lambda x_, p=prec: all_state_outp(
                x_, jnp.asarray(c.means), jnp.asarray(c.variances),
                jnp.asarray(c.gconsts), jnp.asarray(c.state_mix),
                jnp.asarray(c.state_logw), precision=p)[0])
            got = np.asarray(f(jnp.asarray(x)), np.float64)
            check(got.shape == ref.shape and np.all(np.isfinite(got)),
                  f"OutP {prec}: bad output")
            errs[prec] = {"max_abs": float(np.max(np.abs(got - ref))),
                          "max_rel": rel_dev(got, ref)}
    return {"shape": [int(x.shape[0]), int(c.means.shape[0]),
                      int(x.shape[1])], "errors": errs}


def phase_four_cards(ctx):
    """HERest -p 1 accumulators and one update: the ShardedTrainer over
    make_mesh() (every card) against the unsharded trainer on card 0."""
    d = make_monophone_data(ctx)
    j = lambda *p: os.path.join(d, *p)  # noqa: E731
    runs = {}
    out = {"phase": "HERest four cards", "n_devices": len(jax.devices())}
    for side, shard, scp in (("mesh", "T", "train.scp"),
                             ("one", "F", "train.scp"),
                             ("ulp", "F", _ulp_scp(d, "train.scp"))):
        cfg = j(f"cfg_{side}")
        _write_lines(cfg, ["HTKTPU: DEVICECOMPOSITE = F",
                           f"HTKTPU: USESHARDING = {shard}"])
        base = ["-T", "1", "-C", cfg, "-I", j("phones.mlf"), "-H",
                j("hmm0", "hmmdefs"), "-S", j(scp)]
        run_tool(herest, base + ["-p", "1", "-M", j(f"acc_{side}"),
                                 j("hmm0", "hmmlist")], ctx.dev,
                 out if side == "mesh" else None)
        txt = run_tool(herest, base + ["-M", j(f"upd_{side}"),
                                       j("hmm0", "hmmlist")], ctx.dev)
        z = np.load(j(f"acc_{side}", "HER1.acc"))
        params = _set_params(j(f"upd_{side}", "hmmdefs"))
        params.update({"acc_" + k: z[k] for k in z.files})
        runs[side] = (params, _last_float(txt, "per frame = "))
    lp_dev = rel_dev(runs["mesh"][1], runs["one"][1])
    out.update(_param_check(runs["mesh"][0], runs["one"][0],
                            runs["ulp"][0]), logp_dev=lp_dev,
               logp_tol=TOL_HEREST,
               n_utts=int(runs["one"][0]["acc_n_utts"]))
    check(lp_dev <= TOL_HEREST, f"four-card logP deviation {lp_dev:.3g}")
    return out


PHASES = (phase_hcopy, phase_herest, phase_hvite, phase_hdecode,
          phase_hmmirest, phase_hresults)


# ---------------------------------------------------------------------------


def card_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()


def result_line(devices):
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only HERest data-parallel on 4 cards vs 1")
    args = ap.parse_args(argv)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform})",
              file=sys.stderr)
        return 1
    if args.four_cards and len(devices) != 4:
        print(f"chip_smoke: --four-cards needs 4 GPUs, found "
              f"{len(devices)}", file=sys.stderr)
        return 1
    enable_compile_cache()
    print(card_line(), flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke.") as work:
        ctx = Ctx(work, FULL, args.seed, devices[0], jax.devices("cpu")[0])
        phases = (phase_four_cards,) if args.four_cards else PHASES
        for ph in phases:
            t0 = time.perf_counter()
            r = ph(ctx)
            r["wall_s"] = time.perf_counter() - t0
            print(json.dumps(r), flush=True)
        if not args.four_cards:
            print(json.dumps({"outp_vs_float64": outp_errors(ctx)}),
                  flush=True)
    print(result_line(devices if not args.four_cards else devices[:4]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
