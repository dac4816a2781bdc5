"""Synthesize the demo corpus: 3-word vocabulary over realistic vowels.

The HTKDemo role (SURVEY.md L7): a tiny self-contained corpus so the full
pipeline can run and be scored without external data.  Utterances are
realistic synthesized speech — a glottal pulse train with pitch
declination and jitter driven through time-varying Klatt formant
resonators (Peterson & Barney vowel targets), with formant transitions
between phones, variable phone durations, and breath noise (the
synthesizer lives in tests/golden/gen_mfcc_golden.py, the standalone
HTKBook-golden generator).  A correctly working pipeline still reaches
100% accuracy — the recipe asserts that, which makes it an end-to-end
regression test on speech-like input rather than pure sines.
"""

import importlib.util
import os
import struct
import sys

import numpy as np

_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "gen_mfcc_golden",
    os.path.join(_here, "..", "..", "tests", "golden", "gen_mfcc_golden.py"))
_gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_gen)

WORDS = {"ONE": ["aa", "iy"], "TWO": ["iy", "uw"], "THREE": ["uw", "aa", "iy"]}


def synth(phs, rng):
    durs = [0.08 if p == "sil" else float(rng.uniform(0.12, 0.22))
            for p in phs]
    x = _gen.synth_speech(phs, dur_s=durs, seed=int(rng.integers(1 << 31)))
    return x.astype(np.int16)


def write_wav(path, x):
    data = x.astype("<i2").tobytes()
    hdr = (
        b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
        + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2, 16)
        + b"data" + struct.pack("<I", len(data))
    )
    open(path, "wb").write(hdr + data)


def main(n_train=10, seed=21):
    rng = np.random.default_rng(seed)
    wnames = list(WORDS)
    word_seqs, phone_seqs = [], []
    for i in range(n_train):
        ws = [wnames[int(x)] for x in rng.integers(0, 3, size=3)]
        phs = ["sil"]
        for w in ws:
            phs += WORDS[w] + ["sil"]
        word_seqs.append(ws)
        phone_seqs.append(phs)
        write_wav(f"u{i}.wav", synth(phs, rng))
    with open("phones.mlf", "w") as f:
        f.write("#!MLF!#\n")
        for i, phs in enumerate(phone_seqs):
            f.write(f'"*/u{i}.lab"\n' + "\n".join(phs) + "\n.\n")
    with open("words.mlf", "w") as f:
        f.write("#!MLF!#\n")
        for i, ws in enumerate(word_seqs):
            f.write(f'"*/u{i}.lab"\n' + "\n".join(ws) + "\n.\n")
    open("copy.scp", "w").write(
        "\n".join(f"u{i}.wav u{i}.mfc" for i in range(n_train)) + "\n"
    )
    open("train.scp", "w").write(
        "\n".join(f"u{i}.mfc" for i in range(n_train)) + "\n"
    )
    open("monophones", "w").write("aa\niy\nuw\nsil\n")
    open("dict", "w").write(
        "ONE  aa iy\nTWO  iy uw\nTHREE  uw aa iy\nSIL [] sil\n"
    )
    open("wlist", "w").write("ONE\nTWO\nTHREE\nSIL\n")

    from htk_jax.io.mmf import save_mmf
    from htk_jax.models.proto import make_proto

    save_mmf(make_proto(nstates=5, dim=39, parm_kind="MFCC_E_D_A"), "proto")
    print(f"demo corpus: {n_train} utterances")


if __name__ == "__main__":
    main(*[int(a) for a in sys.argv[1:]])
