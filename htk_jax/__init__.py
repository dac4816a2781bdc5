"""htk_jax — a JAX speech toolkit with the capabilities of HTK.

A ground-up rebuild of the HTK (Hidden Markov Model Toolkit) pipeline —
feature extraction, GMM-HMM training (flat start, embedded Baum-Welch),
decision-tree tied-state triphones, token-passing Viterbi decoding,
lattices, discriminative training, adaptation, and the v3.5 ANN stack —
designed for accelerators on JAX/XLA rather than ported from HTK's ANSI C.

Layer map (mirrors SURVEY.md §1, idiomatically):

  utils/     L1 runtime: HTK config parser, CLI standard options, scp files,
             error reporting, log arithmetic (HMath's LAdd/LZERO semantics).
  io/        L3 formats: HTK feature files, waveforms (WAV/NIST/HTK), MLF
             labels, MMF model files, SLF lattices, dictionaries.
  ops/       L2 device compute: DSP frontend (framing/FFT/mel/DCT/deltas),
             batched GMM log-likelihood (OutP), semiring scans.
  models/    L4: HMMSet as a struct-of-arrays pytree with tying index tables,
             prototype models.
  algo/      L5: Baum-Welch, Viterbi, reestimation, k-means, decision-tree
             clustering, network compilation, lattice ops, EBW, adaptation.
  parallel/  distributed: shard_map/psum accumulator exchange over a Mesh
             (the one-program form of HERest -p N file-based parallelism).
  tools/     L6: CLI tools with HTK's names, flags and config surface
             (HCopy, HCompV, HERest, HHEd, HVite, HResults, ...).

Reference: canonical HTK 3.4.1/3.5 layout per SURVEY.md (the /root/reference
mount was empty; citations are to canonical HTK file/function names).
"""

__version__ = "0.1.0"
