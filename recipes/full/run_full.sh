#!/bin/bash
# run_full — the RM-recipe role (SURVEY.md §4 item 1, the HTKBook
# system-build tutorial at corpus scale): drive the COMPLETE system
# build on the multi-speaker synthetic corpus and score every stage on
# a held-out test set, committing the WER table:
#
#   HCopy -> HCompV flat start -> HERest x3 (monophones)
#   HLEd TC -> HHEd CL/TI -> HERest x2
#   HHEd QS/TB/AU/ST tree tying (incl. unseen-triphone synthesis)
#   -> HERest x2 -> HHEd MU -> HERest x2
#   HVite bigram decode                         [stage: tied+mix]
#   HVite -z lattices -> HMMIRest -> decode     [stage: MMI]
#   HERest -K per-speaker CMLLR (enrollment set) -> HVite -J
#                                               [stage: adapted]
#   LBuild trigram -> HDecode (TRIGUIDE single-pass) -> rescored
#                                               [stage: HDecode]
#
# Usage: bash run_full.sh [workdir]    (FULL=1 for the ~30-min corpus)
# Writes results.md (stage | %Corr | %Acc) and compares against
# results_expected.md committed next to this script (tolerance below).
set -e
HERE=$(cd "$(dirname "$0")" && pwd)
WORK=${1:-$(mktemp -d)}
mkdir -p "$WORK"
cd "$WORK"
echo "== full-recipe workdir: $WORK"
if [ "${RECIPE_GPU:-0}" != "1" ]; then
  export JAX_PLATFORMS=cpu
fi

# Self-sufficient tool resolution: when the package isn't pip-installed,
# import from the repo checkout and shim the console-script names
# (HCopy, HERest, ...) onto PATH as `python -m` wrappers generated from
# pyproject [project.scripts].
REPO=$(cd "$HERE/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
if ! command -v HCopy >/dev/null 2>&1; then
  mkdir -p "$WORK/bin"
  python - "$REPO" "$WORK/bin" <<'EOF'
import os, re, sys
repo, bindir = sys.argv[1], sys.argv[2]
txt = open(os.path.join(repo, "pyproject.toml")).read()
sect = re.search(r"\[project\.scripts\](.*?)(\n\[|\Z)", txt, re.S).group(1)
for name, target in re.findall(r'(\w+)\s*=\s*"([\w\.]+):main"', sect):
    path = os.path.join(bindir, name)
    with open(path, "w") as f:
        f.write(f'#!/bin/sh\nexec python -m {target} "$@"\n')
    os.chmod(path, 0o755)
EOF
  export PATH="$WORK/bin:$PATH"
fi

python "$HERE/make_corpus.py"
printf 'SOURCEFORMAT = WAV\nTARGETKIND = MFCC_E_D_A\n' > cfg_wav
printf 'TARGETKIND = MFCC_E_D_A\n' > cfg

echo "== features + flat start"
HCopy -C cfg_wav -S copy.scp
HCompV -C cfg -f 0.01 -m -M hmm0 -S train.scp proto
python - <<'EOF'
from htk_jax.io.mmf import load_mmf, save_mmf
from htk_jax.models.proto import clone_proto
hs = load_mmf("hmm0/proto")
cl = clone_proto(hs, "proto", ["aa", "eh", "iy", "uw", "sil"])
cl.macros["v"]["varFloor1"] = load_mmf("hmm0/vFloors").macros["v"]["varFloor1"]
save_mmf(cl, "hmm0/hmmdefs")
EOF

echo "== monophone training"
for it in 1 2 3; do
  mkdir -p hmm$it
  HERest -C cfg -T 1 -I phones.mlf -H hmm$((it-1))/hmmdefs -M hmm$it \
         -S train.scp monophones | grep average
done

echo "== triphones"
printf 'WB sil\nTC\n' > mktri.led
HLEd -i tri.mlf mktri.led phones.mlf
python - <<'EOF'
names = set()
for ln in open("tri.mlf"):
    ln = ln.strip()
    if ln and not ln.startswith(("#", '"', ".")):
        names.add(ln)
open("triphones", "w").write("\n".join(sorted(names)) + "\n")
# the FULL word-internal context inventory (every l-p+r / p+r / l-p
# over the vowels, plus lone monophones): AU retargets the tied trees
# onto the unseen ones so any future lexicon decodes
ph = ["aa", "eh", "iy", "uw"]
full = set(names)
for p in ph:
    full.add(p)
    for l in ph:
        full.add(f"{l}-{p}")
        for r in ph:
            full.add(f"{l}-{p}+{r}")
    for r in ph:
        full.add(f"{p}+{r}")
open("alltri", "w").write("\n".join(sorted(full | {"sil"})) + "\n")
EOF
cat > mktri.hed <<'EOF'
CL triphones
TI T_aa {(*-aa+*,aa+*,*-aa,aa).transP}
TI T_eh {(*-eh+*,eh+*,*-eh,eh).transP}
TI T_iy {(*-iy+*,iy+*,*-iy,iy).transP}
TI T_uw {(*-uw+*,uw+*,*-uw,uw).transP}
EOF
mkdir -p tri0 tri1 tri2 tri3 tied1 tied2 mix1 mix2 mix3
HHEd -H hmm3/hmmdefs -M tri0 mktri.hed monophones
for it in 1 2; do
  HERest -C cfg -T 1 -I tri.mlf -H tri$((it-1))/hmmdefs -M tri$it \
         -s tri$it/stats -S train.scp triphones | grep average
done

echo "== tree tying (TB + AU unseen synthesis)"
cat > tie.hed <<EOF
RO 1.0 tri2/stats
QS "L_aa" { aa-* }
QS "L_eh" { eh-* }
QS "L_iy" { iy-* }
QS "L_uw" { uw-* }
QS "L_sil" { sil-* }
QS "R_aa" { *+aa }
QS "R_eh" { *+eh }
QS "R_iy" { *+iy }
QS "R_uw" { *+uw }
QS "R_sil" { *+sil }
$(for p in aa eh iy uw; do for s in 2 3 4; do
  echo "TB 10.0 \"ST_${p}_${s}_\" {(\"*-${p}+*\",\"${p}+*\",\"*-${p}\",\"${p}\").state[${s}]}"
done; done)
ST trees
AU alltri
CO tiedlist
EOF
HHEd -T 1 -H tri2/hmmdefs -M tri3 tie.hed triphones | tail -2
for it in 1 2; do
  M=tied$it; P=tri3; [ $it -gt 1 ] && P=tied$((it-1))
  HERest -C cfg -T 1 -I tri.mlf -H $P/hmmdefs -M $M -S train.scp tiedlist | grep average
done

echo "== mixture splitting"
echo 'MU 2 {*.state[2-4].mix}' > mu.hed
HHEd -H tied2/hmmdefs -M mix1 mu.hed tiedlist
HERest -C cfg -T 1 -I tri.mlf -H mix1/hmmdefs -M mix2 -S train.scp tiedlist | grep average
HERest -C cfg -T 1 -I tri.mlf -H mix2/hmmdefs -M mix3 -S train.scp tiedlist | grep average

score () {  # score <tag> <rec.mlf>
  HResults -I words_test.mlf tiedlist "$2" | tee hr_$1.txt | grep WORD
  python - "$1" <<'EOF'
import re, sys
tag = sys.argv[1]
txt = open(f"hr_{tag}.txt").read()
m = re.search(r"%Corr=([0-9.]+), Acc=([0-9.-]+)", txt)
with open("results.md", "a") as f:
    f.write(f"| {tag} | {m.group(1)} | {m.group(2)} |\n")
EOF
}
printf '| stage | %%Corr | %%Acc |\n|---|---|---|\n' > results.md

echo "== bigram decode (held-out test set)"
HBuild wlist wdnet.slf
HVite -w wdnet.slf -p -12 -i rec_tied.mlf -H mix3/hmmdefs \
      -S test.scp dict tiedlist
score tied+mix rec_tied.mlf

echo "== MMI"
mkdir -p lats numlats mmi1
HVite -w wdnet.slf -p -12 -z lat -l lats -i rec_tr.mlf -H mix3/hmmdefs \
      -S train.scp dict tiedlist
# numerator lattices from forced alignment (HVite -a -z, the HTK MMI
# recipe shape): both sides then run through the SAME arc-FB machinery
# so fixed-arc-boundary bias cancels between numerator and denominator
# (an MLF numerator uses soft composite-FB boundaries and the mismatch
# leaks into the EBW update). SIL is interleaved to match the corpus.
python - <<'PYEOF'
lines = open("words_train.mlf").read().splitlines()
out = ["#!MLF!#"]
for ln in lines[1:]:
    if ln.startswith('"'):
        out.append(ln); out.append("SIL")
    elif ln == ".":
        out.append(".")
    else:
        out.append(ln); out.append("SIL")
open("words_sil.mlf", "w").write("\n".join(out) + "\n")
PYEOF
HVite -a -I words_sil.mlf -z lat -l numlats -i align_tr.mlf \
      -H mix3/hmmdefs -S train.scp dict tiedlist
# I-smoothing tau 100 + LATPROBSCALE 0.1 (the HTKBook discriminative
# defaults): an unsmoothed EBW step with one-hot lattice posteriors
# over-sharpens train-speaker boundaries and measurably hurts the
# unseen test speakers
printf 'TARGETKIND = MFCC_E_D_A\nHMMIREST: ISMOOTHTAU = 100\nHMMIREST: LATPROBSCALE = 0.1\n' > cfg_mmi
HMMIRest -C cfg_mmi -q numlats -r lats -d dict -H mix3/hmmdefs -M mmi1 \
         -S train.scp tiedlist
HVite -w wdnet.slf -p -12 -i rec_mmi.mlf -H mmi1/hmmdefs \
      -S test.scp dict tiedlist
score MMI rec_mmi.mlf

echo "== per-speaker CMLLR adaptation (enrollment set)"
# enrollment statistics must align TRIPHONE labels: monophone labels on
# a tied-triphone set accumulate against the stale untrained monophone
# models and the resulting transform is garbage
HLEd -i tri_adapt.mlf mktri.led phones_adapt.mlf
printf 'TARGETKIND = MFCC_E_D_A\nHADAPT: TRANSKIND = CMLLR\nHADAPT: BLOCKS = 3\n' > cfg_ad
mkdir -p xforms
HERest -C cfg_ad -I tri_adapt.mlf -H mix3/hmmdefs -K xforms \
       -h '%%%%_*' -S adapt.scp tiedlist
HVite -w wdnet.slf -p -12 -J xforms -h '%%%%_*' -i rec_ad.mlf \
      -H mix3/hmmdefs -S test.scp dict tiedlist
score adapted rec_ad.mlf

echo "== trigram HDecode (single-pass TRIGUIDE)"
python - <<'EOF'
sents, cur = [], []
for ln in open("words_train.mlf").read().splitlines()[1:]:
    if ln.startswith('"'):
        cur = []
    elif ln == ".":
        sents.append(" ".join(cur))
    else:
        cur.append(ln)
open("words.txt", "w").write("\n".join(sents) + "\n")
EOF
LBuild -n 3 wmap lm3.arpa words.txt
HDecode -w lm3.arpa -p -12 -i rec_hd.mlf -H mix3/hmmdefs \
        -S test.scp dict_hd tiedlist
score HDecode rec_hd.mlf

echo "== results"
cat results.md
# detection logic lives in check_results.py so the regression check is
# itself unit-tested (a deliberately broken MMI row must FAIL — see
# tests/test_recipe_check.py)
python "$HERE/check_results.py" results.md "$HERE/results_expected.md"
