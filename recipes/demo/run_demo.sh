#!/bin/bash
# run_demo — the HTKDemo role: drive the COMPLETE pipeline on a synthetic
# corpus and assert the scored result, making this an end-to-end
# regression test of every subsystem:
#
#   HCopy -> HCompV -> HERest x3 (monophones)
#   HLEd TC -> HHEd CL/TI -> HERest x2 -> HHEd TB tying -> HERest
#   HHEd MU (mixtures) -> HERest
#   HBuild -> HVite (+lattices) -> HResults          [must be 100%]
#   HLRescore, HMMIRest (MMI), HNTrainSGD/hybrid HVite, LBuild/HDecode
#
# Usage: bash run_demo.sh [workdir]   (defaults to a temp dir)
set -e
HERE=$(cd "$(dirname "$0")" && pwd)
WORK=${1:-$(mktemp -d)}
cd "$WORK"
echo "== demo workdir: $WORK"
# default to CPU (set DEMO_GPU=1 to run on the GPU)
if [ "${DEMO_GPU:-0}" != "1" ]; then
  export JAX_PLATFORMS=cpu
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
cl = clone_proto(hs, "proto", ["aa", "iy", "uw", "sil"])
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
EOF
cat > mktri.hed <<'EOF'
CL triphones
TI T_aa {(*-aa+*,aa+*,*-aa,aa).transP}
TI T_iy {(*-iy+*,iy+*,*-iy,iy).transP}
TI T_uw {(*-uw+*,uw+*,*-uw,uw).transP}
EOF
mkdir -p tri0 tri1 tri2 tri3 tied1 mix1 tied2
HHEd -H hmm3/hmmdefs -M tri0 mktri.hed monophones
for it in 1 2; do
  HERest -C cfg -T 1 -I tri.mlf -H tri$((it-1))/hmmdefs -M tri$it \
         -s tri$it/stats -S train.scp triphones | grep average
done

echo "== tree tying"
cat > tie.hed <<'EOF'
RO 1.0 tri2/stats
QS "L_aa" { aa-* }
QS "L_iy" { iy-* }
QS "L_uw" { uw-* }
QS "R_aa" { *+aa }
QS "R_iy" { *+iy }
QS "R_uw" { *+uw }
TB 10.0 "ST_aa_2_" {("*-aa+*","aa+*","*-aa","aa").state[2]}
TB 10.0 "ST_aa_3_" {("*-aa+*","aa+*","*-aa","aa").state[3]}
TB 10.0 "ST_aa_4_" {("*-aa+*","aa+*","*-aa","aa").state[4]}
TB 10.0 "ST_iy_2_" {("*-iy+*","iy+*","*-iy","iy").state[2]}
TB 10.0 "ST_iy_3_" {("*-iy+*","iy+*","*-iy","iy").state[3]}
TB 10.0 "ST_iy_4_" {("*-iy+*","iy+*","*-iy","iy").state[4]}
TB 10.0 "ST_uw_2_" {("*-uw+*","uw+*","*-uw","uw").state[2]}
TB 10.0 "ST_uw_3_" {("*-uw+*","uw+*","*-uw","uw").state[3]}
TB 10.0 "ST_uw_4_" {("*-uw+*","uw+*","*-uw","uw").state[4]}
ST trees
EOF
HHEd -T 1 -H tri2/hmmdefs -M tri3 tie.hed triphones | tail -2
HERest -C cfg -T 1 -I tri.mlf -H tri3/hmmdefs -M tied1 -S train.scp triphones | grep average

echo "== mixture splitting"
echo 'MU 2 {*.state[2-4].mix}' > mu.hed
HHEd -H tied1/hmmdefs -M mix1 mu.hed triphones
HERest -C cfg -T 1 -I tri.mlf -H mix1/hmmdefs -M tied2 -S train.scp triphones | grep average

echo "== decode + score"
HBuild wlist wdnet.slf
mkdir -p lats
HVite -w wdnet.slf -p -10 -z lat -l lats -i rec.mlf -H tied2/hmmdefs \
      -S train.scp dict triphones
HResults -I words.mlf triphones rec.mlf | tee results.txt
grep -q "WORD: %Corr=100.00, Acc=100.00" results.txt \
  || { echo "DEMO FAILED: tied-triphone decode not 100%"; exit 1; }

echo "== MMI (HMMIRest) + re-score"
mkdir -p mmi1
HMMIRest -I tri.mlf -r lats -d dict -H tied2/hmmdefs -M mmi1 \
         -S train.scp triphones
HVite -w wdnet.slf -p -10 -i recmmi.mlf -H mmi1/hmmdefs -S train.scp dict triphones
HResults -I words.mlf triphones recmmi.mlf | grep -q "Acc=100.00" \
  || { echo "DEMO FAILED: MMI decode regressed"; exit 1; }

echo "== DNN hybrid"
printf 'HNTRAINSGD: HIDDENSIZE = 128\nHNTRAINSGD: CONTEXT = 2\nHNTRAINSGD: LEARNRATE = 0.05\nHNTRAINSGD: ACTIVATION = RELU\nTARGETKIND = MFCC_E_D_A\n' > cfg_dnn
mkdir -p dnn
HNTrainSGD -C cfg_dnn -e 15 -I tri.mlf -H tied2/hmmdefs -M dnn -S train.scp triphones
HVite -w wdnet.slf -p -10 -N dnn/ann -i recdnn.mlf -H tied2/hmmdefs -S train.scp dict triphones
HResults -I words.mlf triphones recdnn.mlf | grep WORD

echo "== trigram HDecode"
python - <<'EOF'
lines = open("words.mlf").read().splitlines()
sents, cur = [], []
for ln in lines[1:]:
    if ln.startswith('"'):
        cur = []
    elif ln == ".":
        sents.append(" ".join(cur))
    else:
        cur.append(ln)
open("words.txt", "w").write("\n".join(sents) + "\n")
EOF
LBuild -n 3 wmap lm3.arpa words.txt
# HDecode dictionary, recipe convention: optional trailing silence
# pron variants per word plus <s>/</s> silence entries (STARTWORD /
# ENDWORD) so the obligatory utterance-edge silence is modelled
cat > dict_hd <<'EOF'
ONE  aa iy
ONE  aa iy sil
TWO  iy uw
TWO  iy uw sil
THREE  uw aa iy
THREE  uw aa iy sil
<s> []  sil
</s> []  sil
EOF
HDecode -w lm3.arpa -p -10 -i rechd.mlf -H tied2/hmmdefs -S train.scp dict_hd triphones
HResults -I words.mlf triphones rechd.mlf | grep -q "Acc=100.00" \
  || { echo "DEMO FAILED: HDecode not 100%"; exit 1; }

echo "== DEMO PASSED (all stages, 100% on tied-triphone / MMI / HDecode)"
