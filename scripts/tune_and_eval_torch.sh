#!/bin/bash
# Tune the 20 DEFAULT_SHAPES on the card in both accumulator families (offline, then the
# server sub-entries at 100 qps) into tpul2_torch/data/tunedb_h100.json, then run the suite
# over them through that DB in both modes, writing the four CUDA-L2 CSVs and their sidecars.
#
#   bash scripts/tune_and_eval_torch.sh [OUT_DIR]
#
# OUT_DIR (default: eval_results) receives the CSVs, sidecars and logs, and a copy of the DB.
# Every step runs even if an earlier one failed; each prints its exit code.
cd "$(dirname "$0")/.." || exit 1
out=${1:-eval_results}
mkdir -p "$out"
export PYTHONPATH=$PWD
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/nvidia_smi.txt"
rm -f tpul2_torch/data/tunedb_h100.json
t0=$(date +%s)
for mode in offline server; do
  for acc in float32 bfloat16; do
    python -m tpul2_torch.autotune --shapes default --acc $acc --mode $mode --target_qps 100 \
      -v > "$out/tune_${acc}_${mode}.json" 2> "$out/tune_${acc}_${mode}.log"
    echo "tune $acc $mode rc=$? $(( $(date +%s) - t0 ))s"
  done
done
cp tpul2_torch/data/tunedb_h100.json "$out/"
for mode in offline server; do
  for acc in float32 bfloat16; do
    python scripts/run_suite_torch.py eval --acc $acc --mode $mode --target_qps 100 \
      --out_dir "$out" > "$out/suite_${acc}_${mode}.log" 2>&1
    echo "suite $acc $mode rc=$? $(( $(date +%s) - t0 ))s"
  done
done
