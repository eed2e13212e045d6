#!/usr/bin/env bash
# The transfer study on the card at study6's protocol (the JAX package's
# `scripts/tpu_sweep.sh` study6 line): v2 backbone, arms transfer and
# control, seed-major. Resumes from JSON_OUT; each run's metrics and log,
# and JSON_OUT, are copied to OUT_DIR as the study goes (the runs'
# checkpoints stay in a temporary directory). Prints the card's name and power limit first.
#
#   scripts/torch_transfer_study6.sh OUT_DIR JSON_OUT SEEDS
#
# SEEDS is a comma-separated list, e.g. 0,1,2,3.
set -euo pipefail
out_dir=$1 json_out=$2 seeds=$3
here=$(cd "$(dirname "$0")/.." && pwd)
runs=$(mktemp -d)
trap 'rm -rf "$runs"' EXIT
mkdir -p "$out_dir"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 "$here/scripts/torch_transfer_study.py" \
  --epochs 150 --boxpc_epochs 40 --train_size 4096 --val_size 1024 \
  --num_point 512 --batch_size 64 --weak_warmup_steps 2000 --diag \
  --model frustum_pointnets_v2 --variants transfer,control \
  --seed_list "$seeds" --out_dir "$runs" --out_json "$json_out" &
pid=$!
# copy each finished run's files as the study goes, so that a cut call
# keeps what it finished
while kill -0 "$pid" 2>/dev/null; do
  sleep 20
  for d in "$runs"/*_s*; do
    [ -d "$d" ] || continue
    mkdir -p "$out_dir/$(basename "$d")"
    cp "$d"/*.csv "$d"/log_train.txt "$out_dir/$(basename "$d")/" 2>/dev/null || true
  done
  cp "$json_out" "$out_dir/" 2>/dev/null || true
done
wait "$pid"
for d in "$runs"/*_s*; do
  mkdir -p "$out_dir/$(basename "$d")"
  cp "$d"/*.csv "$d"/log_train.txt "$out_dir/$(basename "$d")/"
done
cp "$json_out" "$out_dir/"
