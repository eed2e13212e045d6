#!/usr/bin/env bash
# The config 2 showcase of the PyTorch port on one NVIDIA GPU: train on
# 2048 synthetic frustums with the records resident on the card, then
# evaluate (mAP@0.25 over the 10 SUN RGB-D classes), for F-PointNet v1
# in float32, v2 in float32 and v2 in bfloat16, one after the other.
#
#   scripts/torch_showcase.sh OUT_DIR [SEED] [EPOCHS]
#
# EPOCHS defaults to the showcase's 120. Checkpoints go to a temporary
# directory; OUT_DIR receives each variant's logs, metrics, detections
# and one summary line a variant (also printed): the card's name and
# power limit, the seed, the wall times of training and of evaluation,
# and the APs.
set -euo pipefail
out=${1:?usage: torch_showcase.sh OUT_DIR [SEED] [EPOCHS]}
seed=${2:-0}
epochs=${3:-120}
here=$(cd "$(dirname "$0")/.." && pwd)
work=$(mktemp -d)
trap 'rm -rf "$work"' EXIT
mkdir -p "$out"
card=$(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | head -n 1)
common=(--preset config2_fpointnet_v1_sunrgbd --synthetic_train 2048
        --seed "$seed")
for variant in "v1_f32:" \
               "v2_f32:--model frustum_pointnets_v2" \
               "v2_bf16:--model frustum_pointnets_v2 --compute_dtype bfloat16"; do
  name=${variant%%:*}
  read -r -a flags <<< "${variant#*:}"
  log_dir=$work/$name
  t0=$(date +%s.%N)
  (cd "$here" && python3 -m transferable3d_torch.train.train_sup \
      "${common[@]}" "${flags[@]}" --max_epoch "$epochs" --device_data True \
      --log_dir "$log_dir") > "$out/$name.train.log" 2>&1
  t1=$(date +%s.%N)
  (cd "$here" && python3 -m transferable3d_torch.train.test \
      "${common[@]}" "${flags[@]}" --log_dir "$log_dir" \
      --result_dir "$log_dir/result") > "$out/$name.test.log" 2>&1
  t2=$(date +%s.%N)
  for f in log_train.txt metrics_train.csv metrics_val.csv; do
    cp "$log_dir/$f" "$out/$name.$f"
  done
  cp "$log_dir/result/log_test.txt" "$out/$name.log_test.txt"
  cp "$log_dir/result/detections.txt" "$out/$name.detections.txt"
  aps=$(sed -n 's/.*AP@0.25 \(.*\): \(.*\)/\1=\2/p' \
        "$log_dir/result/log_test.txt" | tr '\n' ' ')
  rates=$(sed -n 's/.*(\([0-9.]*\) frustums\/s).*/\1/p' \
          "$log_dir/log_train.txt" | tail -n 3 | tr '\n' ' ')
  line=$(awk -v n="$name" -v s="$seed" -v e="$epochs" -v a="$t0" \
         -v b="$t1" -v c="$t2" -v r="$rates" -v ap="$aps" -v card="$card" \
         'BEGIN { printf "%s seed=%s epochs=%s train_s=%.3f eval_s=%.3f frustums/s(last 3 epochs)=[%s] %s[%s]", n, s, e, b - a, c - b, r, ap, card }')
  echo "$line" | tee -a "$out/summary.txt"
done
