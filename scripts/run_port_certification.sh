#!/usr/bin/env bash
# The JAX package's procg seed-0 certification recipe (docs/PERF.md, "Round-4")
# run by the PyTorch + CUDA port on one GPU: the guided pretrain on 2,048
# procedural scenes, the CLS-attention statistics, the delta grid of six filter
# specs on 64 held-out scenes (with the unguided row), the int8 and int8 +
# 2:0.35 deltas against the strict float32 path, and the certification table.
#
#   scripts/run_port_certification.sh [SIZE] [BATCH] [STEPS] [OUT]
#
# Defaults: 518 16 3000 build/certify/results. Scenes and checkpoints are kept
# under build/certify/; the small JSON and log outputs go to OUT.
set -euo pipefail
SIZE=${1:-518}
BATCH=${2:-16}
STEPS=${3:-3000}
OUT=${4:-build/certify/results}
CK=build/certify/ckpts_${SIZE}
CKPT=${CK}/s0_procg_${STEPS}_i${SIZE}.npz
SPECS="2:0.25;2:0.35;2:0.25@p;2:0.25@c0.5;2:0.35@c0.5;2:0.25@c0.75"
mkdir -p "${OUT}"
M=cognitive_aim_tpu_torch.certify
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "${OUT}/card.txt"
stamp() { echo "== $1 $(date +%s)" | tee -a "${OUT}/timeline.txt"; }
stamp pretrain
python3 -m ${M}.pretrain --guided --seed 0 --steps "${STEPS}" --n-images 2048 \
    --batch "${BATCH}" --image-size "${SIZE}" --ckpt-dir "${CK}" \
    --summary "${OUT}/pretrain_procg_s0.json" > "${OUT}/pretrain.log" 2>&1
stamp attention_stats
python3 -m ${M}.attention_stats --checkpoint "${CKPT}" --image-size "${SIZE}" \
    --out "${OUT}/attn_stats_procg_s0.json" > "${OUT}/attention_stats.log" 2>&1
stamp delta_sweep
python3 -m ${M}.delta_sweep --measure-only --seeds 0 --laws procg --steps "${STEPS}" \
    --image-size "${SIZE}" --n-eval 64 --include-unguided --filters "${SPECS}" \
    --ckpt-dir "${CK}" --out "${OUT}/delta_procg_s0.json" > "${OUT}/delta_sweep.log" 2>&1
stamp policy_delta
python3 -m ${M}.policy_delta --checkpoint "${CKPT}" --image-size "${SIZE}" \
    --token-filter 2:0.35 --out "${OUT}/policy_delta_procg_s0.json" > "${OUT}/policy_delta.log" 2>&1
stamp certify_filter
python3 -m ${M}.certify_filter --baseline "${OUT}/delta_procg_s0.json" \
    --candidate "${OUT}/delta_procg_s0.json" --out "${OUT}/certify_procg_s0.json" \
    > "${OUT}/certify_filter.log" 2>&1
stamp done
