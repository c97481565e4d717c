#!/usr/bin/env bash
# SLURM evaluation of the PyTorch port: srun starts one task a card, each a
# rank of tools/test_torch.py with --launcher slurm (see
# tools/slurm_train_torch.sh for the environment).
#
# Usage: tools/slurm_test_torch.sh PARTITION JOB_NAME CONFIG CHECKPOINT [test_torch.py args...]
#   GPUS            cards in all (8)
#   GPUS_PER_NODE   cards a node (8)
#   PORT            the rendezvous port (29500)
set -euo pipefail
PARTITION=$1
JOB_NAME=$2
CONFIG=$3
CHECKPOINT=$4
shift 4
GPUS=${GPUS:-8}
GPUS_PER_NODE=${GPUS_PER_NODE:-8}
PORT=${PORT:-29500}
SCRIPT_DIR=$(cd "$(dirname "$0")" && pwd)

srun -p "$PARTITION" --job-name="$JOB_NAME" --ntasks="$GPUS" \
    --ntasks-per-node="$GPUS_PER_NODE" --gres=gpu:"$GPUS_PER_NODE" \
    --kill-on-bad-exit=1 \
    bash -c 'export MASTER_ADDR=$(scontrol show hostnames \
                 "$SLURM_JOB_NODELIST" | head -n1)
             export MASTER_PORT='"$PORT"'
             exec "$0" "$@"' \
    python "$SCRIPT_DIR/test_torch.py" "$CONFIG" "$CHECKPOINT" \
    --launcher slurm "$@"
