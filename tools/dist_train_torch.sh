#!/usr/bin/env bash
# Data-parallel training of the PyTorch port on one host: NPROCS ranks of
# tools/train_torch.py started by torch.distributed.run (torchrun), each
# with --launcher pytorch. With --device cuda (the default) each rank takes
# the card cuda:LOCAL_RANK and the ranks talk over nccl; --device cpu gives
# gloo ranks on the CPU.
#
# Usage: tools/dist_train_torch.sh CONFIG NPROCS [train_torch.py args...]
#   PORT        the rendezvous port (29500)
set -euo pipefail
CONFIG=$1
NPROCS=$2
shift 2
PORT=${PORT:-29500}
SCRIPT_DIR=$(cd "$(dirname "$0")" && pwd)

exec python -m torch.distributed.run --nproc_per_node "$NPROCS" \
    --master_port "$PORT" "$SCRIPT_DIR/train_torch.py" "$CONFIG" \
    --launcher pytorch "$@"
