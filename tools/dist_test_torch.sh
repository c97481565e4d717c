#!/usr/bin/env bash
# Data-parallel evaluation of the PyTorch port on one host: NPROCS ranks of
# tools/test_torch.py started by torch.distributed.run (torchrun), each
# with --launcher pytorch; each rank predicts its share of the images and
# rank 0 computes the metrics. --device cpu gives gloo ranks on the CPU.
#
# Usage: tools/dist_test_torch.sh CONFIG CHECKPOINT NPROCS [test_torch.py args...]
#   PORT        the rendezvous port (29500)
set -euo pipefail
CONFIG=$1
CHECKPOINT=$2
NPROCS=$3
shift 3
PORT=${PORT:-29500}
SCRIPT_DIR=$(cd "$(dirname "$0")" && pwd)

exec python -m torch.distributed.run --nproc_per_node "$NPROCS" \
    --master_port "$PORT" "$SCRIPT_DIR/test_torch.py" "$CONFIG" \
    "$CHECKPOINT" --launcher pytorch "$@"
