#!/usr/bin/env bash
# Multi-process engine launcher of the PyTorch port: the counterpart of
# scripts/launch_multihost.sh, with the same arguments.
#
# Every process runs the SAME engine daemon (particle_simulator_tpu_torch);
# parallel/multihost.py joins them into one torch.distributed group and
# parallel/domain.py shards the bucket grid over the global mesh, each
# process holding its own shards. The ring cells between processes move by
# point-to-point sends: NCCL when every process has a card of its own, gloo
# staged through host memory when processes share a card (or run on the
# CPU). Process 0 owns the editor TCP connection.
#
# Usage - one invocation per process (ssh, sbatch task, or container):
#   scripts/torch_launch_multihost.sh <coordinator-host:port> <num_processes> <process_id> \
#       [extra daemon args...]
# Later daemon arguments win: `... --devices 4` gives the global mesh 4
# shards (a multiple of the process count; the default is one a process).
#
# Two processes sharing one card (gloo, host-staged ring):
#   scripts/torch_launch_multihost.sh 127.0.0.1:29511 2 0 --addr 127.0.0.1:53123 &
#   scripts/torch_launch_multihost.sh 127.0.0.1:29511 2 1 --addr 127.0.0.1:53123
#
# One process per card under torchrun (NCCL), on a host with 4 cards:
#   PS_TPU_DISTRIBUTED=1 torchrun --nproc-per-node 4 \
#       -m particle_simulator_tpu_torch.engine.daemon --devices all --addr 127.0.0.1:53123
#
# PYTHON names the interpreter (default: python3).

set -euo pipefail

if [ $# -lt 3 ]; then
    sed -n '2,27p' "$0" | sed 's/^# \{0,1\}//'
    exit 2
fi

COORD=$1
NUM=$2
ID=$3
shift 3

export PS_TPU_COORDINATOR="$COORD"
export PS_TPU_NUM_PROCESSES="$NUM"
export PS_TPU_PROCESS_ID="$ID"

exec "${PYTHON:-python3}" -m particle_simulator_tpu_torch.engine.daemon --devices all "$@"
