#!/usr/bin/env bash
# Multi-node launcher for the PyTorch port: one torchrun-style rendezvous per
# node, NPROC_PER_NODE processes (one per GPU) on each, all NNODES nodes
# meeting at MASTER_ADDR:MASTER_PORT. The counterpart of
# launch/launch_tpu_pod.sh: the same command starts on every node (by hand,
# or under `srun --ntasks-per-node=1` from submit_slurm.sh), and each node's
# torch.distributed.run starts its ranks with RANK, WORLD_SIZE, LOCAL_RANK,
# MASTER_ADDR and MASTER_PORT set, which `--distributed` requires
# (pyrecover_tpu_torch/parallel/mesh.py). Each node loops in
# run_resilient.sh, so a deadline or preemption stop (REQUEUE, written by
# host 0 in the shared checkpoint directory) resumes from `latest` until
# DONE.
#
# Usage, on every node:
#   NNODES=2 NODE_RANK=<0|1> NPROC_PER_NODE=8 MASTER_ADDR=<node 0> \
#     pyrecover_tpu_torch/launch/launch_multinode.sh --dp 16 \
#       --checkpoint-dir /shared/ckpts --experiment-name myrun [trainer flags...]
#
# Env (SLURM's names are read when these are unset):
#   NNODES          (SLURM_NNODES, default 1)
#   NODE_RANK       (SLURM_NODEID, default 0)
#   NPROC_PER_NODE  (default 1)
#   MASTER_ADDR     (default 127.0.0.1)   MASTER_PORT (default 29500)
#   PYTHON          (default python3)

set -euo pipefail
SCRIPT_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"

PYTHON="${PYTHON:-python3}"
NNODES="${NNODES:-${SLURM_NNODES:-1}}"
NODE_RANK="${NODE_RANK:-${SLURM_NODEID:-0}}"
NPROC_PER_NODE="${NPROC_PER_NODE:-1}"
MASTER_ADDR="${MASTER_ADDR:-127.0.0.1}"
MASTER_PORT="${MASTER_PORT:-29500}"

echo "[launch_multinode] node ${NODE_RANK} of ${NNODES}, ${NPROC_PER_NODE} process(es)," \
     "rendezvous at ${MASTER_ADDR}:${MASTER_PORT}"
# run_resilient.sh starts `$LAUNCH -m pyrecover_tpu_torch.train ...`
export LAUNCH="${PYTHON} -m torch.distributed.run --nnodes ${NNODES} \
--nproc-per-node ${NPROC_PER_NODE} --node-rank ${NODE_RANK} \
--master-addr ${MASTER_ADDR} --master-port ${MASTER_PORT}"
exec bash "${SCRIPT_DIR}/run_resilient.sh" --distributed "$@"
