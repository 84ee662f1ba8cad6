#!/usr/bin/env bash
#SBATCH --job-name=pyrecover-torch
#SBATCH --nodes=1
#SBATCH --ntasks-per-node=1
#SBATCH --gpus-per-node=1
#SBATCH --time=00:40:00
#
# SLURM launcher for the PyTorch port, the counterpart of
# launch/submit_slurm.sh. One process on one GPU by default; with more nodes
# (--nodes) or GPUs a node (NPROC_PER_NODE, else SLURM_GPUS_ON_NODE), srun
# starts launch_multinode.sh once on every node, with MASTER_ADDR the job's
# first node (from the node list) and MASTER_PORT 29500 unless set, and
# each node's torchrun-style rendezvous starts its ranks. It
#   * computes the job's absolute deadline from the scheduler and exports it
#     as SLURM_JOB_END_TIME, which --timeaware-checkpointing reads to plan
#     the final checkpoint;
#   * wraps the trainer in run_resilient.sh, so a deadline or preemption stop
#     resumes from the latest checkpoint until the run is DONE.
#
# Usage: sbatch pyrecover_tpu_torch/launch/submit_slurm.sh [pyrecover_tpu_torch.train flags...]
#        sbatch --nodes 2 --gpus-per-node 8 pyrecover_tpu_torch/launch/submit_slurm.sh --dp 16 ...

set -euo pipefail

# ---- absolute deadline from the SLURM time limit -------------------------
if [[ -n "${SLURM_JOB_ID:-}" ]] && command -v squeue >/dev/null 2>&1; then
  # end time straight from the scheduler (robust to requeues/extensions)
  END_ISO=$(squeue -h -j "$SLURM_JOB_ID" -o "%e")
  if [[ -n "$END_ISO" && "$END_ISO" != "N/A" ]]; then
    export SLURM_JOB_END_TIME=$(date -d "$END_ISO" +%s)
    echo "Job deadline: $END_ISO (epoch $SLURM_JOB_END_TIME)"
  fi
fi

SCRIPT_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"

NNODES="${SLURM_NNODES:-1}"
NPROC_PER_NODE="${NPROC_PER_NODE:-${SLURM_GPUS_ON_NODE:-1}}"
if (( NNODES * NPROC_PER_NODE > 1 )); then
  MASTER_ADDR="${MASTER_ADDR:-$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n 1)}"
  export MASTER_ADDR MASTER_PORT="${MASTER_PORT:-29500}" NPROC_PER_NODE
  echo "Rendezvous: ${NNODES} node(s) x ${NPROC_PER_NODE} at ${MASTER_ADDR}:${MASTER_PORT}"
  srun --nodes="$NNODES" --ntasks-per-node=1 bash "${SCRIPT_DIR}/launch_multinode.sh" \
    --timeaware-checkpointing \
    --verify-checkpoints \
    "$@"
else
  srun bash "${SCRIPT_DIR}/run_resilient.sh" \
    --timeaware-checkpointing \
    --verify-checkpoints \
    "$@"
fi
