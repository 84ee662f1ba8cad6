#!/usr/bin/env bash
#SBATCH --job-name=pyrecover-torch
#SBATCH --nodes=1
#SBATCH --ntasks-per-node=1
#SBATCH --gpus-per-node=1
#SBATCH --time=00:40:00
#
# SLURM launcher for the PyTorch port (one process on one GPU), the
# counterpart of launch/submit_slurm.sh:
#   * computes the job's absolute deadline from the scheduler and exports it
#     as SLURM_JOB_END_TIME, which --timeaware-checkpointing reads to plan
#     the final checkpoint;
#   * wraps the trainer in run_resilient.sh, so a deadline or preemption stop
#     resumes from the latest checkpoint until the run is DONE.
#
# Usage: sbatch pyrecover_tpu_torch/launch/submit_slurm.sh [pyrecover_tpu_torch.train flags...]

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

srun bash "${SCRIPT_DIR}/run_resilient.sh" \
  --timeaware-checkpointing \
  --verify-checkpoints \
  "$@"
