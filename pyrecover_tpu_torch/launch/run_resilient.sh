#!/usr/bin/env bash
# Resilient training loop for the PyTorch port: run -> (stopped early?
# resume) -> ... -> done. The port's counterpart of launch/run_resilient.sh.
#
# The trainer publishes its exit intent as a marker file in
# <checkpoint-dir>/<experiment> (REQUEUE = stopped early for a deadline or a
# preemption, DONE = finished; pyrecover_tpu_torch/preempt.py), and this
# wrapper restarts `python -m pyrecover_tpu_torch.train` with
# --resume-from-checkpoint latest until DONE.
#
# Usage:
#   pyrecover_tpu_torch/launch/run_resilient.sh --experiment-name myrun \
#       --checkpoint-dir ckpts [any pyrecover_tpu_torch.train flags...]
#
# Env:
#   MAX_RESTARTS   (default 100)  safety bound on restart count
#   PYTHON         (default python3)
#   LAUNCH         (default $PYTHON) what runs `-m pyrecover_tpu_torch.train`:
#                  launch_multinode.sh sets it to torch.distributed.run

set -euo pipefail

PYTHON="${PYTHON:-python3}"
MAX_RESTARTS="${MAX_RESTARTS:-100}"
read -ra LAUNCHER <<< "${LAUNCH:-$PYTHON}"

# recover --checkpoint-dir/--experiment-name from the args (defaults match
# pyrecover_tpu_torch/config.py)
CKPT_DIR="checkpoints"
EXP_NAME="default-exp"
args=("$@")
for ((i = 0; i < ${#args[@]}; i++)); do
  case "${args[$i]}" in
    --checkpoint-dir)    CKPT_DIR="${args[$((i + 1))]}" ;;
    --checkpoint-dir=*)  CKPT_DIR="${args[$i]#*=}" ;;
    --experiment_name|--experiment-name)   EXP_NAME="${args[$((i + 1))]}" ;;
    --experiment_name=*|--experiment-name=*) EXP_NAME="${args[$i]#*=}" ;;
  esac
done
EXP_DIR="${CKPT_DIR}/${EXP_NAME}"

restart=0
resume_args=()
while true; do
  echo "[run_resilient] attempt $((restart + 1)) (resume: ${resume_args[*]:-no})"
  rc=0
  "${LAUNCHER[@]}" -m pyrecover_tpu_torch.train "$@" "${resume_args[@]}" || rc=$?

  if [[ -f "${EXP_DIR}/DONE" ]]; then
    echo "[run_resilient] training finished."
    exit 0
  fi

  restart=$((restart + 1))
  if (( restart >= MAX_RESTARTS )); then
    echo "[run_resilient] giving up after ${restart} restarts (rc=${rc})." >&2
    exit 1
  fi

  if [[ -f "${EXP_DIR}/REQUEUE" ]]; then
    echo "[run_resilient] graceful early stop detected → resuming from latest."
  else
    echo "[run_resilient] abnormal exit (rc=${rc}) → resuming from latest after backoff."
    sleep "$((5 * restart > 60 ? 60 : 5 * restart))"
  fi
  resume_args=(--resume-from-checkpoint latest)
done
