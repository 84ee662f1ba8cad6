"""The port's launchers (pyrecover_tpu_torch/launch/), tested as
tests/test_launcher.py tests the JAX package's: run_resilient.sh finishes a
normal run with DONE and carries a preemption -> REQUEUE -> resume cycle
through to DONE; submit_slurm.sh exports the job's deadline as
SLURM_JOB_END_TIME before it starts the trainer. Every trainer runs on the
CPU (``--device cpu``) at a tiny size."""

import os
import stat
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
LAUNCH = REPO / "pyrecover_tpu_torch" / "launch"

BASE_FLAGS = [
    "--device", "cpu", "--sequence-length", "32", "--batch-size", "4",
    "--training-samples", "32", "--model-dim", "64", "--model-layers", "2",
    "--model-heads", "4", "--model-kv-heads", "2", "--vocab-size", "128",
    "--logging-frequency", "100", "--checkpoint-frequency", "4", "--learning-rate", "1e-3",
]


def run_env():
    env = dict(os.environ)
    env["PYTHON"] = sys.executable
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["MAX_RESTARTS"] = "5"
    env["OMP_NUM_THREADS"] = "1"
    env.pop("PYRECOVER_PREEMPT_FILE", None)
    return env


def test_resilient_normal_completion(tmp_path):
    proc = subprocess.run(
        ["bash", str(LAUNCH / "run_resilient.sh"), "--checkpoint-dir", str(tmp_path),
         "--experiment-name", "launch", "--training-steps", "4", *BASE_FLAGS],
        env=run_env(), capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert (tmp_path / "launch" / "DONE").exists()
    assert (tmp_path / "launch" / "ckpt_4_final.ckpt").exists()
    assert proc.stdout.count("[run_resilient] attempt") == 1


def test_resilient_preempt_resume_cycle(tmp_path):
    """Notice file present: run 1 stops early with a _final checkpoint and
    REQUEUE; the wrapper restarts with --resume-from-checkpoint latest; once
    the notice clears, the resumed run completes to DONE."""
    notice = tmp_path / "preempt-notice"
    notice.write_text("evict")  # preemption already signalled at launch
    env = run_env()
    env["PYRECOVER_PREEMPT_FILE"] = str(notice)
    proc = subprocess.Popen(
        ["bash", str(LAUNCH / "run_resilient.sh"), "--checkpoint-dir", str(tmp_path),
         "--experiment-name", "launch", "--training-steps", "8",
         "--timeaware-checkpointing", *BASE_FLAGS],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
    )
    exp = tmp_path / "launch"
    try:
        deadline = time.time() + 90
        while time.time() < deadline and not (exp / "REQUEUE").exists():
            if proc.poll() is not None:
                break
            time.sleep(0.2)
        assert (exp / "REQUEUE").exists(), "first run never wrote REQUEUE"
        assert list(exp.glob("ckpt_*_final.ckpt")), "no final checkpoint saved"
        notice.unlink()  # the platform says the eviction is over
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-3000:]
    assert (exp / "DONE").exists() and not (exp / "REQUEUE").exists()
    assert "graceful early stop detected" in out
    assert "resume: --resume-from-checkpoint latest" in out
    assert (exp / "ckpt_8_final.ckpt").exists()


def _fake(bin_dir, name, body):
    path = bin_dir / name
    path.write_text("#!/usr/bin/env bash\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)


def test_slurm_script_exports_the_job_end_time(tmp_path):
    """Under a (stand-in) scheduler: the end time squeue reports becomes
    SLURM_JOB_END_TIME in the environment of the srun step, which runs the
    port's resilient loop to DONE with the time-aware stop and verified
    checkpoints on."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    end_iso = "2099-01-02T03:04:05"
    _fake(bin_dir, "squeue", f'echo "{end_iso}"\n')
    seen = tmp_path / "srun_env"
    _fake(bin_dir, "srun", f'echo "$SLURM_JOB_END_TIME $*" > "{seen}"\nexec "$@"\n')
    env = run_env()
    env["PATH"] = f"{bin_dir}{os.pathsep}{env['PATH']}"
    env["SLURM_JOB_ID"] = "12345"
    proc = subprocess.run(
        ["bash", str(LAUNCH / "submit_slurm.sh"), "--checkpoint-dir", str(tmp_path),
         "--experiment-name", "slurm", "--training-steps", "2", *BASE_FLAGS],
        env=env, capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = subprocess.run(["date", "-d", end_iso, "+%s"], capture_output=True,
                          text=True, check=True).stdout.strip()
    end_time, argv = seen.read_text().split(" ", 1)
    assert end_time == want
    assert f"Job deadline: {end_iso} (epoch {want})" in proc.stdout
    assert "run_resilient.sh --timeaware-checkpointing --verify-checkpoints" in argv
    exp = tmp_path / "slurm"
    assert (exp / "DONE").exists()
    assert (exp / "ckpt_2_final.ckpt.sha256").exists()
