"""The port's profile window (``--profile``), the counterpart of the JAX
trainer's: ``torch.profiler`` runs from the end of step
``--profile-step-start`` to the end of step ``--profile-step-end`` and
leaves a Chrome trace under ``--profile-dir``. On the CPU it records CPU
activity only; the card adds CUDA activity, the cudaProfilerStart/Stop
range and NVTX step ranges (``chip_smoke.py``'s trainer phase checks
those there)."""

import json

import torch

from pyrecover_tpu_torch import train as port_train
from pyrecover_tpu_torch.config import get_args

TINY = ["--device", "cpu", "--batch-size", "2", "--sequence-length", "32",
        "--model-dim", "64", "--model-layers", "2", "--model-heads", "4",
        "--model-kv-heads", "2", "--vocab-size", "128", "--attention-impl", "flash",
        "--logging-frequency", "1", "--checkpoint-frequency", "0"]


def test_profile_window_writes_a_trace_of_its_steps(tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = port_train.main(TINY + [
            "--training-steps", "5", "--checkpoint-dir", str(tmp_path / "ck"), "--profile",
            "--profile-dir", str(tmp_path / "prof"), "--profile-step-start", "2",
            "--profile-step-end", "4"])
    finally:
        torch.set_num_threads(threads)
    trace = tmp_path / "prof" / "trace_steps_3-4.json"
    assert out["profile_trace"] == str(trace) and trace.exists()
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"step 3", "step 4"} <= names and "step 2" not in names and "step 5" not in names
    assert len(out["losses"]) == 5


def test_profile_flags_follow_jax():
    from pyrecover_tpu.config import get_args as jax_get_args

    argv = ["--profile", "--profile-dir", "p/", "--profile-step-start", "3",
            "--profile-step-end", "9"]
    for got, want in ((get_args(argv), jax_get_args(argv)), (get_args([]), jax_get_args([]))):
        for name in ("profile", "profile_dir", "profile_step_start", "profile_step_end",
                     "eval_frequency", "eval_samples", "eval_dataset"):
            assert getattr(got, name) == getattr(want, name), name
    # accepted for parity, as the JAX parser accepts them
    get_args(["--fused-optimizer", "--compile", "--remat", "--remat-policy", "save-attn"])
    jax_get_args(["--fused-optimizer", "--compile", "--remat", "--remat-policy", "save-attn"])
    cfg = get_args(["--remat", "--remat-policy", "save-attn"])
    assert cfg.model.remat and cfg.model.remat_policy == "save-attn"
