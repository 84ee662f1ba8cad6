"""The port trainer's telemetry stream held to the JAX trainer's, and read by
the JAX package's own tools.

A tiny CPU run of each package with ``--telemetry``, the same config and
steps: a save, a deadline stop, then a ``latest`` resume. The two streams
give the same sequence of event names once the events that depend on timing
are dropped from both (``TIMING``) and the JAX events the port does not emit
are dropped from the JAX stream (``NOT_IN_PORT``, each with its reason).
``run_summary`` carries the same keys. Then the JAX package's
``tools/summarize_telemetry.py`` and ``tools/doctor.py``, run as
subprocesses, read the port's JSONL and experiment directory: the goodput
report carries the port's ``run_summary`` numbers and ``--expect healthy``
exits 0.
"""

import difflib
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from pyrecover_tpu import telemetry as jax_tel
from pyrecover_tpu import train as jax_train
from pyrecover_tpu.config import get_args as jax_args
from pyrecover_tpu.utils import perf as jax_perf
from pyrecover_tpu_torch import telemetry as port_tel
from pyrecover_tpu_torch import train as port_train
from pyrecover_tpu_torch.utils import perf as port_perf

REPO = Path(__file__).resolve().parent.parent

# depend on thread timing, in either package: whether the prefetch queue was
# empty when the step asked (a loader_wait span and a data_stall event), and
# whether a learned duration grew past the watcher's prior (preempt_estimate)
TIMING = {"data_stall", "preempt_estimate", "span_begin:loader_wait", "span_end:loader_wait"}
# JAX events the port does not emit yet, and why
NOT_IN_PORT = {
    # the JAX vanilla save gathers leaves with a device_get per leaf inside a
    # `ckpt_gather` span even when synchronous; the port streams each part's
    # device-to-host copy inside the write (its `ckpt_gather` span is the
    # background snapshot's)
    "span_begin:ckpt_gather", "span_end:ckpt_gather",
    # the JAX restore reads the whole file, then places every leaf
    # (`ckpt_read`, then `ckpt_device_put`); the port reads and places a leaf
    # at a time inside one `ckpt_read` span
    "span_begin:ckpt_device_put", "span_end:ckpt_device_put",
}


def names(stream):
    out = []
    for e in stream:
        key = e["event"]
        if key in ("span_begin", "span_end", "span"):
            key = f"{key}:{e['name']}"
        out.append(key)
    return out


def flags(ckpt_dir):
    # batch 8: one row per device of the JAX package's 8-device CPU mesh
    return ["--batch-size", "8", "--sequence-length", "32", "--model-dim", "32",
            "--model-layers", "1", "--model-heads", "2", "--model-kv-heads", "1",
            "--vocab-size", "64", "--logging-frequency", "1", "--training-samples", "32",
            "--checkpoint-dir", str(ckpt_dir), "--experiment-name", "e",
            "--checkpoint-frequency", "2", "--verify-checkpoints", "--no-async-checkpoint",
            "--telemetry", "--preempt-check-interval", "2",
            # one interval flush (the first sync), whatever the host's speed
            "--metrics-flush-interval", "100000"]


def run_port(ckpt_dir):
    base = flags(ckpt_dir) + ["--device", "cpu", "--attention-impl", "flash"]
    port_train.main(base + ["--training-steps", "4", "--timeaware-checkpointing",
                            "--job-end-time", str(time.time() + 1.0)])
    port_train.main(base + ["--training-steps", "4", "--resume-from-checkpoint", "latest"])
    return port_tel.read_events(Path(ckpt_dir) / "e" / "e_telemetry.jsonl")


def run_jax(ckpt_dir):
    base = flags(ckpt_dir) + ["--attention-impl", "flash"]
    jax_train.train(jax_args(base + ["--training-steps", "4", "--timeaware-checkpointing",
                                     "--job-end-time", str(time.time() + 1.0)]))
    jax_train.train(jax_args(base + ["--training-steps", "4",
                                     "--resume-from-checkpoint", "latest"]))
    return jax_tel.read_events(Path(ckpt_dir) / "e" / "e_telemetry.jsonl")


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setenv("PYRECOVER_PALLAS_INTERPRET", "1")
    mp.delenv("PYRECOVER_FAULT_PLAN", raising=False)
    # process-wide state other tests in this worker may have touched: the
    # once-per-process unknown-peak warning, and the flush clock
    mp.setattr(jax_perf, "_warned_unknown_kinds", set())
    mp.setattr(port_perf, "_warned_unknown", set())
    port_tel.metrics.reset()
    jax_tel.metrics.reset()
    try:
        port_dir = tmp_path_factory.mktemp("port")
        out = {"port": run_port(port_dir), "jax": run_jax(tmp_path_factory.mktemp("jax")),
               "port_dir": port_dir / "e"}
    finally:
        mp.undo()
        torch.set_num_threads(threads)
        port_tel.close()
        jax_tel.close()
    return out


def test_event_sequences_match(streams):
    port = [n for n in names(streams["port"]) if n not in TIMING]
    ref = [n for n in names(streams["jax"]) if n not in TIMING | NOT_IN_PORT]
    assert port == ref, "\n".join(difflib.unified_diff(ref, port, "jax", "port", lineterm=""))
    # both segments: a deadline stop with its final save, then the resume
    assert port.count("run_start") == 2 and port.count("run_summary") == 2
    assert "preempt_stop" in port and "span_begin:resume" in port


def test_run_summaries_have_the_same_keys(streams):
    port = [e for e in streams["port"] if e["event"] == "run_summary"]
    ref = [e for e in streams["jax"] if e["event"] == "run_summary"]
    assert [set(e) for e in port] == [set(e) for e in ref]
    assert [(e["status"], e["step"]) for e in port] == [("stopped_early", 2), ("finished", 4)]
    assert [(e["status"], e["step"]) for e in ref] == [("stopped_early", 2), ("finished", 4)]
    for e in port:
        assert 0.0 < e["goodput_pct"] <= 100.0
        assert e["productive_s"] <= e["wall_s"]


def test_commits_name_the_files_bytes(streams):
    commits = [e for e in streams["port"] if e["event"] == "ckpt_commit"]
    assert len(commits) == 3  # ckpt_2, ckpt_2_final, ckpt_4_final
    for e in commits:
        path = Path(e["path"])
        if path.exists():  # ckpt_2 was pruned by retention? it keeps 3
            assert e["bytes"] == path.stat().st_size


def test_jax_tools_read_the_port_run(streams, tmp_path):
    exp = streams["port_dir"]
    jsonl = exp / "e_telemetry.jsonl"
    out = tmp_path / "summary.json"
    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"}
    summ = subprocess.run([sys.executable, "tools/summarize_telemetry.py", str(jsonl),
                           "--json", str(out)], cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=env)
    assert summ.returncode == 0, summ.stderr
    report = json.loads(out.read_text())
    last = [e for e in streams["port"] if e["event"] == "run_summary"][-1]
    text = summ.stdout
    assert f"finished at step 4 | goodput {last['goodput_pct']:.1f}%" in text
    blob = json.dumps(report)
    assert str(last["goodput_pct"]) in blob
    doc = subprocess.run([sys.executable, "tools/doctor.py", str(exp), "--expect", "healthy"],
                         cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert doc.returncode == 0, doc.stdout + doc.stderr
    assert "doctor: HEALTHY at step 4" in doc.stdout
