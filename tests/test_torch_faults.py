"""The port's fault injection (pyrecover_tpu_torch.resilience.faults) held to
the JAX package's, and each registered seam fired through the real code it
guards.

Plans parse and validate against ``FAULT_SITES`` as in the JAX engine, and
the seeded schedules (``random_sigkill``, ``corrupt_ckpt_bytes``) are the
same in both engines for the same seed. ``SITE_PLANS`` holds one plan per
registered site (faultcheck's FT04 reads these literals as the drill corpus)
and each is run through its seam: the checkpoint writer and reader, the
retention sweep, the loader, the train loop. Last, a kill -9 in the first
save's write, in a trainer subprocess on the CPU: the doctor says ``crash``
in ``ckpt_write``, nothing torn is published, and the ``latest`` resume ends
with the straight run's final checkpoint.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pyrecover_tpu.resilience import faults as jax_faults
from pyrecover_tpu.telemetry import doctor as jax_doctor
from pyrecover_tpu_torch import telemetry as tel
from pyrecover_tpu_torch.checkpoint import registry
from pyrecover_tpu_torch.checkpoint.vanilla import Leaf, load_ckpt_vanilla, save_ckpt_vanilla
from pyrecover_tpu_torch.data import DataLoader, StatefulSampler, SyntheticTextDataset
from pyrecover_tpu_torch.resilience import faults
from pyrecover_tpu_torch.telemetry import doctor

REPO = Path(__file__).resolve().parent.parent

# one plan per registered site (not the save-index counter), each fired below
SITE_PLANS = {
    "train_step": {"type": "sigterm_at_step", "step": 3},
    "ckpt_write": {"type": "transient_io_error", "op": "write", "fail_count": 2},
    "ckpt_fsync": {"type": "transient_io_error", "op": "fsync", "fail_count": 1},
    "ckpt_rename": {"type": "transient_io_error", "op": "rename", "fail_count": 1},
    "ckpt_commit": {"type": "corrupt_ckpt_bytes", "save_index": 2, "count": 16},
    "ckpt_read": {"type": "transient_io_error", "op": "read", "fail_count": 2},
    "ckpt_prune": {"type": "transient_io_error", "op": "prune", "fail_count": 1},
    "loader_batch": {"type": "loader_stall", "seconds": 0.3, "batch": 2},
    # the zerostall engine's sites, fired in tests/test_torch_zerostall.py
    "ckpt_snapshot": {"type": "kill9_during_save", "site": "ckpt_snapshot", "save_index": 2},
    "ckpt_chunk_write": {"type": "transient_io_error", "op": "chunk_write", "fail_count": 2},
    "ckpt_manifest_commit": {"type": "transient_io_error", "op": "manifest_commit",
                             "fail_count": 1},
    "ckpt_gc_unlink": {"type": "transient_io_error", "op": "gc_unlink", "fail_count": 1},
    # the hot-swap fetch's site, fired in tests/test_torch_hotswap.py
    "swap_fetch": {"type": "kill9_during_save", "site": "swap_fetch", "save_index": 0},
    # the fleet's sites, fired in tests/test_torch_fleet*.py
    "replica_kill": {"type": "kill9_during_save", "site": "replica_kill", "save_index": 0,
                     "after_bytes": 3},
    "router_redrive": {"type": "transient_io_error", "op": "redrive", "fail_count": 1},
}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(faults.PLAN_ENV, raising=False)
    monkeypatch.setenv("PYRECOVER_IO_RETRIES", "5")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tel.close()
    tel.metrics.reset()
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()
    tel.close()
    tel.metrics.reset()
    tel.flight.uninstall()
    torch.set_num_threads(threads)


# ---- plans -------------------------------------------------------------------

def test_registry_is_the_jax_one_cut_to_the_port_seams():
    assert set(faults.FAULT_SITES) <= set(jax_faults.FAULT_SITES)
    for site, meta in faults.FAULT_SITES.items():
        assert meta["kind"] == jax_faults.FAULT_SITES[site]["kind"]
    assert set(SITE_PLANS) == {s for s, m in faults.FAULT_SITES.items() if m["kind"] != "counter"}


@pytest.mark.parametrize("plan,match", [
    ({"faults": [{"type": "meteor_strike"}]}, "unknown fault type"),
    ({"faults": [{"type": "transient_io_error", "op": "teleport"}]}, "unknown op"),
    ({"faults": [{"type": "kill9_during_save", "site": "warp_core_breach"}]}, "unknown site"),
    ({"faults": [{"type": "random_sigkill", "rate_per_step": 0.0}]}, "rate_per_step"),
    ({"faults": [{"type": "random_sigkill", "rate_per_step": 0.5, "start_step": 4,
                  "end_step": 2}]}, "end_step"),
    ({"faults": [{"type": "sigterm_at_step"}]}, "bad sigterm_at_step spec"),
    ({"faults": [{"type": "metadata_flap"}]}, "unknown fault type"),
    ([], "JSON object"),
])
def test_bad_plans_fail_loudly(plan, match):
    with pytest.raises(faults.FaultPlanError, match=match):
        faults.FaultEngine(plan)


def test_unknown_site_at_a_seam_raises():
    faults.install({"faults": []})
    with pytest.raises(faults.FaultPlanError, match="unknown site 'warp_core_breach'"):
        faults.check("warp_core_breach")


def test_env_plan_inline_and_file(tmp_path, monkeypatch):
    monkeypatch.setenv(faults.PLAN_ENV, json.dumps({"seed": 3, "faults": []}))
    assert faults.load_env_plan() == {"seed": 3, "faults": []}
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"faults": [SITE_PLANS["ckpt_fsync"]]}))
    monkeypatch.setenv(faults.PLAN_ENV, str(path))
    # the first seam hit resolves the environment once, then rebinds
    monkeypatch.setattr(faults, "check", faults._bootstrap)
    faults.check("ckpt_save_begin")
    assert faults.active() is not None and faults.active().save_index == 1
    monkeypatch.setenv(faults.PLAN_ENV, "{not json")
    with pytest.raises(faults.FaultPlanError, match="not valid JSON"):
        faults.load_env_plan()
    faults.clear()
    assert faults.check is faults._noop and faults.active() is None


@pytest.mark.parametrize("seed", [0, 7, 2024])
def test_random_sigkill_schedule_is_the_jax_engines(seed, monkeypatch):
    spec = {"type": "random_sigkill", "rate_per_step": 0.15, "seed": seed,
            "grace_steps": 2, "start_step": 3, "end_step": 60}
    kills = [0]
    monkeypatch.setattr(os, "kill", lambda pid, sig: kills.__setitem__(0, kills[0] + 1))
    fired = {}
    for name, mod in (("port", faults), ("jax", jax_faults)):
        fired[name] = []
        for start in (1, 10, 25):  # three resume points: three schedules
            engine = mod.FaultEngine({"faults": [dict(spec)]})
            for step in range(start, 61):
                before = kills[0]
                engine.check("train_step", step=step)
                if kills[0] > before:
                    fired[name].append((start, step))
    assert fired["port"] == fired["jax"]
    assert fired["port"]  # the rate fires within the window


@pytest.mark.parametrize("save_index,offset", [(1, None), (2, 5), (3, 10_000)])
def test_corrupt_ckpt_bytes_flips_the_same_bytes(tmp_path, save_index, offset):
    data = np.random.default_rng(0).integers(0, 256, 4096, dtype=np.uint8).tobytes()
    files = {}
    for name, mod in (("port", faults), ("jax", jax_faults)):
        path = tmp_path / f"{name}.ckpt"
        path.write_bytes(data)
        engine = mod.FaultEngine({"faults": [{"type": "corrupt_ckpt_bytes",
                                              "save_index": save_index, "offset": offset,
                                              "count": 64}]})
        for _ in range(3):
            engine.check("ckpt_save_begin")
            engine.check("ckpt_commit", path=str(path))
        files[name] = path.read_bytes()
    assert files["port"] == files["jax"]
    start = {None: len(data) // 2, 5: 5, 10_000: len(data) - 1}[offset]
    flipped = [i for i in range(len(data)) if files["port"][i] != data[i]]
    assert flipped == list(range(start, min(start + 64, len(data))))


# ---- each site through its seam ------------------------------------------------

def leaves(seed=0):
    g = torch.Generator().manual_seed(seed)
    return [Leaf(".params['w']", (3, 64, 64), "float32",
                 [torch.randn(64, 64, generator=g) for _ in range(3)]),
            Leaf(".step", (), "int32", [np.asarray(7, np.int32)])]


def events(sink, name):
    return [e for e in sink.events if e["event"] == name]


@pytest.mark.parametrize("site", ["ckpt_write", "ckpt_fsync", "ckpt_rename"])
def test_transient_write_faults_are_retried_into_the_same_file(tmp_path, site):
    clean = tmp_path / "clean" / "ckpt_1.ckpt"
    save_ckpt_vanilla(clean, leaves(), verify=True)
    sink = tel.add_sink(tel.MemorySink())
    faults.install({"faults": [SITE_PLANS[site]]})
    path = tmp_path / "faulted" / "ckpt_1.ckpt"
    handle = save_ckpt_vanilla(path, leaves(), verify=True)
    assert path.read_bytes() == clean.read_bytes()
    assert handle.bytes == path.stat().st_size
    fired = events(sink, "fault_injected")
    assert {e["site"] for e in fired} == {site}
    retries = events(sink, "ckpt_io_retry")
    assert len(retries) == SITE_PLANS[site]["fail_count"]
    assert {r["op"] for r in retries} == {SITE_PLANS[site]["op"]}
    commit = events(sink, "ckpt_commit")[0]
    assert commit["bytes"] == path.stat().st_size and commit["checksum"] is True
    spans = [e for e in sink.events if e["event"] == "span" and e["name"] == "io_retry"]
    assert spans and tel.metrics.snapshot()["hists"]["io_retry_latency_s"]["count"] >= 1


def test_transient_read_faults_are_retried_on_restore(tmp_path):
    path = tmp_path / "ckpt_1.ckpt"
    save_ckpt_vanilla(path, leaves(), verify=True)
    sink = tel.add_sink(tel.MemorySink())
    faults.install({"faults": [SITE_PLANS["ckpt_read"]]})
    target = leaves(seed=1)
    load_ckpt_vanilla(path, target, verify=True)
    for got, want in zip(target[0].parts, leaves()[0].parts):
        assert torch.equal(got, want)
    assert [e["site"] for e in events(sink, "fault_injected")] == ["ckpt_read"] * 2
    assert [e["op"] for e in events(sink, "ckpt_io_retry")] == ["read"] * 2
    names = [e["event"] for e in sink.events]
    assert names[0] == "ckpt_restore_start" and names[-1] == "ckpt_restore_done"


def test_a_failed_prune_leaves_the_survivors_intact(tmp_path):
    exp = tmp_path / "exp"
    for step in (1, 2):
        save_ckpt_vanilla(exp / f"ckpt_{step}.ckpt", leaves(step), verify=True)
    sink = tel.add_sink(tel.MemorySink())
    faults.install({"faults": [SITE_PLANS["ckpt_prune"]]})
    with pytest.raises(OSError, match="injected fault"):
        save_ckpt_vanilla(exp / "ckpt_3.ckpt", leaves(3), verify=True, max_keep=1)
    # the new file was committed before the sweep; nothing was deleted
    assert [p.name for p in registry.list_checkpoints(exp)] == [
        "ckpt_1.ckpt", "ckpt_2.ckpt", "ckpt_3.ckpt"]
    assert events(sink, "ckpt_commit") and not events(sink, "ckpt_pruned")
    faults.clear()
    removed = registry.prune_checkpoints(exp, 1, engine="vanilla")
    assert [p.name for p in removed] == ["ckpt_1.ckpt", "ckpt_2.ckpt"]
    assert [e["path"] for e in events(sink, "ckpt_pruned")] == ["ckpt_1.ckpt", "ckpt_2.ckpt"]
    assert events(sink, "ckpt_prune")[0]["count"] == 2


def test_loader_stall_is_an_open_loader_wait(tmp_path):
    ds = SyntheticTextDataset(num_samples=16, seq_len=32, vocab_size=64, seed=0)

    def batches():
        sampler = StatefulSampler(dataset_len=len(ds), global_batch_size=2, seed=0)
        loader = DataLoader(ds, sampler, 0, device="cpu", prefetch=2, num_workers=1).start()
        try:
            return [next(loader)[1]["inputs"] for _ in range(4)]
        finally:
            loader.stop()

    want = batches()
    sink = tel.add_sink(tel.MemorySink())
    faults.install({"faults": [SITE_PLANS["loader_batch"]]})
    got = batches()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    fired = events(sink, "fault_injected")
    assert [(e["site"], e["hit"]) for e in fired] == [("loader_batch", 2)]
    waits = [e for e in sink.events if e["event"] == "span_end" and e["name"] == "loader_wait"]
    assert max(e["dur_s"] for e in waits) >= 0.2
    assert max(e["wait_s"] for e in events(sink, "data_stall")) >= 0.2


TINY = ["--device", "cpu", "--batch-size", "2", "--sequence-length", "32", "--model-dim", "32",
        "--model-layers", "1", "--model-heads", "2", "--model-kv-heads", "1",
        "--vocab-size", "64", "--logging-frequency", "1", "--training-samples", "16",
        "--verify-checkpoints", "--no-async-checkpoint", "--telemetry"]


def test_sigterm_at_step_then_corrupt_newest_falls_back(tmp_path):
    """train_step: SIGTERM as step 3 begins stops the run with a final
    checkpoint at 3 and REQUEUE. ckpt_commit: the resumed run's second save
    (its final) is flipped after its commit; the next `latest` resume
    pre-check fails it, quarantines it and restores the one before."""
    from pyrecover_tpu_torch import train

    argv = TINY + ["--checkpoint-dir", str(tmp_path), "--checkpoint-frequency", "2"]
    faults.install({"faults": [SITE_PLANS["train_step"]]})
    out = train.main(argv + ["--training-steps", "6", "--timeaware-checkpointing"])
    assert out["stopped_early"] and out["end_step"] == 3
    exp = tmp_path / "default-exp"
    assert (exp / "REQUEUE").exists() and (exp / "ckpt_3_final.ckpt").exists()
    faults.install({"faults": [SITE_PLANS["ckpt_commit"]]})
    out = train.main(argv + ["--training-steps", "6", "--resume-from-checkpoint", "latest"])
    assert out["start_step"] == 3 and out["end_step"] == 6
    faults.clear()
    out = train.main(argv + ["--training-steps", "6", "--resume-from-checkpoint", "latest"])
    assert out["start_step"] == 4  # ckpt_6_final was corrupt: fell back to ckpt_4
    stream = tel.read_events(exp / "default-exp_telemetry.jsonl")
    names = [e["event"] for e in stream]
    assert "fault_injected" in names
    i = names.index("ckpt_precheck_failed")
    assert names[i + 1] == "ckpt_quarantined" and "resume" in names[i:]
    assert stream[i]["reason"] == "checksum mismatch"
    assert (exp / ".corrupt" / "ckpt_6_final.ckpt").exists()
    sigterm = [e for e in stream if e["event"] == "fault_injected"
               and e["type"] == "sigterm_at_step"]
    assert sigterm[0]["step"] == 3
    assert doctor.diagnose(exp)["classification"] == "healthy"


def _trainer(tmp, *extra, plan=None):
    env = {k: v for k, v in os.environ.items() if k != faults.PLAN_ENV}
    env["OMP_NUM_THREADS"] = "1"
    if plan is not None:
        env[faults.PLAN_ENV] = json.dumps(plan)
    cmd = [sys.executable, "-m", "pyrecover_tpu_torch.train", *TINY, "--checkpoint-dir",
           str(tmp), "--checkpoint-frequency", "2", "--training-steps", "4", *extra]
    return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_kill9_during_save_subprocess_drill(tmp_path):
    straight = _trainer(tmp_path / "a")
    assert straight.returncode == 0, straight.stderr[-3000:]
    want = (tmp_path / "a" / "default-exp" / "ckpt_4_final.ckpt.sha256").read_text()

    exp = tmp_path / "b" / "default-exp"
    kill = {"faults": [{"type": "kill9_during_save", "save_index": 1, "after_bytes": 4096}]}
    killed = _trainer(tmp_path / "b", plan=kill)
    assert killed.returncode == -signal.SIGKILL
    assert registry.list_checkpoints(exp) == []  # nothing torn was published
    for rep in (doctor.diagnose(exp), jax_doctor.diagnose(exp)):
        assert rep["classification"] == "crash" and rep["phase"] == "ckpt_write"
    stream = tel.read_events(exp / "default-exp_telemetry.jsonl")
    assert stream[-1]["event"] == "fault_injected" and stream[-1]["site"] == "ckpt_write"

    resumed = _trainer(tmp_path / "b", "--resume-from-checkpoint", "latest")
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    assert (exp / "ckpt_4_final.ckpt.sha256").read_text() == want
    assert doctor.diagnose(exp)["classification"] == "healthy"
