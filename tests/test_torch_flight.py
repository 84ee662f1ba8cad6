"""The port's failure-time half (flight recorder, watchdog, detectors and
doctor) held to the JAX package's.

Each classification is produced by the port's own producers (the flight
recorder's bundles, the watchdog, the detectors, spans through a
``JsonlSink``), then read by both packages' doctors: class, phase and exit
code must agree. Also: the bundle layout (atomic, the environment filtered
to the port's prefixes, torch platform facts without initialising CUDA),
the chained exception hooks, one bundle per stall, and the CLI.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from pyrecover_tpu.telemetry import doctor as jax_doctor
from pyrecover_tpu.telemetry import flight as jax_flight
from pyrecover_tpu_torch import telemetry as tel
from pyrecover_tpu_torch.telemetry import detectors, doctor, flight, watchdog

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tel.close()
    tel.metrics.reset()
    detectors.reset_hbm()
    yield
    flight.uninstall()
    tel.close()
    tel.metrics.reset()
    detectors.reset_hbm()
    torch.set_num_threads(threads)


def start_run(exp, *, recorder=True):
    """The trainer's opening: the flight recorder, the JSONL sink, run_start."""
    if recorder:
        flight.install(exp, config={"experiment_name": exp.name}, enable_faulthandler=False)
    tel.add_sink(tel.JsonlSink(exp / f"{exp.name}_telemetry.jsonl", append=False))
    tel.emit("run_start", devices=1, device_kind="cpu", processes=1)


def end_run(status="finished", step=8, **extra):
    tel.emit("run_summary", status=status, step=step, **extra)
    tel.close()
    flight.uninstall()


def healthy(exp):
    start_run(exp)
    tel.emit("step_time", step=1, data_wait_s=0.0, dispatch_s=0.01)
    end_run()


def hang_in_loader_wait(exp):
    start_run(exp)
    wd = watchdog.Watchdog(0.3, interval_s=0.05).start()
    watchdog.beat("train_loop")
    wait = tel.spans.begin("loader_wait", batch=3)
    deadline = time.monotonic() + 10
    while wd.hang_count == 0 and time.monotonic() < deadline:
        time.sleep(0.05)
    wd.stop()
    wait.end()
    end_run()  # the stall resolved; the run finished anyway


def crash_with_exception(exp):
    start_run(exp)
    try:
        raise RuntimeError("the dataset went away")
    except RuntimeError:
        flight.dump("unhandled_exception", exc=sys.exc_info())
    end_run(status="error", step=3)


def hard_kill_mid_write(exp):
    start_run(exp, recorder=False)
    save = tel.spans.begin("ckpt_save", step=2, final=False, engine="vanilla")
    write = tel.spans.begin("ckpt_write", engine="vanilla", path="ckpt_2.ckpt")
    tel.close()  # SIGKILL: no run_summary follows
    write.end()  # off the record: only this thread's span stack is unwound
    save.end()


def preemption(exp):
    start_run(exp)
    tel.emit("preempt_stop", step=2, reason="preemption notice received")
    end_run(status="stopped_early", step=2)


def oom(exp):
    start_run(exp)
    try:
        raise torch.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 20.00 GiB. GPU 0 has a total "
            "capacity of 79.19 GiB of which 3.12 GiB is free.")
    except torch.OutOfMemoryError:
        flight.dump("unhandled_exception", exc=sys.exc_info())
    end_run(status="error", step=0)


def platform_fallback(exp):
    start_run(exp)
    os.environ[detectors.EXPECT_ACCELERATOR_ENV] = "1"
    try:
        assert detectors.check_expected_accelerator("cpu")
        assert detectors.check_expected_accelerator("cuda") is None
    finally:
        del os.environ[detectors.EXPECT_ACCELERATOR_ENV]
    end_run()


def recompile_storm(exp):
    start_run(exp)
    watch = detectors.RecompileWatch(lambda batch: batch["inputs"].sum(), name="train_step")
    for s in (8, 16, 8, 32, 32):
        watch({"inputs": torch.zeros(2, s, dtype=torch.long)})
    assert watch.recompiles == 3
    end_run()


def unknown(exp):
    exp.mkdir(parents=True)


SCENARIOS = {
    "healthy": (healthy, "healthy", None),
    "hang": (hang_in_loader_wait, "hang", "loader_wait"),
    "crash": (crash_with_exception, "crash", None),
    "crash-hard-kill": (hard_kill_mid_write, "crash", "ckpt_write"),
    "preemption": (preemption, "preemption", None),
    "oom": (oom, "oom", None),
    "platform_fallback": (platform_fallback, "platform_fallback", None),
    "recompile_storm": (recompile_storm, "recompile_storm", None),
    "unknown": (unknown, "unknown", None),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_both_doctors_classify_port_artifacts_alike(tmp_path, name):
    make, want_class, want_phase = SCENARIOS[name]
    exp = tmp_path / "exp"
    make(exp)
    port, ref = doctor.diagnose(exp), jax_doctor.diagnose(exp)
    assert port["classification"] == want_class, port
    assert port["phase"] == want_phase
    for key in ("classification", "phase", "phase_stack", "detail", "last_step"):
        assert port[key] == ref[key], key
    assert doctor.exit_code(port) == jax_doctor.exit_code(ref)
    # a single bundle, the .postmortem dir and the bare JSONL read alike
    for b in flight.list_bundles(exp):
        assert doctor.diagnose(b)["classification"] == jax_doctor.diagnose(b)["classification"]


def test_bundle_layout_env_filter_and_platform(tmp_path, monkeypatch):
    monkeypatch.setenv("PYRECOVER_FAULT_PLAN", "{}")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv("NCCL_DEBUG", "INFO")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("MY_SECRET_TOKEN", "hunter2")
    rec = flight.install(tmp_path, config={"batch_size": 2}, enable_faulthandler=False)
    tel.add_sink(tel.MemorySink())
    tel.emit("ckpt_saved", step=4, path="ckpt_4.ckpt", final=False)
    evaluation = tel.spans.begin("eval", step=5)
    path = flight.dump("manual", note="x")
    evaluation.end()
    assert path is not None and path.parent.name == ".postmortem"
    names = sorted(p.name for p in path.iterdir())
    assert names == ["MANIFEST.json", "config.json", "env.json", "events.jsonl",
                     "open_spans.json", "stacks.txt"]
    man = json.loads((path / "MANIFEST.json").read_text())
    assert man["reason"] == "manual" and man["note"] == "x"
    assert man["last_step"] == 5 and man["last_checkpoint"]["path"] == "ckpt_4.ckpt"
    assert man["platform"]["torch_version"] == torch.__version__
    assert man["platform"]["backend"] == "cpu"
    assert not torch.cuda.is_initialized()  # the dump brought no card up
    env = json.loads((path / "env.json").read_text())
    assert env["PYRECOVER_FAULT_PLAN"] == "{}" and env["CUDA_VISIBLE_DEVICES"] == "0"
    assert env["NCCL_DEBUG"] == "INFO"
    assert "MY_SECRET_TOKEN" not in env and "JAX_PLATFORMS" not in env
    assert json.loads((path / "config.json").read_text()) == {"batch_size": 2}
    assert [s["name"] for s in json.loads((path / "open_spans.json").read_text())] == ["eval"]
    assert "test_bundle_layout_env_filter_and_platform" in (path / "stacks.txt").read_text()
    # no staging directory is left behind, and both packages list the bundle
    assert not [p for p in path.parent.iterdir() if p.name.startswith(".tmp_")]
    assert flight.list_bundles(tmp_path) == jax_flight.list_bundles(tmp_path) == [path]
    assert rec is flight.active()


def test_exception_hooks_chain_and_dump(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(sys, "excepthook", lambda *a: calls.append("sys"))
    monkeypatch.setattr(threading, "excepthook", lambda args: calls.append("thread"))
    flight.install(tmp_path, enable_faulthandler=False)
    try:
        raise KeyError("lost")
    except KeyError:
        sys.excepthook(*sys.exc_info())
    t = threading.Thread(target=lambda: 1 / 0)
    t.start()
    t.join()
    assert calls == ["sys", "thread"]
    reasons = [json.loads((b / "MANIFEST.json").read_text())["reason"]
               for b in flight.list_bundles(tmp_path)]
    assert reasons == ["unhandled_exception", "thread_exception"]
    flight.uninstall()
    assert calls and sys.excepthook is not flight.FlightRecorder._excepthook


def test_faulthandler_file_is_removed_when_nothing_was_fatal(tmp_path):
    flight.install(tmp_path)
    assert (tmp_path / ".postmortem" / flight.FATAL_STACKS_NAME).exists()
    flight.uninstall()
    assert not (tmp_path / ".postmortem").exists()


def test_watchdog_fires_once_per_stall_and_rearms(tmp_path):
    sink = tel.add_sink(tel.MemorySink())
    flight.install(tmp_path, enable_faulthandler=False)
    wd = watchdog.Watchdog(0.2, interval_s=0.02).start()
    try:
        for _ in range(2):
            count = wd.hang_count
            deadline = time.monotonic() + 10
            while wd.hang_count == count and time.monotonic() < deadline:
                time.sleep(0.02)
            time.sleep(0.3)  # the same stall: no second report
            assert wd.hang_count == count + 1
            watchdog.beat("train_loop")  # progress resumes, the watchdog re-arms
            time.sleep(0.05)
    finally:
        wd.stop()
    hangs = [e for e in sink.events if e["event"] == "hang_detected"]
    assert len(hangs) == 2 and hangs[1]["sources"].keys() == {"train_loop"}
    assert len(flight.list_bundles(tmp_path)) == 2
    watchdog.beat("loader")  # no watchdog installed: a no-op


def test_transfer_watch_turns_a_sync_into_a_typed_error():
    sink = tel.add_sink(tel.MemorySink())
    with detectors.transfer_watch(step=3, device="cpu"):
        pass  # nothing to hold on the CPU
    with pytest.raises(detectors.ImplicitTransferError):
        with detectors.transfer_watch(step=3, device="cpu"):
            raise RuntimeError("called a synchronizing CUDA operation")
    with pytest.raises(RuntimeError, match="other"):
        with detectors.transfer_watch(step=4, device="cpu"):
            raise RuntimeError("other")
    assert [e["event"] for e in sink.events] == ["implicit_transfer"]
    assert sink.events[0]["step"] == 3
    assert tel.metrics.snapshot()["counters"]["implicit_transfer_total"] == 1


def test_transfer_watch_scopes_the_process_wide_mode(monkeypatch):
    """CUDA's sync-debug mode is process-wide: nested scopes hold it by
    count and put the caller's mode back when the outer one ends."""
    modes = ["default"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(detectors, "_set_sync_mode", modes.append)
    with detectors.transfer_watch(device="cuda"):
        assert modes[-1] == "error"
        with detectors.transfer_watch(device="cuda", warn=True):
            assert modes[-1] == "error"
        assert modes[-1] == "error"
    assert modes == ["default", "error", "default"]
    with detectors.transfer_watch(device="cuda", warn=True):
        assert modes[-1] == "warn"
    assert modes[-1] == "default"


def test_device_memory_summary(monkeypatch):
    assert detectors.sample_hbm("cpu") is None
    assert detectors.hbm_run_summary() == {}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    stats = {"allocated_bytes": {"all": {"current": 30 * 2**30, "peak": 60 * 2**30}}}
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", lambda device: stats)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device: (0, 80 * 2**30))
    assert detectors.sample_hbm() == 30 * 2**30
    assert detectors.hbm_run_summary() == {
        "hbm_peak_bytes": 60 * 2**30, "hbm_budget_bytes": 80 * 2**30, "hbm_peak_pct": 75.0}
    gauges = tel.metrics.snapshot()["gauges"]
    assert gauges["hbm_peak_bytes_in_use"] == 60 * 2**30


def test_probe_accelerator_reports_no_device_here():
    ok, reason = detectors.probe_accelerator(timeout_s=120, retries=0)
    if torch.cuda.is_available():
        assert ok and reason is None
    else:
        assert not ok and "no CUDA device" in reason


def test_oom_pattern_and_tables_are_the_reference_ones():
    assert doctor._OOM_RE.pattern == jax_doctor._OOM_RE.pattern
    assert doctor.CLASSES == jax_doctor.CLASSES
    for text in ("OutOfMemoryError: CUDA out of memory. Tried to allocate 2.00 GiB",
                 "RuntimeError: CUDA error: out of memory"):
        assert doctor._OOM_RE.search(text)
    assert set(doctor.EVENT_DEPS) <= set(jax_doctor.EVENT_DEPS)


def test_doctor_cli_expect_and_json(tmp_path):
    exp = tmp_path / "exp"
    healthy(exp)
    cmd = [sys.executable, "-m", "pyrecover_tpu_torch.telemetry.doctor", str(exp)]
    out = tmp_path / "report.json"
    ok = subprocess.run(cmd + ["--expect", "healthy", "--json", str(out)], cwd=REPO,
                        capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0, ok.stderr
    assert "doctor: HEALTHY" in ok.stdout
    assert json.loads(out.read_text())["classification"] == "healthy"
    bad = subprocess.run(cmd + ["--expect", "hang"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert bad.returncode == 3 and "expected classification 'hang'" in bad.stderr
    none = subprocess.run(cmd[:-1] + [str(tmp_path / "empty")], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert none.returncode == 2


def test_a_hung_step_shows_as_silence_at_the_next_host_sync(tmp_path, monkeypatch):
    """A kernel that never returns has no heartbeat of its own: the host runs
    on to its next sync (the loss's ``.item()`` at a logging point), which
    blocks. Here the third step's loss blocks in ``.item()`` for longer than
    the watchdog's window: the hang bundle's stacks show the main thread in
    the trainer's sync point, and the doctor says ``hang``."""
    from pyrecover_tpu_torch import train

    class SlowLoss:
        def __init__(self, value):
            self.value = value

        def item(self):
            time.sleep(2.0)  # the device still running a hung kernel
            return self.value.item()

    make = train.make_train_step

    def make_slow(*a, **k):
        step = make(*a, **k)
        calls = [0]

        def slow(batch):
            out = step(batch)
            calls[0] += 1
            if calls[0] == 3:
                out["loss"] = SlowLoss(out["loss"])
            return out

        return slow

    monkeypatch.setattr(train, "make_train_step", make_slow)
    train.main(["--device", "cpu", "--batch-size", "2", "--sequence-length", "32",
                "--model-dim", "32", "--model-layers", "1", "--model-heads", "2",
                "--model-kv-heads", "1", "--vocab-size", "64", "--training-steps", "4",
                "--logging-frequency", "1", "--checkpoint-frequency", "0",
                "--checkpoint-dir", str(tmp_path), "--experiment-name", "e", "--telemetry",
                "--hang-watchdog-timeout", "0.5"])
    exp = tmp_path / "e"
    bundles = flight.list_bundles(exp)
    assert bundles
    stacks = (bundles[0] / "stacks.txt").read_text()
    main = stacks[stacks.index("--- thread MainThread"):]
    assert "in sync_point" in main and "in item" in main
    assert doctor.diagnose(exp)["classification"] == "hang"
    assert jax_doctor.diagnose(exp)["classification"] == "hang"
