"""Chaos soak: kill, corrupt and resume a real trainer and prove continuity
(the JAX package's ``resilience/chaos.py``, its cycles, verdicts and report).

The recovery paths (SIGTERM mid-run, SIGKILL mid-save, flipped bytes in a
committed checkpoint, transient EIO under the writer, a wedged loader) are
trustworthy only when a harness drives them as production would: against
the trainer, ``python -m pyrecover_tpu_torch.train``, across real restarts,
judged by the stitched per-step loss CSV against an uninterrupted golden run
of the same seed. Each cycle runs the trainer under a seeded fault plan
(``$PYRECOVER_FAULT_PLAN``, ``resilience/faults.py``). JAX's
``device_count=N`` becomes N trainer processes of one process group under
the port's environment rendezvous (``parallel/mesh.py``): gloo on the CPU,
and on the card gloo too, every rank on the one card (``LOCAL_RANK`` 0,
``--dist-backend gloo``), the trainer module run under
``torch.use_deterministic_algorithms`` with the port's flash kernels, so a
rerun is the same run bit for bit.

The groups (``GROUPS``), each in its own experiment directories:

    main     golden (steps 1..N); 1 SIGTERM as step s1 begins; 2 SIGKILL in
             the resumed run's first save; 3 transient EIO absorbed by the
             retry, SIGTERM at s2 and the final checkpoint's bytes
             flipped; 4 recovery: the corrupt checkpoint quarantined, the
             one before it resumed, the run finished
    hang     5: a seeded loader stall past the run-health watchdog: the
             run survives, with hang_detected, a postmortem bundle and the
             doctor's "hang" in loader_wait
    elastic  6-9: a golden at 4 ranks, a kill at 4, a resume at 2 (the
             elastic reshard), a regrow to 4; bit-exact to the first kill,
             within ELASTIC_RTOL after
    zs       10-15: async zerostall golden, SIGTERM at s1, SIGKILL at each
             stage of the snapshot pipeline, recovery; bit-exact, no
             quarantine, no chunk leaked past GC
    z1       16-18: at 2 ranks, a zero1 golden, a zero1 run stopped at s1,
             its resume with --optimizer-sharding none; bit-exact
    bk       19-21: at 2 ranks, an int8 + buckets golden, a stop at s1, a
             resume without buckets: bit-exact to the flip, within
             tolerance after, the residual restored, no quarantine
    bkf      22-24: at 2 ranks, fp32 buckets, a stop at s1, a resume at
             another bucket cap: bit-exact end to end
    ap       25+: the goodput autopilot under a seeded hazard whose rate
             shifts mid-run: its interval within 2x of the Young-Daly
             optimum on both sides, the decision trail in every segment,
             the failure history counting exactly the kills

``run_soak(groups=...)`` runs a subset (each group's verdicts only; the
card's ``chip_smoke.py`` runs z1, bk and bkf); the default is all of them.
``python -m pyrecover_tpu_torch.resilience.chaos --preset smoke --seed 0
[--device cpu] [--workdir DIR] [--json OUT]`` runs every group, prints one
line a cycle and exits 0 when every verdict holds.
"""

import argparse
import json
import math
import os
import random
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from pyrecover_tpu_torch.resilience.quarantine import list_quarantined
from pyrecover_tpu_torch.telemetry import doctor as doctor_mod
from pyrecover_tpu_torch.telemetry import flight, read_events

CHAOS_JSON_ENV = "CHAOS_JSON"

GROUPS = ("main", "hang", "elastic", "zs", "z1", "bk", "bkf", "ap")

_TINY_MODEL_ARGS = (
    "--model-dim", "64", "--model-layers", "2", "--model-heads", "4",
    "--model-kv-heads", "2", "--vocab-size", "128",
)

PRESETS = {
    # CI speed: the tiny model, a few steps a run
    "smoke": dict(training_steps=10, checkpoint_frequency=3, batch_size=8,
                  sequence_length=32, training_samples=64, run_timeout_s=240),
    # a longer soak, the same protocol
    "soak": dict(training_steps=30, checkpoint_frequency=5, batch_size=8,
                 sequence_length=32, training_samples=64, run_timeout_s=600),
}

# the goodput-autopilot drill (the JAX package's shape): AP_STEPS steps, the
# seeded random_sigkill hazard on steps [0, AP_SHIFT) at AP_RATE a step,
# AP_GRACE hazard-free steps after each start (> AP_CEILING), the interval
# clamped to [1, AP_CEILING]; the chosen interval within
# AP_CONVERGENCE_FACTOR of the clamped Young-Daly optimum
AP_STEPS = 44
AP_SHIFT = 32
AP_RATE = 0.7
AP_GRACE = 13
AP_CEILING = 12
AP_MAX_ATTEMPTS = 12
AP_CONVERGENCE_FACTOR = 2.0

# relative per-step loss tolerance after a trajectory-preserving change (a
# replica count, a quantization grouping): the float trajectory drifts in
# the low bits, never diverges
ELASTIC_RTOL = 0.05


# the trainer as ``python -m`` runs it, under deterministic algorithms (cuBLAS's
# workspace setting comes from the environment, `_run_trainer`)
_DETERMINISTIC_TRAINER = (
    "import runpy, torch; torch.use_deterministic_algorithms(True); "
    "runpy.run_module('pyrecover_tpu_torch.train', run_name='__main__', alter_sys=True)")


def _trainer_cmd(preset, exp, seed, workdir, *, resume=False, extra_args=(), sync_ckpt=True,
                 device="cuda", ranks=None):
    # on the card a rerun must repeat bit for bit: deterministic algorithms
    entry = (("-c", _DETERMINISTIC_TRAINER) if device == "cuda"
             else ("-m", "pyrecover_tpu_torch.train"))
    cmd = [
        sys.executable, *entry,
        "--device", device,
        "--training-steps", str(preset["training_steps"]),
        "--batch-size", str(preset["batch_size"]),
        "--sequence-length", str(preset["sequence_length"]),
        "--training-samples", str(preset["training_samples"]),
        "--learning-rate", "1e-3", "--lr-warmup-steps", "2",
        "--seed", str(seed),
        "--checkpoint-dir", str(workdir),
        "--experiment_name", exp,
        "--checkpoint-frequency", str(preset["checkpoint_frequency"]),
        # sync (and flush the loss CSV) every step: the CSV after a kill must
        # hold every completed step, it is the artifact under test
        "--logging-frequency", "1000000",
        "--preempt-check-interval", "1",
        "--timeaware-checkpointing",
        "--log-loss-to-csv", "--telemetry",
        "--verify-checkpoints",  # checksum sidecars make corruption visible
        *_TINY_MODEL_ARGS,
    ]
    if device == "cuda":
        # the port's flash kernels (no atomics) for the attention
        cmd += ["--attention-impl", "flash"]
    if ranks is not None:
        cmd += ["--distributed", "--dp", str(ranks)]
        if device == "cuda":
            cmd += ["--dist-backend", "gloo"]  # every rank on the one card
    if sync_ckpt:
        # the classic drills save synchronously; the zerostall drill keeps
        # async saves on: the overlapped pipeline is what it tests
        cmd += ["--no-async-checkpoint"]
    if resume:
        cmd += ["--resume-from-checkpoint", "latest"]
    return cmd + list(extra_args)


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_trainer(cmd, *, fault_plan, log_path, timeout_s, ranks=None):
    """Run ``cmd`` as one process, or as ``ranks`` processes of one group.
    Returns ``(rc, seconds)``: the group's rc is the first nonzero one (a
    kill's negative signal number), else 0. Raises `TimeoutExpired` after
    killing every process when the group outlives ``timeout_s``."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                        "PYRECOVER_FAULT_PLAN")}
    env.setdefault("OMP_NUM_THREADS", "1")
    env.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # telemetry rotation under real kill/resume cycles: a tiny byte cap forces
    # several rotations a run, the keep depth holds the whole stream
    env.setdefault("PYRECOVER_TELEMETRY_MAX_BYTES", "16384")
    env.setdefault("PYRECOVER_TELEMETRY_KEEP", "50")
    if fault_plan is not None:
        env["PYRECOVER_FAULT_PLAN"] = json.dumps(fault_plan)
    port = _free_port()
    t0 = time.monotonic()
    procs = []
    # append-only log for humans; a torn tail is harmless
    with open(log_path, "ab") as logf:
        logf.write(("\n==== " + " ".join(cmd) + (f"  [{ranks} ranks]" if ranks else "")
                    + "\n").encode())
        logf.flush()
        for r in range(ranks or 1):
            renv = dict(env)
            if ranks:
                renv.update(RANK=str(r), WORLD_SIZE=str(ranks), LOCAL_RANK="0",
                            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            procs.append(subprocess.Popen(cmd, env=renv, stdout=logf, stderr=subprocess.STDOUT))
        try:
            rcs = [p.wait(timeout=max(timeout_s - (time.monotonic() - t0), 1))
                   for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    rc = next((c for c in rcs if c != 0), 0)
    return rc, round(time.monotonic() - t0, 2)


def _read_csv_rows(path):
    path = Path(path)
    if not path.exists():
        return []
    return [ln for ln in path.read_text().splitlines() if ln.strip()]


def _schedule(preset, seed):
    """The seeded fault schedule, ``(s1, s2)``: the SIGTERM steps. A soak
    failure reproduces by rerunning with the seed in its report."""
    rng = random.Random(seed)
    freq = preset["checkpoint_frequency"]
    steps = preset["training_steps"]
    # s1 lands around the first periodic save; s2 after the second one and
    # before the third, so cycle 3's final save is save #2 of that run
    s1 = rng.randint(freq, freq + 2)
    s2 = rng.randint(2 * freq + 1, min(3 * freq - 1, steps - 2))
    return s1, s2


def _elastic_continuity(golden_rows, rows, steps, shrink_step, rtol=ELASTIC_RTOL,
                        label="elastic drill"):
    """Gate a stitched loss CSV against its golden: bit-exact through
    ``shrink_step`` (the last step before the configuration first
    changed), within ``rtol`` relative after, the step sequence exact
    throughout. Returns ``(info, violations)``."""
    violations = []
    info = {"rows": len(rows), "bitexact_rows": 0, "max_rel_diff": 0.0,
            "shrink_step": shrink_step, "rtol": rtol}
    if len(rows) != steps + 1 or len(golden_rows) != steps + 1:
        violations.append(f"{label}: {len(rows)} stitched rows vs {len(golden_rows)} golden "
                          f"(want {steps + 1})")
        return info, violations
    if rows[0] != golden_rows[0]:
        violations.append(f"{label}: CSV headers differ")
        return info, violations
    for i, (g, r) in enumerate(zip(golden_rows[1:], rows[1:]), start=1):
        try:
            gs, gl = g.split(",")
            rs, rl = r.split(",")
            gs, rs, gl, rl = int(gs), int(rs), float(gl), float(rl)
        except ValueError:
            violations.append(f"{label}: unparseable CSV row {i}: {g!r} vs {r!r}")
            return info, violations
        if gs != i or rs != i:
            violations.append(f"{label}: step sequence broken at row {i}: golden step {gs}, "
                              f"stitched step {rs}")
            return info, violations
        if i <= shrink_step:
            # same configuration and seed: any drift is the resume's fault
            if g != r:
                violations.append(f"{label}: pre-flip row {i} not bit-exact: {g!r} vs {r!r}")
                return info, violations
            info["bitexact_rows"] = i
        else:
            rel = abs(rl - gl) / max(abs(gl), 1e-12)
            info["max_rel_diff"] = max(info["max_rel_diff"], rel)
            if rel > rtol:
                violations.append(f"{label}: loss diverged at step {i}: golden {gl} vs "
                                  f"stitched {rl} (rel {rel:.5f} > {rtol})")
                return info, violations
    info["max_rel_diff"] = round(info["max_rel_diff"], 8)
    return info, violations


def _first_divergence(golden_rows, rows):
    for i, (a, b) in enumerate(zip(golden_rows, rows)):
        if a != b:
            return {"row": i, "golden": a, "stitched": b}
    return None


def _bitexact_gate(workdir, exp, steps, label, violations):
    """A stitched CSV bit-exact against ``<exp>_golden``'s, end to end."""
    golden = _read_csv_rows(workdir / f"{exp}_golden" / f"{exp}_golden_loss_log.csv")
    rows = _read_csv_rows(workdir / exp / f"{exp}_loss_log.csv")
    div = _first_divergence(golden, rows)
    ok = div is None and len(rows) == len(golden) == steps + 1
    if not ok:
        violations.append(f"{label}: " + (
            json.dumps(div) if div else
            f"{len(rows)} stitched rows vs {len(golden)} golden (want {steps + 1})"))
    return rows, div, ok


def _sigterm(seed, step):
    return {"seed": seed, "faults": [{"type": "sigterm_at_step", "step": step}]}


def run_soak(preset_name="smoke", seed=0, workdir=None, json_out=None, device="cuda",
             groups=GROUPS):
    """Run the soak's ``groups`` with every trainer on ``device``: the card
    unless the caller asks for the CPU (``"cuda"`` raises without one).
    Returns the report dict (``report["ok"]`` is the verdict)."""
    preset = PRESETS[preset_name]
    unknown = set(groups) - set(GROUPS)
    if unknown:
        raise ValueError(f"unknown chaos groups {sorted(unknown)}; known: {GROUPS}")
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' (--device cpu) to run the "
                               "soak on the CPU")
    owns_workdir = workdir is None
    workdir = Path(workdir or tempfile.mkdtemp(prefix="pyrecover_chaos_"))
    workdir.mkdir(parents=True, exist_ok=True)
    log_path = workdir / "chaos_runs.log"
    s1, s2 = _schedule(preset, seed)
    steps = preset["training_steps"]
    timeout = preset["run_timeout_s"]
    violations, cycles = [], []
    report = {"preset": preset_name, "seed": seed, "device": device, "groups": list(groups),
              "schedule": {"sigterm_step_1": s1, "sigterm_step_2": s2},
              "workdir": str(workdir), "cycles": cycles}

    def cycle(name, *, fault_plan, resume, expect_rc, exp="chaos", extra_args=(), ranks=None,
              sync_ckpt=True, preset_over=None):
        cmd = _trainer_cmd(preset_over or preset, exp, seed, workdir, resume=resume,
                           extra_args=extra_args, sync_ckpt=sync_ckpt, device=device,
                           ranks=ranks)
        try:
            rc, secs = _run_trainer(cmd, fault_plan=fault_plan, log_path=log_path,
                                    timeout_s=timeout, ranks=ranks)
        except subprocess.TimeoutExpired:
            rc, secs = "timeout", timeout
        ok = rc in expect_rc
        if not ok:
            violations.append(f"cycle {name}: exit code {rc}, expected one of {expect_rc}")
        cycles.append({"name": name, "rc": rc, "seconds": secs, "ok": ok,
                       "faults": (fault_plan or {}).get("faults", [])})
        return ok

    if "main" in groups:
        _main_group(cycle, report, violations, workdir, seed, s1, s2, steps)
    if "hang" in groups:
        _hang_group(cycle, report, violations, workdir, seed)
    if "elastic" in groups:
        _elastic_group(cycle, report, violations, workdir, seed, s1, s2, steps)
    if "zs" in groups:
        _zerostall_group(cycle, report, violations, workdir, seed, s1, steps)
    if "z1" in groups:
        _zero1_group(cycle, report, violations, workdir, seed, s1, steps)
    if "bk" in groups:
        _bucket_int8_group(cycle, report, violations, workdir, seed, s1, steps)
    if "bkf" in groups:
        _bucket_fp32_group(cycle, report, violations, workdir, seed, s1, steps)
    if "ap" in groups:
        _autopilot_group(cycle, report, violations, workdir, seed, preset, cycles)

    report["kill_resume_cycles"] = sum(
        1 for c in cycles if any(f["type"] in ("sigterm_at_step", "kill9_during_save")
                                 for f in c["faults"]))
    report["violations"] = violations
    report["ok"] = not violations
    if json_out:
        Path(json_out).parent.mkdir(parents=True, exist_ok=True)
        # a report, made anew every run; a torn one fails its reader loudly
        Path(json_out).write_text(json.dumps(report, indent=2))
    if report["ok"] and owns_workdir:
        shutil.rmtree(workdir, ignore_errors=True)
        report["workdir"] = None  # removed, its log with it
    return report


def _main_group(cycle, report, violations, workdir, seed, s1, s2, steps):
    """Cycles golden and 1-4, and their verdicts."""
    cycle("golden", fault_plan=None, resume=False, expect_rc=(0,), exp="golden")
    cycle("sigterm", resume=False, expect_rc=(0,), fault_plan=_sigterm(seed, s1))
    cycle("kill9_during_save", resume=True, expect_rc=(-9, 137), fault_plan={
        "seed": seed, "faults": [{"type": "kill9_during_save", "save_index": 1}]})
    cycle("transient_io+corrupt", resume=True, expect_rc=(0,), fault_plan={
        "seed": seed, "faults": [
            {"type": "transient_io_error", "op": "write", "fail_count": 2},
            {"type": "sigterm_at_step", "step": s2},
            {"type": "corrupt_ckpt_bytes", "save_index": 2, "count": 64},
        ]})
    cycle("recover_and_finish", resume=True, expect_rc=(0,), fault_plan=None)

    exp_dir = workdir / "chaos"
    golden_rows = _read_csv_rows(workdir / "golden" / "golden_loss_log.csv")
    stitched_rows = _read_csv_rows(exp_dir / "chaos_loss_log.csv")
    first_divergence = _first_divergence(golden_rows, stitched_rows)
    continuity_ok = (first_divergence is None and len(golden_rows) == len(stitched_rows)
                     and len(golden_rows) == steps + 1)  # header + every step
    if not continuity_ok:
        violations.append("loss continuity broken: " + (
            json.dumps(first_divergence) if first_divergence else
            f"{len(stitched_rows)} stitched rows vs {len(golden_rows)} golden "
            f"(want {steps + 1})"))
    if not (exp_dir / "DONE").exists():
        violations.append("no DONE marker after the recovery cycle")
    quarantined = [p.name for p in list_quarantined(exp_dir)]
    # exactly the one injected corruption: anything else is a good
    # checkpoint the recovery lost
    if len(quarantined) != 1:
        violations.append(f"expected exactly the injected corruption quarantined, got "
                          f"{quarantined}")
    elif not quarantined[0].startswith(f"ckpt_{s2}_final"):
        violations.append(f"quarantined {quarantined[0]}, expected ckpt_{s2}_final*")
    # read_events merges rotated shards: the trail must survive rotation
    events = read_events(exp_dir / "chaos_telemetry.jsonl")
    counts = {}
    for e in events:
        counts[e["event"]] = counts.get(e["event"], 0) + 1
    for required in ("ckpt_io_retry", "ckpt_quarantined", "fault_injected",
                     "ckpt_precheck_failed"):
        if not counts.get(required):
            violations.append(f"no {required} telemetry event recorded")
    rotated = len(list(exp_dir.glob("chaos_telemetry.jsonl.*")))
    if os.environ.get("PYRECOVER_TELEMETRY_MAX_BYTES") is None and not rotated:
        violations.append("telemetry JSONL never rotated despite the soak's byte cap")
    report.update(
        continuity_ok=continuity_ok, first_divergence=first_divergence,
        rows=len(stitched_rows), quarantined=quarantined,
        telemetry_rotated_shards=rotated,
        telemetry_counts={k: counts.get(k, 0) for k in (
            "fault_injected", "ckpt_io_retry", "ckpt_quarantined", "ckpt_precheck_failed",
            "ckpt_pruned", "ckpt_saved", "resume")},
    )


def _hang_group(cycle, report, violations, workdir, seed):
    """Cycle 5: the loader stall past the watchdog. The stall hits producer
    batch 9, after the first step, so the armed watchdog has stall time to
    measure."""
    cycle("hang_watchdog", resume=False, expect_rc=(0,), exp="hang",
          extra_args=("--hang-watchdog-timeout", "5"), fault_plan={
              "seed": seed, "faults": [{"type": "loader_stall", "seconds": 20.0, "batch": 9}]})
    hang_dir = workdir / "hang"
    hang_events = read_events(hang_dir / "hang_telemetry.jsonl")
    hang_hits = [e for e in hang_events if e["event"] == "hang_detected"]
    if not hang_hits:
        violations.append("hang drill: no hang_detected event despite a 20s loader stall "
                          "against a 5s watchdog window")
    bundles = flight.list_bundles(hang_dir)
    if not bundles:
        violations.append("hang drill: no postmortem bundle in .postmortem/")
    diag = doctor_mod.diagnose(hang_dir)
    if diag["classification"] != "hang":
        violations.append(f"hang drill: doctor classified {diag['classification']!r}, "
                          "expected 'hang'")
    elif diag.get("phase") != "loader_wait":
        violations.append(f"hang drill: doctor named phase {diag.get('phase')!r}, expected "
                          "'loader_wait'")
    if not any(e["event"] == "flight_dump" for e in hang_events):
        violations.append("hang drill: no flight_dump event in the telemetry stream")
    report["hang"] = {"hang_detected": len(hang_hits), "bundles": [Path(b).name for b in bundles],
                      "doctor_classification": diag["classification"],
                      "doctor_phase": diag.get("phase")}


def _elastic_group(cycle, report, violations, workdir, seed, s1, s2, steps):
    """Cycles 6-9: 4 ranks, stopped at s1; 2 ranks, stopped at s2; 4 ranks to
    the end. Bit-exact to the first stop, within ELASTIC_RTOL after (another
    replica count sums the gradients in another order)."""
    cycle("elastic_golden", resume=False, expect_rc=(0,), exp="elastic_golden",
          fault_plan=None, ranks=4)
    cycle("elastic_kill@4dev", resume=False, expect_rc=(0,), exp="elastic", ranks=4,
          fault_plan=_sigterm(seed, s1))
    cycle("elastic_shrink@2dev", resume=True, expect_rc=(0,), exp="elastic", ranks=2,
          fault_plan=_sigterm(seed, s2))
    cycle("elastic_regrow@4dev", resume=True, expect_rc=(0,), exp="elastic", ranks=4,
          fault_plan=None)
    elastic_dir = workdir / "elastic"
    info, viol = _elastic_continuity(
        _read_csv_rows(workdir / "elastic_golden" / "elastic_golden_loss_log.csv"),
        _read_csv_rows(elastic_dir / "elastic_loss_log.csv"), steps, s1)
    violations += viol
    if not (elastic_dir / "DONE").exists():
        violations.append("elastic drill: no DONE marker after the regrow cycle")
    events = read_events(elastic_dir / "elastic_telemetry.jsonl")
    transitions = [((e.get("saved_topology") or {}).get("devices"),
                    (e.get("target_topology") or {}).get("devices"))
                   for e in events if e["event"] == "elastic_resume"]
    info["transitions"] = transitions
    if (4, 2) not in transitions or (2, 4) not in transitions:
        violations.append("elastic drill: expected 4→2 and 2→4 elastic_resume transitions "
                          f"in telemetry, got {transitions}")
    if not any(e["event"] == "sampler_rescaled" for e in events):
        violations.append("elastic drill: no sampler_rescaled telemetry event")
    diag = doctor_mod.diagnose(elastic_dir)
    info["doctor_classification"] = diag["classification"]
    if diag["classification"] != "healthy":
        violations.append(f"elastic drill: doctor classified {diag['classification']!r}, "
                          "expected 'healthy'")
    report["elastic"] = info


def _zerostall_group(cycle, report, violations, workdir, seed, s1, steps):
    """Cycles 10-15: the async snapshot pipeline killed at every stage."""
    from pyrecover_tpu_torch.checkpoint.zerostall import chunkstore

    zs_args = ("--checkpoint-engine", "zerostall")
    cycle("zs_golden", resume=False, expect_rc=(0,), exp="zs_golden", fault_plan=None,
          extra_args=zs_args, sync_ckpt=False)
    cycle("zs_sigterm", resume=False, expect_rc=(0,), exp="zs", extra_args=zs_args,
          sync_ckpt=False, fault_plan=_sigterm(seed, s1))
    stages = ("ckpt_snapshot", "ckpt_chunk_write", "ckpt_manifest_commit")
    for stage in stages:
        cycle(f"zs_kill@{stage}", resume=True, expect_rc=(-9, 137), exp="zs",
              extra_args=zs_args, sync_ckpt=False, fault_plan={
                  "seed": seed, "faults": [{"type": "kill9_during_save", "save_index": 1,
                                            "site": stage}]})
    cycle("zs_recover", resume=True, expect_rc=(0,), exp="zs", extra_args=zs_args,
          sync_ckpt=False, fault_plan=None)
    zs_dir = workdir / "zs"
    rows, _, continuity = _bitexact_gate(workdir, "zs", steps,
                                         "zerostall drill: loss continuity broken", violations)
    if not (zs_dir / "DONE").exists():
        violations.append("zerostall drill: no DONE marker after the recovery cycle")
    quarantined = [p.name for p in list_quarantined(zs_dir)]
    if quarantined:
        violations.append(f"zerostall drill: a torn save must publish nothing, but "
                          f"{quarantined} got quarantined")
    events = read_events(zs_dir / "zs_telemetry.jsonl")
    kill_sites = {e.get("site") for e in events if e["event"] == "fault_injected"
                  and e.get("type") == "kill9_during_save"}
    for stage in stages:
        if stage not in kill_sites:
            violations.append(f"zerostall drill: no kill9_during_save fired at {stage}")
    resumes = [e for e in events if e["event"] == "resume"]
    if len(resumes) < 4:
        violations.append(f"zerostall drill: expected >=4 resume events (one per kill cycle "
                          f"+ recovery), got {len(resumes)}")
    referenced = chunkstore.referenced_digests(zs_dir)
    on_disk = {p.name for p in chunkstore.chunks_root(zs_dir).rglob("*") if p.is_file()}
    leaked, missing = sorted(on_disk - referenced), sorted(referenced - on_disk)
    if leaked:
        violations.append(f"zerostall drill: {len(leaked)} chunk(s) leaked past GC "
                          f"(e.g. {leaked[:3]})")
    if missing:
        violations.append(f"zerostall drill: {len(missing)} referenced chunk(s) missing from "
                          f"the store (e.g. {missing[:3]}): live manifests are not "
                          "restorable")
    report["zerostall"] = {
        "rows": len(rows), "continuity_ok": continuity,
        "kill_sites": sorted(s for s in kill_sites if s), "resumes": len(resumes),
        "chunks_on_disk": len(on_disk), "chunks_referenced": len(referenced),
        "chunks_leaked": len(leaked),
        "backpressure_events": sum(1 for e in events if e["event"] == "ckpt_backpressure"),
    }


def _zero1_group(cycle, report, violations, workdir, seed, s1, steps):
    """Cycles 16-18 at 2 ranks: zero1 golden, zero1 stopped at s1, resumed
    at none; bit-exact (zero1 is the replicated update) and the zero1
    checkpoint restored, never quarantined."""
    z1_args = ("--optimizer-sharding", "zero1")
    cycle("z1_golden", resume=False, expect_rc=(0,), exp="z1_golden", fault_plan=None,
          extra_args=z1_args, ranks=2)
    cycle("z1_kill@zero1", resume=False, expect_rc=(0,), exp="z1", ranks=2,
          extra_args=z1_args, fault_plan=_sigterm(seed, s1))
    cycle("z1_flip_resume@none", resume=True, expect_rc=(0,), exp="z1", ranks=2,
          fault_plan=None)
    z1_dir = workdir / "z1"
    rows, div, continuity = _bitexact_gate(
        workdir, "z1", steps, "zero1 drill: flag-flip loss continuity broken", violations)
    if not (z1_dir / "DONE").exists():
        violations.append("zero1 drill: no DONE marker after the flag-flip resume")
    quarantined = [p.name for p in list_quarantined(z1_dir)]
    if quarantined:
        violations.append(f"zero1 drill: the flag flip must restore the zero1 checkpoint "
                          f"intact, but {quarantined} got quarantined")
    events = read_events(z1_dir / "z1_telemetry.jsonl")
    if not any(e["event"] == "resume" for e in events):
        violations.append("zero1 drill: no resume event after the kill")
    report["zero1"] = {"rows": len(rows), "continuity_ok": continuity, "bitexact": div is None,
                       "quarantined": quarantined,
                       "resumes": sum(1 for e in events if e["event"] == "resume")}


def _bucket_int8_group(cycle, report, violations, workdir, seed, s1, steps):
    """Cycles 19-21 at 2 ranks: int8 + buckets stopped at s1, resumed without
    buckets. The residual's shape does not depend on the layout, so the flip
    restores without quarantine; the re-blocked quantization moves the low
    bits after it."""
    bk_args = ("--grad-allreduce", "int8", "--grad-bucket-mb", "0.05")
    cycle("bk_golden", resume=False, expect_rc=(0,), exp="bk_golden", fault_plan=None,
          extra_args=bk_args, ranks=2)
    cycle("bk_kill@int8+buckets", resume=False, expect_rc=(0,), exp="bk", ranks=2,
          extra_args=bk_args, fault_plan=_sigterm(seed, s1))
    cycle("bk_flip_resume@nobuckets", resume=True, expect_rc=(0,), exp="bk", ranks=2,
          extra_args=("--grad-allreduce", "int8"), fault_plan=None)
    bk_dir = workdir / "bk"
    info, viol = _elastic_continuity(
        _read_csv_rows(workdir / "bk_golden" / "bk_golden_loss_log.csv"),
        _read_csv_rows(bk_dir / "bk_loss_log.csv"), steps, s1, label="bucket drill (int8)")
    violations += viol
    if not (bk_dir / "DONE").exists():
        violations.append("bucket drill (int8): no DONE marker after the flip resume")
    quarantined = [p.name for p in list_quarantined(bk_dir)]
    if quarantined:
        violations.append("bucket drill (int8): the buckets-off flip must restore the "
                          f"bucketed-int8 checkpoint intact, but {quarantined} got quarantined")
    events = read_events(bk_dir / "bk_telemetry.jsonl")
    if not any(e["event"] == "resume" for e in events):
        violations.append("bucket drill (int8): no resume event")
    buckets = [e for e in events if e["event"] == "grad_bucket"]
    if not any(e.get("buckets", 0) >= 2 for e in buckets):
        violations.append("bucket drill (int8): no grad_bucket record with a real (>= 2 "
                          "bucket) layout: the drill never ran bucketed")
    info.update(quarantined=quarantined, grad_bucket_events=len(buckets))
    report.setdefault("bucket", {})["int8"] = info


def _bucket_fp32_group(cycle, report, violations, workdir, seed, s1, steps):
    """Cycles 22-24 at 2 ranks: fp32 buckets stopped at s1, resumed at another
    cap; bit-exact end to end (each gradient element is one exact sum,
    whatever bucket carries it)."""
    bkf_args = ("--grad-bucket-mb", "0.05")
    cycle("bkf_golden", resume=False, expect_rc=(0,), exp="bkf_golden", fault_plan=None,
          extra_args=bkf_args, ranks=2)
    cycle("bkf_kill@fp32+buckets", resume=False, expect_rc=(0,), exp="bkf", ranks=2,
          extra_args=bkf_args, fault_plan=_sigterm(seed, s1))
    cycle("bkf_flip_resume@newlayout", resume=True, expect_rc=(0,), exp="bkf", ranks=2,
          extra_args=("--grad-bucket-mb", "0.2"), fault_plan=None)
    bkf_dir = workdir / "bkf"
    rows, div, continuity = _bitexact_gate(
        workdir, "bkf", steps, "bucket drill (fp32): layout-flip loss continuity broken "
        "(per-bucket fp32 sums are exact: any drift is a bug)", violations)
    if not (bkf_dir / "DONE").exists():
        violations.append("bucket drill (fp32): no DONE marker after the layout-flip resume")
    quarantined = [p.name for p in list_quarantined(bkf_dir)]
    if quarantined:
        violations.append(f"bucket drill (fp32): the layout flip must restore intact, but "
                          f"{quarantined} got quarantined")
    report.setdefault("bucket", {})["fp32_layout_flip"] = {
        "rows": len(rows), "bitexact": div is None, "continuity_ok": continuity,
        "quarantined": quarantined}


def _autopilot_group(cycle, report, violations, workdir, seed, preset, cycles):
    """Cycles 25+: a golden with --checkpoint-frequency auto (the bounded
    prior: one constant interval at the ceiling, saves never disabled), then
    a run under the shifting hazard, resumed until it finishes."""
    ap_preset = dict(preset, training_steps=AP_STEPS, checkpoint_frequency="auto")
    ap_flags = ("--ckpt-auto-floor", "1", "--ckpt-auto-ceiling", str(AP_CEILING),
                "--ckpt-auto-window", "4")
    ap_plan = {"seed": seed, "faults": [{
        "type": "random_sigkill", "rate_per_step": AP_RATE, "seed": seed * 1000 + 17,
        "grace_steps": AP_GRACE, "start_step": 0, "end_step": AP_SHIFT}]}
    cycle("ap_golden", resume=False, expect_rc=(0,), exp="ap_golden", fault_plan=None,
          extra_args=ap_flags, preset_over=ap_preset)
    kills, done = 0, False
    for attempt in range(AP_MAX_ATTEMPTS):
        cycle(f"ap_run{attempt + 1}", resume=attempt > 0, expect_rc=(0, -9, 137), exp="ap",
              extra_args=ap_flags, fault_plan=ap_plan, preset_over=ap_preset)
        rc = cycles[-1]["rc"]
        if rc == 0:
            done = True
            break
        if rc in (-9, 137):
            kills += 1
        else:
            break  # the unexpected rc is already a violation
    if not done:
        violations.append(f"autopilot drill: no clean finish within {AP_MAX_ATTEMPTS} resume "
                          f"attempts ({kills} kills observed)")
    ap_dir = workdir / "ap"
    g_events = read_events(workdir / "ap_golden" / "ap_golden_telemetry.jsonl")
    g_policies = [e for e in g_events if e["event"] == "ckpt_policy"]
    g_intervals = sorted({e.get("interval_steps") for e in g_policies})
    g_saves = [e["step"] for e in g_events if e["event"] == "ckpt_saved" and not e.get("final")]
    if not g_policies:
        violations.append("autopilot drill: golden auto run emitted no ckpt_policy decisions")
    else:
        if any(e.get("failures_observed") for e in g_policies):
            violations.append("autopilot drill: golden run reported nonzero failures")
        if g_intervals != [AP_CEILING]:
            violations.append("autopilot drill: zero-failure run must hold the bounded prior "
                              f"(one constant interval {AP_CEILING}), got {g_intervals}")
        expected_saves = list(range(AP_CEILING, AP_STEPS, AP_CEILING))
        if g_saves != expected_saves:
            violations.append("autopilot drill: zero-failure run must keep saving at the prior "
                              f"cadence {expected_saves}, got {g_saves}")
    events = read_events(ap_dir / "ap_telemetry.jsonl")
    policies = [e for e in events if e["event"] == "ckpt_policy"]
    fault_kills = sum(1 for e in events if e["event"] == "fault_injected"
                      and e.get("type") == "random_sigkill")
    segments = segments_with_policy = 0
    seg_has = False
    for e in events:
        if e["event"] == "run_start":
            segments += 1
            segments_with_policy += seg_has
            seg_has = False
        elif e["event"] == "ckpt_policy":
            seg_has = True
    segments_with_policy += seg_has
    if kills < 2:
        violations.append(f"autopilot drill: expected >= 2 seeded kills before the rate "
                          f"shift, got {kills}")
    if fault_kills != kills:
        violations.append(f"autopilot drill: {kills} kill exits but {fault_kills} "
                          "random_sigkill fault_injected events: the announce-then-kill "
                          "trail is torn")
    if segments_with_policy < kills + 1:
        violations.append("autopilot drill: ckpt_policy decisions must appear in every run "
                          f"segment ({segments} segments, only {segments_with_policy} "
                          "carried decisions)")
    sidecar_path = ap_dir / "failure_history.json"
    interruptions = None
    try:
        sidecar = json.loads(sidecar_path.read_text())
        interruptions = [r.get("kind") for r in sidecar.get("interruptions", [])]
    except (OSError, ValueError):
        violations.append(f"autopilot drill: failure-history sidecar missing/unreadable at "
                          f"{sidecar_path}")
    if interruptions is not None and (
            len(interruptions) != kills or any(k != "hard_kill" for k in interruptions)):
        violations.append(f"autopilot drill: sidecar recorded {interruptions}, expected "
                          f"exactly {kills} hard_kill interruption(s): the resume-chain "
                          "reconstruction lost or double-counted a death")

    def convergence(decision, label):
        cost, mtti = decision.get("cost_s"), decision.get("mtti_s")
        iter_s, chosen = decision.get("step_iter_s"), decision.get("interval_steps")
        if not all(isinstance(v, (int, float)) and v > 0 for v in (cost, mtti, iter_s, chosen)):
            violations.append(f"autopilot drill: {label} decision carries unusable inputs: "
                              f"{decision}")
            return None
        analytic = math.sqrt(2.0 * cost * mtti) / iter_s
        clamped = min(max(analytic, 1.0), float(AP_CEILING))
        ratio = chosen / clamped
        if not 1.0 / AP_CONVERGENCE_FACTOR <= ratio <= AP_CONVERGENCE_FACTOR:
            violations.append(
                f"autopilot drill: {label} interval {chosen} is {ratio:.2f}x the "
                f"bound-clamped analytic optimum {clamped:.2f} (raw {analytic:.2f}; cost "
                f"{cost}s, MTTI {mtti}s, step {iter_s}s): outside {AP_CONVERGENCE_FACTOR}x")
        return {"chosen": chosen, "analytic": round(analytic, 3), "clamped": round(clamped, 3),
                "ratio": round(ratio, 3)}

    pre = [e for e in policies if e.get("step", 0) < AP_SHIFT and e.get("failures_observed", 0)]
    post = [e for e in policies if e.get("step", 0) >= AP_SHIFT]
    ap_pre = ap_post = None
    if not pre:
        violations.append("autopilot drill: no failure-informed ckpt_policy decision before "
                          "the rate shift")
    else:
        ap_pre = convergence(pre[-1], "pre-shift")
    if not post:
        violations.append("autopilot drill: no ckpt_policy decision after the rate shift")
    else:
        ap_post = convergence(post[-1], "post-shift")
    if pre and post and post[-1].get("interval_steps", 0) < pre[-1].get("interval_steps", 0):
        # the hazard dropped to zero: the interval may only grow from here
        violations.append("autopilot drill: interval shrank after the failure rate dropped "
                          f"to zero ({pre[-1].get('interval_steps')} -> "
                          f"{post[-1].get('interval_steps')})")
    if not (ap_dir / "DONE").exists():
        violations.append("autopilot drill: no DONE marker after recovery")
    quarantined = [p.name for p in list_quarantined(ap_dir)]
    if quarantined:
        violations.append(f"autopilot drill: a hazard kill must never eat a committed save, "
                          f"but {quarantined} got quarantined")
    report["autopilot"] = {
        "kills": kills, "attempts": sum(1 for c in cycles if c["name"].startswith("ap_run")),
        "decisions": len(policies), "segments": segments,
        "segments_with_decisions": segments_with_policy, "sidecar_interruptions": interruptions,
        "pre_shift": ap_pre, "post_shift": ap_post, "golden_intervals": g_intervals,
        "golden_saves": g_saves, "interval_trajectory": [e.get("interval_steps")
                                                         for e in policies],
        "quarantined": quarantined,
    }


def print_report(report):
    """The soak's human summary, one line a cycle and one a group."""
    for c in report["cycles"]:
        print(f"  cycle {c['name']:<26} rc={c['rc']!s:>4}  {c['seconds']}s  "
              f"{'ok' if c['ok'] else 'FAIL'}")
    if "continuity_ok" in report:
        print(f"  continuity: {'bit-exact' if report['continuity_ok'] else 'BROKEN'} "
              f"({report['rows']} rows) | quarantined: {report['quarantined']} | retries: "
              f"{report['telemetry_counts']['ckpt_io_retry']}")
    el = report.get("elastic")
    if el:
        print(f"  elastic: transitions {el.get('transitions')} | {el.get('bitexact_rows')} "
              f"bit-exact rows, max rel diff {el.get('max_rel_diff')} (tol {el.get('rtol')}) "
              f"| doctor {el.get('doctor_classification')}")
    zs = report.get("zerostall")
    if zs:
        print(f"  zerostall: kills at {zs.get('kill_sites')} | {zs.get('resumes')} resumes | "
              f"chunks {zs.get('chunks_on_disk')} on disk = {zs.get('chunks_referenced')} "
              f"referenced ({zs.get('chunks_leaked')} leaked)")
    z1 = report.get("zero1")
    if z1:
        print(f"  zero1 flag-flip: {'bit-exact' if z1.get('bitexact') else 'DIVERGED'} "
              f"({z1.get('rows')} rows) | {z1.get('resumes')} resumes | quarantined: "
              f"{z1.get('quarantined')}")
    bk = report.get("bucket") or {}
    if "int8" in bk:
        b = bk["int8"]
        print(f"  bucket flag-flip (int8): {b.get('bitexact_rows')} bit-exact rows then max "
              f"rel {b.get('max_rel_diff')} (tol {b.get('rtol')})")
    if "fp32_layout_flip" in bk:
        b = bk["fp32_layout_flip"]
        print(f"  bucket layout flip (fp32): {'bit-exact' if b.get('bitexact') else 'DIVERGED'}"
              f" ({b.get('rows')} rows)")
    ap = report.get("autopilot")
    if ap:
        pre, post = ap.get("pre_shift") or {}, ap.get("post_shift") or {}
        print(f"  autopilot: {ap.get('kills')} seeded kills over {ap.get('attempts')} attempts "
              f"| {ap.get('decisions')} decisions across {ap.get('segments_with_decisions')} "
              f"segments | interval pre-shift {pre.get('chosen')} vs optimum "
              f"{pre.get('clamped')} | post-shift {post.get('chosen')} vs {post.get('clamped')}"
              f" | golden prior {ap.get('golden_intervals')}")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="pyrecover chaos soak: kill/corrupt/resume a real trainer under a seeded "
                    "fault plan and verify bit-exact loss continuity")
    p.add_argument("--preset", choices=sorted(PRESETS), default="smoke")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workdir", default=None,
                   help="experiment directory (kept); default: a temp dir, removed on "
                        "success, kept on failure")
    p.add_argument("--json", default=os.environ.get(CHAOS_JSON_ENV) or None,
                   help=f"JSON report path (default ${CHAOS_JSON_ENV})")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the trainers run; cuda (the default) raises without a card")
    args = p.parse_args(argv)
    report = run_soak(args.preset, seed=args.seed, workdir=args.workdir, json_out=args.json,
                      device=args.device)
    print_report(report)
    if report["violations"]:
        for v in report["violations"]:
            print(f"  VIOLATION: {v}")
        print(f"chaos: FAIL (seed {report['seed']}, workdir kept at {report['workdir']})")
        return 1
    print(f"chaos: OK — {report['kill_resume_cycles']} kill/resume cycles, losses bit-exact vs "
          f"golden (seed {report['seed']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
