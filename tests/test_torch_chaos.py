"""The port's chaos soak (``pyrecover_tpu_torch/resilience/chaos.py``), held
to the JAX package's ``resilience/chaos.py``.

* The pure parts against JAX's: the seeded schedule for seeds 0-3 of both
  presets, and ``_elastic_continuity`` on crafted loss rows (its info and
  violations, case by case).
* The groups' verdicts on crafted experiment directories (CSVs, markers,
  JSONL event logs), with the cycles stubbed out: a good drill passes, and
  each broken artifact is named as JAX's verdict names it.
* The z1 group for real on the CPU: a zero1 golden over 2 gloo ranks, a
  zero1 run stopped at s1, its resume at ``none``, bit-exact (~20 s).
* The whole soak, every group, as the JAX package's slow test runs it.
"""

import json

import pytest
import torch

from pyrecover_tpu_torch.resilience import chaos


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("preset", ["smoke", "soak"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_schedule_matches_jax(preset, seed):
    from pyrecover_tpu.resilience import chaos as jax_chaos

    assert chaos.PRESETS[preset] == jax_chaos.PRESETS[preset]
    assert chaos._schedule(chaos.PRESETS[preset], seed) == jax_chaos._schedule(
        jax_chaos.PRESETS[preset], seed)


def _rows(losses):
    return ["step,loss"] + [f"{i},{v!r}" for i, v in enumerate(losses, start=1)]


GOLDEN = [4.5, 4.25, 4.125, 4.0, 3.875]


@pytest.mark.parametrize("case", ["equal", "drift-after", "drift-before", "diverged",
                                  "short", "step-gap", "header", "garbled"])
def test_elastic_continuity_matches_jax(case):
    from pyrecover_tpu.resilience import chaos as jax_chaos

    rows = _rows(GOLDEN)
    if case == "drift-after":
        rows = _rows(GOLDEN[:3] + [4.0001, 3.8751])
    elif case == "drift-before":
        rows = _rows([4.5000001] + GOLDEN[1:])
    elif case == "diverged":
        rows = _rows(GOLDEN[:3] + [5.0, 3.875])
    elif case == "short":
        rows = rows[:-1]
    elif case == "step-gap":
        rows = rows[:3] + ["4,4.125"] + rows[4:]
    elif case == "header":
        rows = ["step,value"] + rows[1:]
    elif case == "garbled":
        rows = rows[:2] + ["2;4.25"] + rows[3:]
    want = jax_chaos._elastic_continuity(_rows(GOLDEN), rows, 5, 3, label="drill")
    assert chaos._elastic_continuity(_rows(GOLDEN), rows, 5, 3, label="drill") == want
    assert bool(want[1]) == (case not in ("equal", "drift-after"))


def _drill_dir(root, exp, losses, *, done=True, events=(), quarantined=()):
    d = root / exp
    d.mkdir(parents=True)
    (d / f"{exp}_loss_log.csv").write_text("\n".join(_rows(losses)) + "\n")
    if done:
        (d / "DONE").write_text("{}")
    with open(d / f"{exp}_telemetry.jsonl", "w") as f:
        for e in events:
            f.write(json.dumps({"ts": 0.0, "host": 0, **e}) + "\n")
    for name in quarantined:
        (d / ".corrupt").mkdir(exist_ok=True)
        (d / ".corrupt" / name).write_text("x")
    return d


def _verdicts(fn, root, *args):
    report, violations = {}, []
    fn(lambda *a, **k: True, report, violations, root, 0, *args)
    return report, violations


@pytest.mark.parametrize("broken", [None, "diverged", "no-done", "no-resume", "quarantined"])
def test_zero1_verdicts_on_crafted_runs(tmp_path, broken):
    steps = len(GOLDEN)
    _drill_dir(tmp_path, "z1_golden", GOLDEN)
    _drill_dir(tmp_path, "z1", GOLDEN[:3] + [4.5] + GOLDEN[4:] if broken == "diverged"
               else GOLDEN, done=broken != "no-done",
               events=[] if broken == "no-resume" else [{"event": "resume", "step": 2}],
               quarantined=["ckpt_2.ckpt"] if broken == "quarantined" else ())
    report, violations = _verdicts(chaos._zero1_group, tmp_path, 2, steps)
    want = {None: None, "diverged": "flag-flip loss continuity broken",
            "no-done": "no DONE marker after the flag-flip resume",
            "no-resume": "no resume event after the kill",
            "quarantined": "got quarantined"}[broken]
    if want is None:
        assert violations == [] and report["zero1"]["bitexact"]
    else:
        assert len(violations) == 1 and want in violations[0], violations


@pytest.mark.parametrize("broken", [None, "no-buckets", "diverged"])
def test_bucket_verdicts_on_crafted_runs(tmp_path, broken):
    steps = len(GOLDEN)
    bucket = {"event": "grad_bucket", "buckets": 1 if broken == "no-buckets" else 7}
    _drill_dir(tmp_path, "bk_golden", GOLDEN)
    _drill_dir(tmp_path, "bk", GOLDEN[:3] + [4.001 if broken != "diverged" else 9.0, 3.875],
               events=[bucket, {"event": "resume", "step": 2}])
    _drill_dir(tmp_path, "bkf_golden", GOLDEN)
    _drill_dir(tmp_path, "bkf", GOLDEN)
    report, violations = _verdicts(chaos._bucket_int8_group, tmp_path, 3, steps)
    _, fp32_violations = _verdicts(chaos._bucket_fp32_group, tmp_path, 3, steps)
    assert fp32_violations == [] and report["bucket"]["int8"]["grad_bucket_events"] == 1
    want = {None: None, "no-buckets": "no grad_bucket record with a real",
            "diverged": "loss diverged at step 4"}[broken]
    if want is None:
        assert violations == [] and report["bucket"]["int8"]["bitexact_rows"] == 3
    else:
        assert len(violations) == 1 and want in violations[0], violations


def test_unknown_group_raises(tmp_path):
    with pytest.raises(ValueError, match="unknown chaos groups"):
        chaos.run_soak(workdir=tmp_path, device="cpu", groups=("z1", "nope"))


def test_main_without_a_card_raises_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        chaos.main(["--preset", "smoke"])


def test_run_soak_defaults_to_the_card(monkeypatch, tmp_path):
    """A caller who names no device gets the card's soak, and with no card
    an error, never a soak on the CPU; the trainers' command follows."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chaos.run_soak("smoke", workdir=tmp_path, groups=("z1",))
    assert not any(tmp_path.iterdir())
    cmd = chaos._trainer_cmd(chaos.PRESETS["smoke"], "x", 0, tmp_path, ranks=2)
    assert cmd[cmd.index("--device") + 1] == "cuda"
    assert cmd[1:3] == ["-c", chaos._DETERMINISTIC_TRAINER]
    assert cmd[cmd.index("--dist-backend") + 1] == "gloo"
    assert chaos._trainer_cmd(chaos.PRESETS["smoke"], "x", 0, tmp_path, device="cpu")[1:3] == [
        "-m", "pyrecover_tpu_torch.train"]


def test_z1_group_on_the_cpu(tmp_path):
    """Cycles 16-18 for real: two gloo ranks a run; zero1 stopped at s1 and
    resumed at none is the zero1 golden bit for bit."""
    report = chaos.run_soak("smoke", seed=0, workdir=tmp_path / "w", device="cpu",
                            groups=("z1",))
    assert report["ok"], report["violations"]
    assert [c["name"] for c in report["cycles"]] == [
        "z1_golden", "z1_kill@zero1", "z1_flip_resume@none"]
    z1 = report["zero1"]
    assert z1["bitexact"] and z1["continuity_ok"] and z1["quarantined"] == []
    assert z1["resumes"] >= 1 and z1["rows"] == chaos.PRESETS["smoke"]["training_steps"] + 1


@pytest.mark.slow
def test_chaos_smoke_soak_bitexact(tmp_path):
    """Every group of the soak on the CPU, with the JAX slow test's gates."""
    report = chaos.run_soak("smoke", seed=0, workdir=tmp_path / "chaos", device="cpu",
                            json_out=tmp_path / "report.json")
    assert report["ok"], report["violations"]
    assert report["kill_resume_cycles"] >= 2
    assert report["continuity_ok"] and report["first_divergence"] is None
    s2 = report["schedule"]["sigterm_step_2"]
    assert len(report["quarantined"]) == 1
    assert report["quarantined"][0].startswith(f"ckpt_{s2}_final")
    counts = report["telemetry_counts"]
    assert counts["ckpt_io_retry"] >= 2 and counts["ckpt_quarantined"] == 1
    assert counts["fault_injected"] >= 4
    assert counts["ckpt_precheck_failed"] >= 1 and counts["resume"] >= 2
    assert report["hang"]["hang_detected"] >= 1 and report["hang"]["bundles"]
    assert report["hang"]["doctor_classification"] == "hang"
    assert report["hang"]["doctor_phase"] == "loader_wait"
    el = report["elastic"]
    assert (4, 2) in el["transitions"] and (2, 4) in el["transitions"]
    assert el["bitexact_rows"] >= 1 and el["max_rel_diff"] <= el["rtol"]
    assert el["doctor_classification"] == "healthy"
    z1 = report["zero1"]
    assert z1["continuity_ok"] and z1["bitexact"] and z1["resumes"] >= 1
    assert z1["quarantined"] == []
    bk = report["bucket"]
    assert bk["int8"]["bitexact_rows"] >= 1 and bk["int8"]["max_rel_diff"] <= bk["int8"]["rtol"]
    assert bk["int8"]["quarantined"] == [] and bk["int8"]["grad_bucket_events"] >= 1
    assert bk["fp32_layout_flip"]["bitexact"] and bk["fp32_layout_flip"]["continuity_ok"]
    assert bk["fp32_layout_flip"]["quarantined"] == []
    ap = report["autopilot"]
    assert ap["kills"] >= 2
    assert ap["sidecar_interruptions"] == ["hard_kill"] * ap["kills"]
    assert ap["segments_with_decisions"] >= ap["kills"] + 1
    for side in ("pre_shift", "post_shift"):
        assert ap[side] is not None and 0.5 <= ap[side]["ratio"] <= 2.0
    assert ap["quarantined"] == [] and ap["golden_intervals"] == [chaos.AP_CEILING]
    assert (tmp_path / "report.json").exists()
