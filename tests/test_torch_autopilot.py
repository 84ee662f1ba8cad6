"""The port's checkpoint autopilot (pyrecover_tpu_torch/resilience/autopilot.py)
held to the JAX package's (tests/test_autopilot.py).

The Young-Daly math and the estimators are checked as the JAX tests check
them. Every controller scenario (no failures, a stable failure model, MTTI
below the save cost, hysteresis and the rate limit, the engine
recommendation, a restart from the sidecar, the bootstrap from a telemetry
stream) runs through both packages' ``CheckpointAutopilot`` with the same
observations: the chosen intervals and every ``ckpt_policy`` record must
be equal, field for field. Both packages' ``reconstruct_history`` fold the
same stream into the same history, and each reads the other's sidecar.
Last, one ``train.train`` run with ``--checkpoint-frequency auto``: its
saves follow the intervals its records chose, within [floor, ceiling], the
cost it learned is the blocking time it measured, and the JAX package's
reconstruction and summarizer read its stream.
"""

import json
import math
import random

import pytest
import torch

from pyrecover_tpu import telemetry as jax_telemetry
from pyrecover_tpu.resilience import autopilot as jax_autopilot
from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.resilience import autopilot
from pyrecover_tpu_torch.resilience.autopilot import (
    SIDECAR_NAME,
    CheckpointAutopilot,
    EwmaEstimator,
    FailureHistory,
    MedianEstimator,
    modelled_overhead_fraction,
    reconstruct_history,
    young_daly_interval_s,
)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def sinks():
    """The port's and the JAX package's event sinks."""
    port, ref = telemetry.MemorySink(), jax_telemetry.MemorySink()
    telemetry.add_sink(port)
    jax_telemetry.add_sink(ref)
    yield port, ref
    telemetry.remove_sink(port)
    jax_telemetry.remove_sink(ref)


def policies(sink):
    return [{k: v for k, v in e.items() if k not in ("ts", "host")}
            for e in sink.events if e["event"] == "ckpt_policy"]


# ---- Young-Daly math -------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_young_daly_minimizes_the_first_order_model(seed):
    rng = random.Random(seed)
    for _ in range(20):
        cost, mtti = 10.0 ** rng.uniform(-3, 2), 10.0 ** rng.uniform(0, 5)
        t_star = young_daly_interval_s(cost, mtti)
        assert t_star == jax_autopilot.young_daly_interval_s(cost, mtti)
        best = min((modelled_overhead_fraction(t_star * f, cost, mtti), f)
                   for f in [0.1 * k for k in range(1, 101)])
        assert best[0] >= modelled_overhead_fraction(t_star, cost, mtti) - 1e-12
        assert abs(best[1] - 1.0) < 1e-9


def _simulate_goodput(interval_s, cost_s, mtti_s, rng, n_failures=400):
    """Save every ``interval_s`` of work (``cost_s`` each); Poisson
    interruptions at rate 1/mtti_s lose the work since the last save."""
    productive = wall = 0.0
    cycle = interval_s + cost_s
    for _ in range(n_failures):
        gap = rng.expovariate(1.0 / mtti_s)
        productive += int(gap // cycle) * interval_s
        wall += gap
    return productive / max(wall, 1e-12)


def test_young_daly_minimizes_simulated_poisson_loss():
    cost, mtti = 5.0, 3600.0
    t_star = young_daly_interval_s(cost, mtti)

    def goodput(t):
        return _simulate_goodput(t, cost, mtti, random.Random(1234))

    g_star = goodput(t_star)
    assert g_star > goodput(t_star / 4.0) and g_star > goodput(t_star * 4.0)
    assert g_star >= max(goodput(t_star * f) for f in (0.25, 0.5, 0.75, 1.0, 1.5, 2, 4)) - 5e-3


def test_young_daly_degenerate_regimes():
    assert young_daly_interval_s(100.0, 0.01) == pytest.approx(math.sqrt(2.0), rel=1e-9)
    assert young_daly_interval_s(0.0, 3600.0) == 0.0
    assert young_daly_interval_s(1.0, 1e12) > 1e5
    assert modelled_overhead_fraction(0.0, 1.0, 1.0) == math.inf


def test_ewma_prior_is_replaced_by_first_observation():
    e = EwmaEstimator(initial=10.0)
    assert (e.value, e.count) == (10.0, 0)
    e.observe(0.02)
    assert e.value == pytest.approx(0.02)
    e.observe(0.04)
    assert 0.02 < e.value < 0.04


def test_median_estimator_shrugs_off_compile_outlier():
    m = MedianEstimator(initial=1.0)
    m.observe(12.0)
    for _ in range(10):
        m.observe(0.05)
    assert m.value == pytest.approx(0.05)


# ---- the sidecar and the reconstruction ------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sidecar_roundtrip_across_packages(tmp_path, writer):
    mod, other = (autopilot, jax_autopilot) if writer == "port" else (jax_autopilot, autopilot)
    h = mod.FailureHistory(tmp_path)
    h.record("hard_kill", ts=100.0, step=7, steps_run=7)
    h.record("preemption", ts=200.0, step=19, steps_run=12)
    h.estimates = {"save_cost_s": {"zerostall": 0.01}, "interval_steps": 4}
    h.save()
    got = other.FailureHistory.load(tmp_path)
    assert got.interruptions == h.interruptions and got.estimates == h.estimates
    (tmp_path / SIDECAR_NAME).write_text('{"interruptions": [tor')
    assert other.FailureHistory.load(tmp_path).interruptions == []
    with pytest.raises(ValueError):
        h.record("martian_attack", ts=1.0)


def test_sidecar_windowed_mtti_tracks_a_rate_shift(tmp_path):
    h = FailureHistory(tmp_path)
    for i in range(4):
        h.record("hard_kill", ts=float(i), steps_run=100)
    for i in range(4):
        h.record("hard_kill", ts=float(10 + i), steps_run=10)
    assert h.mtti_steps(live_steps=0, window=4) == (pytest.approx(10.0), 4)
    assert h.mtti_steps(live_steps=0, window=100) == (pytest.approx(55.0), 8)
    assert h.mtti_steps(live_steps=40, window=4)[0] == pytest.approx(20.0)
    h.record("hang", ts=20.0, steps_run=None)
    assert h.mtti_steps(live_steps=0, window=4) == (pytest.approx(10.0), 4)
    assert h.counts_by_kind() == {"hard_kill": 8, "hang": 1}


def _stream(*segments):
    out, ts = [], [100.0]

    def e(name, **fields):
        ts[0] += 1.0
        return {"event": name, "ts": ts[0], "host": 0, **fields}

    for seg in segments:
        out.append(e("run_start"))
        out.extend(e(name, **fields) for name, fields in seg)
    return out


STREAM = _stream(
    [("train_sync", {"step": 3, "iter_s": 0.1}), ("train_sync", {"step": 9, "iter_s": 0.1})],
    [("train_sync", {"step": 14, "iter_s": 0.1}),
     ("run_summary", {"status": "error", "step": 14})],
    [("hang_detected", {"silent_s": 6.0}), ("train_sync", {"step": 20, "iter_s": 0.1}),
     ("preempt_stop", {"step": 20}), ("run_summary", {"status": "stopped_early", "step": 20})],
    [("train_sync", {"step": 30, "iter_s": 0.1}),
     ("run_summary", {"status": "finished", "step": 30})],
    [("train_sync", {"step": 31, "iter_s": 0.1})],
)


def test_reconstruction_matches_jax_and_counts_each_death_once(tmp_path):
    port, ref = FailureHistory(tmp_path / "p"), jax_autopilot.FailureHistory(tmp_path / "j")
    assert reconstruct_history(STREAM, port) == jax_autopilot.reconstruct_history(STREAM, ref) == 4
    assert port.interruptions == ref.interruptions
    assert [r["kind"] for r in port.interruptions] == ["hard_kill", "crash", "hang", "preemption"]
    assert port.interruptions[0]["steps_run"] == 7 and port.interruptions[0]["step"] == 9
    assert port.scanned_through_ts == ref.scanned_through_ts
    assert reconstruct_history(STREAM, port) == 0
    longer = STREAM + [{"event": "run_start", "ts": 999.0, "host": 0}]
    assert reconstruct_history(longer, port) == jax_autopilot.reconstruct_history(longer, ref) == 1
    assert port.interruptions == ref.interruptions


# ---- the controller, scenario by scenario, in both packages ----------------


def _feed(ap, *, iter_s=0.1, n_iter=20, cost_s=None, n_cost=3, gaps=(), step=0):
    for _ in range(n_iter):
        ap.observe_iter(iter_s, step=step)
    if cost_s is not None:
        for _ in range(n_cost):
            ap.observe_save(cost_s)
    for g in gaps:
        ap.history.record("hard_kill", ts=0.0, steps_run=g)
    return ap


def _ctl(mod, path, **kw):
    args = dict(engine="vanilla", static_interval=10, floor=1, ceiling=100,
                mtti_prior_s=3600.0, window=4, default_cost_s=10.0, default_iter_s=1.0)
    args.update(kw)
    return mod.CheckpointAutopilot(path, **args)


def _prior(mod, path):
    ap = _feed(_ctl(mod, path, ceiling=25), iter_s=0.05, cost_s=0.01)
    return [ap.decide(s, source="post_save") for s in (0, 5, 10, 15)]


def _converge(mod, path):
    ap = _feed(_ctl(mod, path), iter_s=0.1, cost_s=0.2, gaps=(50, 50, 50))
    return [ap.decide(s, source="post_save") for s in range(0, 60, 10)]


def _floor(mod, path):
    ap = _feed(_ctl(mod, path, floor=2), iter_s=1.0, cost_s=0.005, gaps=(1, 1, 1))
    return [ap.decide(s) for s in range(6)]


def _hysteresis(mod, path):
    ap = _feed(_ctl(mod, path), iter_s=0.1, cost_s=0.2, gaps=(50, 50, 50))
    trail = [ap.decide(s) for s in range(0, 40, 10)]
    ap.observe_save(0.2 * 1.3)
    trail.append(ap.decide(50))
    ap.observe_save(20.0)
    trail.append(ap.decide(60))
    return trail


def _recommend(mod, path):
    trail = []
    for sub, kw in (("v", {}), ("zs", {"engine": "zerostall"})):
        ap = _feed(_ctl(mod, path / sub, **kw), iter_s=0.1, cost_s=8.0, gaps=(50,))
        trail.append(ap.decide(0))
    trail.append(_ctl(mod, path / "p", default_cost_s=30.0).decide(0))
    return trail


def _restart(mod, path):
    ap = _feed(_ctl(mod, path), iter_s=0.1, cost_s=0.2, gaps=(50, 50))
    trail = [ap.decide(s) for s in range(0, 40, 10)]
    again = _ctl(mod, path)  # a new process, the same experiment
    return trail + [again.interval_steps, round(again._cost.value, 9),
                    len(again.history.interruptions), again.decide(40)]


def _bootstrap(mod, path):
    tele = path / "t.jsonl"
    path.mkdir(parents=True, exist_ok=True)
    with open(tele, "w") as f:
        for e in _stream([("train_sync", {"step": 9, "iter_s": 0.05}),
                          ("train_sync", {"step": 18, "iter_s": 0.05})],
                         [("train_sync", {"step": 20, "iter_s": 0.05})]):
            f.write(json.dumps(e) + "\n")
    ap = _ctl(mod, path, ceiling=12)
    return [ap.bootstrap(tele, step=18), len(ap.history.interruptions)]


SCENARIOS = {"prior": _prior, "converge": _converge, "floor": _floor,
             "hysteresis": _hysteresis, "recommend": _recommend, "restart": _restart,
             "bootstrap": _bootstrap}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_controller_decisions_match_jax(tmp_path, sinks, name):
    port_sink, jax_sink = sinks
    got = SCENARIOS[name](autopilot, tmp_path / "port")
    want = SCENARIOS[name](jax_autopilot, tmp_path / "jax")
    assert got == want
    assert policies(port_sink) == policies(jax_sink)
    for rec in policies(port_sink):
        assert rec["floor"] <= rec["interval_steps"] <= rec["ceiling"]


def test_controller_contract(tmp_path, sinks):
    """The JAX tests' contract on the port: no failures ramp to the bounded
    prior and hold; a stable model settles near the optimum; MTTI below the
    cost clamps to the floor; an outlier moves the interval at most x2."""
    port_sink, _ = sinks
    trail = _prior(autopilot, tmp_path / "a")
    assert trail == sorted(trail) and trail[-2:] == [25, 25]
    assert all(r["reason"] in ("prior", "rate-limited") and r["mtti_s"] == 3600.0
               for r in policies(port_sink))
    chosen = _converge(autopilot, tmp_path / "b")[-1]
    opt = policies(port_sink)[-1]["optimum_steps"]
    assert opt == pytest.approx(math.sqrt(2 * 0.2 * (200 / 3) * 0.1) / 0.1, rel=0.02)
    assert chosen / opt <= 1.3 and opt / chosen <= 1.3
    assert _floor(autopilot, tmp_path / "c")[-1] == 2
    assert policies(port_sink)[-1]["reason"] == "floor"
    trail = _hysteresis(autopilot, tmp_path / "d")
    assert trail[-1] <= trail[-2] * 2 and policies(port_sink)[-1]["reason"] == "rate-limited"
    # only seconds-long saves of another engine recommend the zerostall one
    for r in policies(port_sink):
        assert (r["engine_recommendation"] == "zerostall") == (
            r["engine"] != "zerostall" and r["cost_s"] >= autopilot.ENGINE_SWITCH_COST_S)


# ---- through train.train ---------------------------------------------------


def test_train_auto_saves_follow_the_policy(tmp_path):
    from pyrecover_tpu_torch.train import train
    from test_torch_zerostall import tiny_config

    import dataclasses

    cfg = dataclasses.replace(
        tiny_config(tmp_path, training_steps=10), checkpoint_auto=True, ckpt_auto_floor=1,
        ckpt_auto_ceiling=3, checkpoint_frequency=0)
    out = train(cfg)
    exp = tmp_path / "default-exp"
    evs = [json.loads(x) for x in (exp / "default-exp_telemetry.jsonl").read_text().splitlines()]
    recs = [e for e in evs if e["event"] == "ckpt_policy"]
    saved = [e for e in evs if e["event"] == "ckpt_saved"]
    assert recs and recs[0]["source"] == "bootstrap"
    assert all(1 <= r["interval_steps"] <= 3 for r in recs)
    # each periodic save lands where the decision before it said
    periodic = [e["step"] for e in saved if not e["final"]]
    want, nxt = [], recs[0]["interval_steps"]
    for r in recs[1:]:
        want.append(nxt)
        nxt = r["step"] + r["interval_steps"]
    assert periodic == want and [r["step"] for r in recs[1:]] == periodic
    assert [e["step"] for e in saved if e["final"]] == [10]  # never skipped under auto
    # the cost it learned is the zerostall blocking it measured (the first
    # observation replaces the prior), less the one-off pinning of the
    # buffer sets that the run's first save pays
    first = next(s for s in out["saves"] if s["path"].endswith(f"ckpt_{periodic[0]}.zs.json"))
    assert recs[1]["cost_s"] == round(first["blocking_s"] - first["alloc_s"], 6)
    assert [s["alloc_s"] for s in out["saves"][1:]] == [0.0] * (len(out["saves"]) - 1)
    assert recs[1]["engine"] == "zerostall"
    # the JAX package's reconstruction and summarizer read the port's stream
    from summarize_telemetry import aggregate

    port_h, ref_h = FailureHistory(tmp_path / "p"), jax_autopilot.FailureHistory(tmp_path / "j")
    stream = evs + [{"event": "run_start", "ts": evs[-1]["ts"] + 1, "host": 0}]
    assert reconstruct_history(stream, port_h) == jax_autopilot.reconstruct_history(stream,
                                                                                     ref_h)
    assert port_h.interruptions == ref_h.interruptions == []
    agg = aggregate(evs)["autopilot"]
    assert agg["decisions"] == len(recs) and agg["last"]["interval_steps"] == \
        recs[-1]["interval_steps"]
    assert (exp / SIDECAR_NAME).exists()
    assert CheckpointAutopilot(exp, engine="zerostall", static_interval=10).interval_steps == \
        recs[-1]["interval_steps"]
