"""The port's ``telemetry/traceview.py`` held to the JAX package's on the same
JSONL shards: seeded, clock-skewed multi-host streams (numpy jitter on the
step times, a spike, a checkpoint save span pair, retroactive spans, a torn
shard) give equal clock offsets, equal analysis reports and equal Chrome
traces from both packages, and both CLIs return the same exit codes: 0
merged, 1 a checkpoint-phase regression against a baseline, 2 no events."""

import json

import numpy as np
import pytest

from pyrecover_tpu.telemetry import traceview as jax_traceview
from pyrecover_tpu_torch.telemetry import traceview


def write_shard(path, events):
    path.write_text("".join(json.dumps(e) + "\n" for e in events))
    return path


def synth_host(host, rng, *, skew=0.0, iter_s=0.010, steps=20, spike_at=None,
               ckpt_write_s=0.05, retro=True):
    """One host's shard: per-step ``step_time``/``train_sync`` events with
    seeded jitter, a checkpoint save span pair with a nested write, and
    (``retro``) buffered ``span`` events, on a wall clock shifted by
    ``skew`` seconds."""
    t = 1000.0 + skew
    mono = 500.0 + 37.0 * host  # monotonic epochs are arbitrary per host
    events = [{"event": "run_start", "ts": t, "host": host, "devices": 8}]
    for step in range(1, steps + 1):
        dt = float(iter_s * rng.uniform(0.9, 1.1) * (10.0 if step == spike_at else 1.0))
        t += dt
        mono += dt
        events.append({"event": "step_time", "ts": t, "host": host, "step": step,
                       "data_wait_s": 0.001, "dispatch_s": dt - 0.001})
        events.append({"event": "train_sync", "ts": t, "host": host, "step": step,
                       "loss": 5.0 - 0.01 * step, "steps": 1, "interval_s": dt,
                       "iter_s": dt, "sync_s": 0.0005})
        if retro and step % 5 == 0:
            # a buffered span: emitted at the sync point, begun dt earlier
            events.append({"event": "span", "ts": t + 0.002, "host": host,
                           "name": "loss_sync", "span": 100 + step, "parent": None,
                           "tid": 1, "mono": mono - dt, "dur_s": dt, "step": step})
    sid, wid = 900 + host * 10, 901 + host * 10
    events += [
        {"event": "ckpt_save_start", "ts": t + 0.001, "host": host, "engine": "vanilla",
         "path": "ckpt_20.ckpt"},
        {"event": "span_begin", "ts": t + 0.001, "host": host, "name": "ckpt_save",
         "span": sid, "parent": None, "tid": 1, "thread": "MainThread", "mono": mono + 0.001,
         "engine": "vanilla"},
        {"event": "span_begin", "ts": t + 0.002, "host": host, "name": "ckpt_write",
         "span": wid, "parent": sid, "tid": 2, "thread": "ckpt-writer", "mono": mono + 0.002,
         "engine": "vanilla"},
        {"event": "span_end", "ts": t + 0.002 + ckpt_write_s, "host": host,
         "name": "ckpt_write", "span": wid, "parent": sid, "tid": 2,
         "mono": mono + 0.002 + ckpt_write_s, "dur_s": ckpt_write_s, "engine": "vanilla"},
        {"event": "span_end", "ts": t + 0.003 + ckpt_write_s, "host": host,
         "name": "ckpt_save", "span": sid, "parent": None, "tid": 1,
         "mono": mono + 0.003 + ckpt_write_s, "dur_s": ckpt_write_s + 0.002,
         "engine": "vanilla"},
        {"event": "ckpt_commit", "ts": t + 0.003 + ckpt_write_s, "host": host,
         "engine": "vanilla", "path": "ckpt_20.ckpt", "bytes": 1000, "write_s": ckpt_write_s},
    ]
    return events


CASES = {
    # host 0 on time; host 1 twice as slow with a 120 s wall-clock skew
    "skewed_two_hosts": lambda rng: [
        synth_host(0, rng), synth_host(1, rng, skew=120.0, iter_s=0.020)],
    # four hosts, adversarial skews both ways, a spike and a slow writer
    "four_hosts_spike": lambda rng: [
        synth_host(0, rng, skew=-3.5), synth_host(1, rng, skew=640.0, spike_at=12),
        synth_host(2, rng, skew=-0.25, iter_s=0.011, ckpt_write_s=0.2),
        synth_host(3, rng, skew=7.0, retro=False)],
    # a host that died mid-save: both spans torn, no commit
    "torn_shard": lambda rng: [synth_host(0, rng), synth_host(1, rng, skew=2.0)[:-3]],
    # shards from two runs that share no anchors merge unaligned
    "disjoint": lambda rng: [synth_host(0, rng), [
        {"event": "run_start", "ts": 5000.0, "host": 3},
        {"event": "train_sync", "ts": 5001.0, "host": 3, "step": 999, "iter_s": 0.01,
         "steps": 1}]],
}


def _paths(tmp_path, case, seed):
    shards = CASES[case](np.random.default_rng(seed))
    return [write_shard(tmp_path / f"{case}_{i}.jsonl", events) for i, events in enumerate(shards)]


def _both(paths):
    port, ref = traceview.load_shards(paths), jax_traceview.load_shards(paths)
    traceview.align_clocks(port)
    jax_traceview.align_clocks(ref)
    return port, ref


def _trace_body(trace):
    other = dict(trace["otherData"])
    other.pop("tool")  # names the package
    return {**trace, "otherData": other}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reports_and_chrome_traces_equal_jax(tmp_path, case, seed):
    port, ref = _both(_paths(tmp_path, case, seed))
    assert [s.offset for s in port] == [s.offset for s in ref]
    assert [traceview.pair_spans(s) for s in port] == [jax_traceview.pair_spans(s) for s in ref]
    baseline = {"vanilla:ckpt_write": 0.01, "vanilla:ckpt_save": 1.0}
    assert traceview.analyze(port, baseline=baseline) == \
        jax_traceview.analyze(ref, baseline=baseline)
    assert _trace_body(traceview.to_chrome_trace(port)) == \
        _trace_body(jax_traceview.to_chrome_trace(ref))
    assert traceview.to_chrome_trace(port)["otherData"]["tool"] == "pyrecover_tpu_torch traceview"


def test_skew_recovered_and_straggler_named(tmp_path):
    port, _ = _both(_paths(tmp_path, "skewed_two_hosts", 0))
    by_host = {s.host: s for s in port}
    assert by_host[0].offset == 0.0
    assert by_host[1].offset == pytest.approx(-120.0, abs=1.0)
    report = traceview.analyze(port)
    assert report["step_times"]["straggler"]["host"] == 1


def test_spike_flagged(tmp_path):
    port, _ = _both(_paths(tmp_path, "four_hosts_spike", 0))
    spikes = traceview.analyze(port)["step_times"]["spikes"]
    assert [(s["host"], s["step"]) for s in spikes] == [(1, 12)]


def test_torn_spans_closed_not_dropped(tmp_path):
    port, _ = _both(_paths(tmp_path, "torn_shard", 0))
    torn = [s for s in traceview.pair_spans(port[1]) if s["args"].get("truncated")]
    assert sorted(s["name"] for s in torn) == ["ckpt_save", "ckpt_write"]


@pytest.mark.parametrize("mode", ["merged", "regression", "no_events"])
def test_cli_exit_codes_equal_jax(tmp_path, capsys, mode):
    paths = [str(p) for p in _paths(tmp_path, "skewed_two_hosts", 0)]
    base = tmp_path / "base.json"
    base.write_text(json.dumps({"vanilla:ckpt_write": 0.001}))
    argv = {"merged": paths + ["--out", str(tmp_path / "{pkg}.json"),
                               "--report-json", str(tmp_path / "{pkg}_report.json"),
                               "--write-baseline", str(tmp_path / "{pkg}_base.json")],
            "regression": paths + ["--baseline", str(base)],
            "no_events": [str(tmp_path / "missing.jsonl")]}[mode]
    rcs = {}
    for pkg, main in (("port", traceview.main), ("jax", jax_traceview.main)):
        rcs[pkg] = main([a.format(pkg=pkg) for a in argv])
        capsys.readouterr()
    assert rcs["port"] == rcs["jax"] == {"merged": 0, "regression": 1, "no_events": 2}[mode]
    if mode == "merged":
        for name in ("{}_report.json", "{}_base.json"):
            assert json.loads((tmp_path / name.format("port")).read_text()) == \
                json.loads((tmp_path / name.format("jax")).read_text())
        assert _trace_body(json.loads((tmp_path / "port.json").read_text())) == \
            _trace_body(json.loads((tmp_path / "jax.json").read_text()))
