"""The port's live telemetry plane (``pyrecover_tpu_torch/telemetry/{exporter,
aggregate,top}.py``) held to the JAX package's on the same inputs: one
registry fed the same observations renders the same Prometheus text in both
packages, the SLO evaluators fire and clear the same ``slo_alert`` sequence
over the same snapshot series, and histograms merge to the same buckets.
Then the port alone over real TCP: the exporter round-trips and stops inside
its bound, the aggregator flags a stale target and never goes negative on a
restart, the two-process fleet drill holds, and ``top --once`` renders."""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from pyrecover_tpu import telemetry as jax_telemetry
from pyrecover_tpu.telemetry import aggregate as jax_aggregate
from pyrecover_tpu.telemetry import exporter as jax_exporter
from pyrecover_tpu.telemetry import metrics as jax_metrics
from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.telemetry import aggregate, exporter, metrics, top


@pytest.fixture()
def sinks():
    """A memory sink on each package's bus, both registries empty."""
    port, ref = telemetry.MemorySink(), jax_telemetry.MemorySink()
    telemetry.add_sink(port)
    jax_telemetry.add_sink(ref)
    metrics.reset()
    jax_metrics.reset()
    yield port, ref
    telemetry.remove_sink(port)
    jax_telemetry.remove_sink(ref)
    metrics.reset()
    jax_metrics.reset()


def _body(events, name):
    """The events called ``name``, without the envelope's clock and host."""
    return [{k: v for k, v in e.items() if k not in ("ts", "host")}
            for e in events if e["event"] == name]


def _feed(rng, n=200):
    """Seeded observations for both registries: counters, gauges, and
    histograms spanning the zero bucket to minutes."""
    for mod in (metrics, jax_metrics):
        mod.counter("reqs_total").inc(7)
        mod.counter("serving_backpressure_total").inc(3)
        mod.gauge("occupancy_pct").set(42.5)
        mod.gauge("train_step").set(12)
    values = np.concatenate([rng.lognormal(-3.0, 1.5, n), np.zeros(5), [1e-6, 300.0]])
    for v in values.tolist():
        for mod in (metrics, jax_metrics):
            mod.histogram("e2e_s").observe(v)
            mod.histogram("step_iter_s").observe(v / 10.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_prometheus_equals_jax(sinks, seed):
    _feed(np.random.default_rng(seed))
    port = exporter.render_prometheus(metrics.snapshot(raw_buckets=True))
    ref = jax_exporter.render_prometheus(jax_metrics.snapshot(raw_buckets=True))
    assert port == ref
    assert 'pyrecover_e2e_s_bucket{le="+Inf"} 207' in port
    counts = [int(line.rsplit(" ", 1)[1]) for line in port.splitlines()
              if line.startswith("pyrecover_e2e_s_bucket")]
    assert counts == sorted(counts), "buckets not cumulative"


@pytest.mark.parametrize("spec", ["", "request_p99>0.5,step_regress>1.5@10",
                                  " backpressure_duty>0.25 , request_p99>2@5 "])
def test_parse_alert_rules_equals_jax(spec):
    port = [r.as_dict() for r in exporter.parse_alert_rules(spec)]
    assert port == [r.as_dict() for r in jax_exporter.parse_alert_rules(spec)]
    assert exporter.DEFAULT_RULES == jax_exporter.DEFAULT_RULES
    with pytest.raises(ValueError):
        exporter.parse_alert_rules("request_p99")
    with pytest.raises(ValueError):
        exporter.parse_alert_rules("latency>1")


def _alert_series(rng):
    """Per interval: (e2e values, step values, backpressure bumps) -- a
    request tail that breaches then recovers, steady steps then a 10x
    regression, and bursts of backpressure."""
    series = []
    for i in range(14):
        e2e = rng.lognormal(-4.0, 0.5, 20).tolist()
        if i in (3, 4, 10):
            e2e += [1.5, 2.5]
        steps = (rng.normal(0.01, 0.0005, 5) * (10.0 if i in (8, 9) else 1.0)).tolist()
        series.append((e2e, steps, int(i in (2, 3, 4, 5, 11))))
    return series


@pytest.mark.parametrize("seed", [0, 7])
def test_alert_sequences_equal_jax(sinks, seed):
    port_sink, ref_sink = sinks
    rules = "request_p99>0.5@60,step_regress>2.0@60,backpressure_duty>0.5@4"
    port = exporter._AlertEvaluator(exporter.parse_alert_rules(rules))
    ref = jax_exporter._AlertEvaluator(jax_exporter.parse_alert_rules(rules))
    fired_port, fired_ref = [], []
    for i, (e2e, steps, bumps) in enumerate(_alert_series(np.random.default_rng(seed))):
        for mod in (metrics, jax_metrics):
            for v in e2e:
                mod.histogram("e2e_s").observe(v)
            for v in steps:
                mod.histogram("step_iter_s").observe(v)
            mod.counter("serving_backpressure_total").inc(bumps)
        now = 100.0 + i
        fired_port += [(r.name, s, round(v, 9))
                       for r, s, v in port.evaluate(metrics.snapshot(raw_buckets=True), now=now)]
        fired_ref += [(r.name, s, round(v, 9)) for r, s, v in
                      ref.evaluate(jax_metrics.snapshot(raw_buckets=True), now=now)]
    assert fired_port == fired_ref
    kinds = {name for name, _, _ in fired_port}
    assert kinds == {"request_p99", "step_regress", "backpressure_duty"}
    assert {s for _, s, _ in fired_port} == {"firing", "cleared"}
    assert _body(port_sink.events, "slo_alert") == _body(ref_sink.events, "slo_alert")
    assert port.states() == ref.states()
    assert metrics.counter("slo_alerts_total").value == \
        jax_metrics.counter("slo_alerts_total").value > 0


def test_delta_tracker_rebaselines_on_reset():
    tracker = exporter._DeltaTracker()
    assert tracker.feed(None) == (None, 0)
    delta, n = tracker.feed({"count": 3, "buckets": {"0": 2, "zero": 1}})
    assert n == 3 and delta == {0: 2, None: 1}
    assert tracker.feed({"count": 3, "buckets": {"0": 2, "zero": 1}}) == (None, 0)
    # a registry reset (count backwards) re-baselines, never negative
    delta, n = tracker.feed({"count": 1, "buckets": {"4": 1}})
    assert n == 1 and delta == {4: 1}


@pytest.mark.parametrize("seed", [0, 3])
def test_merge_raw_hists_equals_jax(sinks, seed):
    rng = np.random.default_rng(seed)
    parts = []
    for k in range(3):
        name = f"part{k}_s"
        for v in np.concatenate([rng.lognormal(-2.0, 2.0, 30), [0.0]]).tolist():
            metrics.histogram(name).observe(v)
        parts.append(metrics.histogram(name).raw())
    merged = aggregate.merge_raw_hists(parts + [None, {}])
    assert merged == jax_aggregate.merge_raw_hists(parts + [None, {}])
    assert merged["count"] == 93
    ref = metrics.Histogram("ref_s")
    for p in parts:
        for key, n in p["buckets"].items():
            ref.buckets[metrics.bucket_from_key(key)] = \
                ref.buckets.get(metrics.bucket_from_key(key), 0) + n
    assert merged["buckets"] == {metrics.bucket_key(k): n for k, n in ref.buckets.items()}
    assert aggregate.merge_raw_hists([None, {}]) is None


@pytest.mark.parametrize("target", ["127.0.0.1:9100", ":9100", "http://h:1/", "host:2"])
def test_normalize_target_equals_jax(target):
    assert aggregate.normalize_target(target) == jax_aggregate.normalize_target(target)


def test_exporter_roundtrip_and_bounded_stop(sinks):
    port_sink, _ = sinks
    metrics.counter("served_total").inc(11)
    metrics.histogram("e2e_s").observe(0.25)
    ex = exporter.MetricsExporter(port=0).start()
    try:
        assert ex.port != 0
        with urllib.request.urlopen(f"{ex.url}/metrics", timeout=5) as resp:
            body = resp.read().decode()
            assert resp.headers["Content-Type"].startswith("text/plain")
        assert "pyrecover_served_total 11" in body
        assert "pyrecover_e2e_s_count 1" in body
        snap = aggregate.scrape(f"127.0.0.1:{ex.port}", timeout_s=5)
        assert snap["counters"]["served_total"] == 11
        assert snap["hists"]["e2e_s"]["buckets"]
        assert snap["pid"] and snap["start_ts"] and snap["seq"] >= 1
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{ex.url}/nope", timeout=5)
        assert err.value.code == 404
    finally:
        t0 = time.monotonic()
        ex.stop(timeout=5.0)
        stop_s = time.monotonic() - t0
    assert ex._thread is None and stop_s < 5.0
    (started,) = _body(port_sink.events, "exporter_started")
    assert started["port"] == ex.port and started["url"] == ex.url
    assert [r["kind"] for r in started["rules"]] == list(exporter.AlertRule.KINDS)
    (stopped,) = _body(port_sink.events, "exporter_stopped")
    assert stopped["scrapes"] >= 2 and stopped["uptime_s"] >= 0


def test_maybe_start_from_env(sinks, monkeypatch):
    monkeypatch.delenv(exporter.PORT_ENV, raising=False)
    assert exporter.maybe_start_from_env() is None
    monkeypatch.setenv(exporter.PORT_ENV, "0")
    monkeypatch.setenv(exporter.RULES_ENV, "request_p99>0.25")
    ex = exporter.maybe_start_from_env()
    try:
        assert ex is not None and ex.port != 0
        assert [r.as_dict() for r in ex.rules] == \
            [r.as_dict() for r in jax_exporter.default_alert_rules()]
        assert aggregate.scrape(f"127.0.0.1:{ex.port}")["seq"] >= 1
    finally:
        ex.stop()


def test_aggregator_flags_stale_target_and_keeps_its_totals(sinks):
    port_sink, _ = sinks
    metrics.counter("reqs_total").inc(5)
    metrics.gauge("tokens_per_sec").set(100.0)
    metrics.histogram("lat_s").observe(0.05)
    ex = exporter.MetricsExporter(port=0).start()
    try:
        agg = aggregate.FleetAggregator([f"127.0.0.1:{ex.port}", "127.0.0.1:1"],
                                        stale_after_s=10.0, timeout_s=0.5)
        fleet = agg.poll()
    finally:
        ex.stop()
    assert fleet["n_targets"] == 2 and fleet["n_ok"] == 1
    assert fleet["stale"] == ["127.0.0.1:1"]
    assert fleet["targets"]["127.0.0.1:1"]["error"]
    assert fleet["counters"]["reqs_total"] == 5
    assert fleet["gauges"]["tokens_per_sec"]["sum"] == 100.0
    assert fleet["hists"]["lat_s"]["count"] == 1
    (ev,) = _body(port_sink.events, "metrics_scrape")
    assert (ev["targets"], ev["ok"], ev["stale"]) == (2, 1, 1)


def test_target_restart_never_negative_equals_jax():
    def lifetime(pid, reqs, count):
        return {"pid": pid, "start_ts": float(pid), "seq": 1, "gauges": {},
                "counters": {"reqs_total": reqs},
                "hists": {"lat_s": {"count": count, "sum": 0.1 * count, "min": 0.1,
                                    "max": 0.2, "buckets": {"0": count}}}}

    feeds = [lifetime(100, 10, 2), lifetime(200, 3, 1), lifetime(200, 1, 1),
             lifetime(200, 4, 3)]
    port, ref = aggregate._Target("127.0.0.1:9"), jax_aggregate._Target("127.0.0.1:9")
    for i, snap in enumerate(feeds):
        port.feed(snap, now=100.0 + i)
        ref.feed(snap, now=100.0 + i)
        assert port.counters() == ref.counters()
        assert port.hists() == ref.hists()
        assert all(v >= 0 for v in port.counters().values())
    assert port.restarts == ref.restarts == 2
    assert port.counters() == {"reqs_total": 17}


def test_fleet_drill_two_processes(tmp_path):
    """Two separate exporter processes merged over TCP, then one SIGKILLed
    and reported stale, its totals kept."""
    report = aggregate.fleet_drill(tmp_path)
    assert report["targets"] == 2
    assert report["merged_requests_total"] == 12
    assert report["stale_after_kill"] == [report["killed"]]


def test_top_once_json_and_render(sinks, capsys):
    metrics.counter("serving_tokens_total").inc(42)
    metrics.counter("weights_swaps_total").inc(2)
    metrics.gauge("kv_pool_occupancy_pct").set(31.25)
    metrics.gauge("serving_tokens_per_sec").set(640.0)
    metrics.gauge("hotswap_loaded_step").set(6)
    metrics.histogram("e2e_s").observe(0.12)
    metrics.histogram("step_iter_s").observe(0.02)
    ex = exporter.MetricsExporter(port=0).start()
    try:
        target = f"127.0.0.1:{ex.port}"
        assert top.main([target, "--once", "--json"]) == 0
        fleet = json.loads(capsys.readouterr().out)
        assert fleet["n_ok"] == 1 and fleet["counters"]["serving_tokens_total"] == 42
        assert top.main([target, "--once"]) == 0
        text = capsys.readouterr().out
    finally:
        ex.stop()
    assert "ok]" in text and target in text
    assert "e2e" in text and "step time" in text and "31.2" in text
    assert "loaded step    6" in text and "swaps 2" in text


def test_trainer_serves_its_registry_for_the_run(tmp_path, monkeypatch):
    """``$PYRECOVER_METRICS_PORT`` makes ``train`` start the exporter after
    its sinks and stop it on the unwind: ``exporter_started`` follows
    ``run_start``'s sinks into the stream, ``exporter_stopped`` precedes the
    end, and the throughput gauges the live plane serves are set."""
    import torch

    from pyrecover_tpu_torch import train

    torch.set_num_threads(1)
    monkeypatch.setenv(exporter.PORT_ENV, "0")
    metrics.reset()
    out = train.main(["--device", "cpu", "--training-steps", "3", "--batch-size", "2",
                      "--sequence-length", "32", "--model-dim", "32", "--model-layers", "1",
                      "--model-heads", "2", "--model-kv-heads", "1", "--vocab-size", "64",
                      "--logging-frequency", "1", "--checkpoint-frequency", "0",
                      "--checkpoint-dir", str(tmp_path), "--telemetry"])
    events = telemetry.read_events(out["telemetry_path"])
    names = [e["event"] for e in events]
    assert names.index("exporter_started") < names.index("exporter_stopped")
    (started,) = [e for e in events if e["event"] == "exporter_started"]
    assert started["port"] > 0 and started["url"].endswith(str(started["port"]))
    snap = metrics.snapshot()
    assert snap["gauges"]["train_step"] == 3
    assert snap["gauges"]["train_tokens_per_sec"] > 0
    assert snap["hists"]["step_iter_s"]["count"] == 3


def test_serving_smoke_scrapes_mid_run_and_after_the_drain(tmp_path):
    """The serving smoke serves its registry over TCP for the whole run:
    one scrape mid-run, one after the drain, digested as the JAX package's
    ``live_scrape_digest`` digests the same snapshot."""
    import torch

    from pyrecover_tpu.serving import loadgen as jax_loadgen
    from pyrecover_tpu_torch.serving import loadgen

    torch.set_num_threads(1)
    report = loadgen.serving_smoke(tmp_path, n_requests=6, device="cpu")
    mid, final = report["live_scrape"]["mid"], report["live_scrape"]["final"]
    assert final["seq"] > mid["seq"] >= 1
    assert 0 < mid["e2e_count"] <= final["e2e_count"] == 6
    assert final["kv_peak_occupancy_pct"] > 0 and final["tokens_per_sec"] is not None
    snap = {"seq": 3, "counters": {"serving_backpressure_total": 2},
            "gauges": {"serving_tokens_per_sec": 5.0, "kv_pool_occupancy_pct": 12.5},
            "hists": {"e2e_s": {"count": 4, "p99": 0.5}, "step_iter_s": {"count": 2, "p50": 0.1}}}
    assert loadgen.live_scrape_digest(snap) == jax_loadgen.live_scrape_digest(snap)
