"""The port's telemetry core (bus, sinks, tracing, spans, the metrics flush,
``WallTimeTotals``) held to the JAX package's.

The same emits through each package's bus and ``JsonlSink`` give equal
records once the clocks (``ts``, ``mono``, ``dur_s``) and process-local ids
(``span``, ``parent``, ``tid``) are masked; each package's ``read_events``
and ``last_recorded_step`` read the other's files, rotated shards included;
``metrics.flush`` snapshots and the goodput ledger equal the JAX ones on the
same inputs; ``collective_phase`` times out, emits and dumps a bundle.
"""

import json
import threading
import time

import pytest
import torch

from pyrecover_tpu import telemetry as jax_tel
from pyrecover_tpu.metrics import WallTimeTotals as JaxTotals
from pyrecover_tpu_torch import telemetry as port_tel
from pyrecover_tpu_torch.metrics import WallTimeTotals as PortTotals
from pyrecover_tpu_torch.telemetry import bus as port_bus
from pyrecover_tpu_torch.telemetry import tracing as port_tracing

PACKAGES = {"jax": jax_tel, "torch": port_tel}
CLOCKS_AND_IDS = ("ts", "mono", "dur_s", "span", "parent", "tid", "thread")


@pytest.fixture(autouse=True)
def _clean():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for tel in PACKAGES.values():
        tel.close()
        tel.metrics.reset()
        tel.flight.uninstall()
    yield
    for tel in PACKAGES.values():
        tel.close()
        tel.metrics.reset()
        tel.flight.uninstall()
    torch.set_num_threads(threads)


def masked(records):
    return [{k: v for k, v in r.items() if k not in CLOCKS_AND_IDS} for r in records]


def drive(tel):
    """One fixed sequence of producer calls through ``tel``'s API."""
    tel.emit("run_start", devices=1, device_kind="cpu", params_m=0.5)
    with tel.span("ckpt_save", step=2, final=False, engine="vanilla"):
        with tel.span("ckpt_write", engine="vanilla"):
            tel.emit("ckpt_commit", engine="vanilla", path="p", bytes=10, write_s=0.5,
                     checksum=True)
    with pytest.raises(ValueError):
        with tel.span("eval", step=2):
            raise ValueError("boom")
    t0 = time.monotonic()
    sid = tel.record_span("step", t0, t0 + 0.25, step=3)
    tel.record_span("data_wait", t0, t0 + 0.05, step=3, parent=sid, metric="step_data_wait_s")
    for v in (0.0, 1e-3, 0.02, 0.02, 3.0):
        tel.metrics.histogram("loader_wait_s").observe(v)
    tel.metrics.histogram("step_iter_s").observe(0.25, n=4)
    tel.metrics.counter("recompile_total").inc(2)
    tel.metrics.gauge("train_step").set(3)
    tel.metrics.flush(reason="run_end")
    tel.emit("run_summary", status="finished", step=3, goodput_pct=50.0)


def test_same_emits_give_equal_jsonl_records(tmp_path):
    recs = {}
    for name, tel in PACKAGES.items():
        path = tmp_path / f"{name}.jsonl"
        sink = tel.add_sink(tel.JsonlSink(path, append=False))
        drive(tel)
        tel.remove_sink(sink)
        recs[name] = tel.read_events(path)
    assert [r["event"] for r in recs["torch"]] == [r["event"] for r in recs["jax"]]
    assert masked(recs["torch"]) == masked(recs["jax"])
    # the span tree has the same shape: ckpt_write's parent is ckpt_save
    by = {r["name"]: r for r in recs["torch"] if r["event"] == "span_begin"}
    assert by["ckpt_write"]["parent"] == by["ckpt_save"]["span"]
    ends = [r for r in recs["torch"] if r["event"] == "span_end" and r["name"] == "eval"]
    assert ends[0]["ok"] is False and ends[0]["error"] == "ValueError: boom"


def test_emit_noop_without_sinks_and_null_spans():
    assert not port_tel.enabled()
    assert port_tel.emit("anything", x=1) is None
    assert port_tel.span("x") is port_tel.spans._NULL
    assert port_tel.spans.begin("x") is port_tel.spans._NULL
    assert port_tel.record_span("x", 0.0, 1.0) is None


def test_envelope_wins_and_broken_sink_is_disabled():
    class Broken:
        def write(self, rec):
            raise OSError("disk on fire")

    good = port_tel.add_sink(port_tel.MemorySink())
    port_tel.add_sink(Broken())
    port_tel.emit("e", event="spoofed", host=99)
    port_tel.emit("f")
    assert [e["event"] for e in good.events] == ["e", "f"]
    assert good.events[0]["host"] == 0


def test_process_index_comes_from_torch_distributed(monkeypatch):
    sink = port_tel.add_sink(port_tel.MemorySink())
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 3)
    port_bus.reset_process_index()
    port_tel.emit("a")
    monkeypatch.undo()
    port_bus.reset_process_index()
    port_tel.emit("b")
    assert [e["host"] for e in sink.events] == [3, 0]


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax"),
                                           ("torch", "torch")])
def test_read_back_across_packages_with_rotation(tmp_path, writer, reader):
    w, r = PACKAGES[writer], PACKAGES[reader]
    path = tmp_path / "run_telemetry.jsonl"
    sink = w.add_sink(w.JsonlSink(path, append=False, max_bytes=300, keep=20))
    for step in range(1, 31):
        w.emit("step_time", step=step, data_wait_s=0.001, dispatch_s=0.01)
    w.remove_sink(sink)
    assert len(r.rotated_paths(path)) > 2
    assert [e["step"] for e in r.read_events(path)] == list(range(1, 31))
    # append on resume continues the same stream
    sink = w.add_sink(w.JsonlSink(path, append=True, max_bytes=300, keep=20))
    w.emit("step_time", step=31, data_wait_s=0.0, dispatch_s=0.0)
    w.remove_sink(sink)
    with open(path, "a") as f:
        f.write('{"event": "step_time", "step": 99')  # a kill mid-write
    events = r.read_events(path)
    assert [e["step"] for e in events] == list(range(1, 32))
    assert r.last_recorded_step(path) == 31


def test_fresh_sink_clears_rotated_shards(tmp_path):
    path = tmp_path / "t.jsonl"
    sink = port_tel.add_sink(port_tel.JsonlSink(path, append=False, max_bytes=100))
    for i in range(10):
        port_tel.emit("x", i=i)
    port_tel.remove_sink(sink)
    assert port_tel.rotated_paths(path)
    port_tel.JsonlSink(path, append=False).close()
    assert port_tel.rotated_paths(path) == []
    assert jax_tel.read_events(path) == []


def test_log_sink_mirrors_events(caplog):
    import logging

    port_tel.add_sink(port_tel.LogSink())
    with caplog.at_level(logging.INFO, logger="pyrecover_tpu_torch"):
        port_tel.emit("ckpt_saved", step=4, path="ckpt_4.ckpt")
    assert "telemetry | ckpt_saved step=4 path=ckpt_4.ckpt" in caplog.text


def test_metrics_snapshots_equal_the_jax_registry():
    snaps = {}
    for name, tel in PACKAGES.items():
        for v in (0.0, 1e-6, 2e-4, 0.05, 0.05, 1.7, 300.0):
            tel.metrics.histogram("h").observe(v)
        tel.metrics.histogram("w").observe(0.3, n=5)
        tel.metrics.counter("c").inc(7)
        tel.metrics.gauge("g").set(1.5)
        snaps[name] = (tel.metrics.snapshot(), tel.metrics.snapshot(raw_buckets=True))
    assert snaps["torch"] == snaps["jax"]
    for key in ("zero", "-3", "12"):
        idx = port_tel.metrics.bucket_from_key(key)
        assert port_tel.metrics.bucket_key(idx) == key
        assert idx == jax_tel.metrics.bucket_from_key(key)


def test_flush_and_maybe_flush_rate_limit():
    sink = port_tel.add_sink(port_tel.MemorySink())
    port_tel.metrics.counter("c").inc()
    rec = port_tel.metrics.maybe_flush(interval_s=60.0)  # the first call flushes
    assert rec["event"] == "metrics_snapshot" and rec["reason"] == "interval"
    assert port_tel.metrics.maybe_flush(interval_s=60.0) is None
    assert port_tel.metrics.maybe_flush(interval_s=0.0)["counters"] == {"c": 1}
    assert [e["event"] for e in sink.events] == ["metrics_snapshot"] * 2
    port_tel.metrics.reset()
    assert port_tel.metrics.flush() is None  # an empty registry emits nothing


def test_span_metric_feeds_its_histogram():
    port_tel.add_sink(port_tel.MemorySink())
    with port_tel.span("ckpt_write", metric="ckpt_vanilla_write_s"):
        pass
    port_tel.record_span("io_retry", 1.0, 1.5, metric="io_retry_latency_s")
    hists = port_tel.metrics.snapshot()["hists"]
    assert hists["ckpt_vanilla_write_s"]["count"] == 1
    assert hists["io_retry_latency_s"]["sum"] == 0.5


TOTALS_CASES = {
    "fresh": dict(train_s=10.0, step_s=8.0, ckpt_save_s=1.0, ckpt_blocking_s=1.0,
                  setup_s=2.0, wall_s=12.5),
    "resumed": dict(train_s=20.0, step_s=18.0, ckpt_save_s=0.5, ckpt_blocking_s=0.5,
                    ckpt_shadow_s=3.0, ckpt_load_s=4.0, eval_s=1.0, setup_s=1.5,
                    wall_s=27.0, replayed_steps=3, replayed_s=2.25),
    "no_wall": dict(train_s=5.0, step_s=4.0, ckpt_load_s=1.0, setup_s=1.0),
    "empty": {},
}


@pytest.mark.parametrize("case", list(TOTALS_CASES))
def test_walltime_totals_equal_the_jax_ledger(case):
    a, b = PortTotals(), JaxTotals()
    for k, v in TOTALS_CASES[case].items():
        setattr(a, k, v)
        setattr(b, k, v)
    assert a.as_dict() == b.as_dict()
    assert a.summary() == b.summary()
    assert a.goodput_pct() == b.goodput_pct() and a.lost_s() == b.lost_s()


def test_spans_nest_per_thread():
    sink = port_tel.add_sink(port_tel.MemorySink())
    seen = {}

    def worker():
        with port_tel.span("loader_wait"):
            seen["inner"] = port_tel.spans.current_span_id()

    with port_tel.span("ckpt_save") as outer:
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        assert port_tel.spans.current_span_id() == outer.span_id
    begins = {e["name"]: e for e in sink.events if e["event"] == "span_begin"}
    assert begins["loader_wait"]["parent"] is None  # another thread's stack
    assert seen["inner"] == begins["loader_wait"]["span"]


def test_tracing_context_reaches_retroactive_spans():
    sink = port_tel.add_sink(port_tel.MemorySink())
    ctx = port_tracing.mint("rid-7")
    assert ctx.trace == jax_tel.tracing.trace_id("rid-7")
    assert port_tracing.from_wire(ctx.to_wire()).to_wire() == ctx.to_wire()
    with port_tracing.installed(ctx):
        port_tel.record_span("req_queue", 0.0, 1.0, rid="rid-7")
    with port_tracing.installed(None):
        port_tel.record_span("req_decode", 1.0, 2.0, rid="rid-7")
    q, d = sink.events
    assert q["trace"] == ctx.trace and q["parent"] == ctx.span and q["attempt"] == 1
    assert "trace" not in d and d["parent"] is None


def test_collective_phase_times_out_emits_and_dumps(tmp_path):
    sink = port_tel.add_sink(port_tel.MemorySink())
    port_tel.flight.install(tmp_path, enable_faulthandler=False)
    with port_tel.collective_phase("grad_allreduce", timeout_s=0.1, step=5):
        time.sleep(0.5)  # a peer that never arrives
    names = [e["event"] for e in sink.events]
    assert "distributed_wait_timeout" in names
    timeout = next(e for e in sink.events if e["event"] == "distributed_wait_timeout")
    assert timeout["phase"] == "grad_allreduce" and timeout["timeout_s"] == 0.1
    begin = next(e for e in sink.events if e["event"] == "span_begin")
    assert begin["name"] == "collective_wait" and begin["phase"] == "grad_allreduce"
    bundles = port_tel.flight.list_bundles(tmp_path)
    assert len(bundles) == 1
    manifest = json.loads((bundles[0] / "MANIFEST.json").read_text())
    assert manifest["reason"] == "distributed_wait_timeout"
    # the bundle names the open collective phase for the doctor
    spans = json.loads((bundles[0] / "open_spans.json").read_text())
    assert [s["name"] for s in spans] == ["collective_wait"]
    # a phase that finishes in time emits no timeout
    sink.events.clear()
    with port_tel.collective_phase("barrier", timeout_s=5.0):
        pass
    assert "distributed_wait_timeout" not in [e["event"] for e in sink.events]
    assert port_tel.metrics.snapshot()["hists"]["collective_wait_s"]["count"] == 2


def test_log_host0_logs_on_rank_0_only(monkeypatch, caplog):
    import logging

    from pyrecover_tpu_torch.utils.logging import log_host0

    with caplog.at_level(logging.INFO, logger="pyrecover_tpu_torch"):
        log_host0("from rank %d", 0)
        monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
        log_host0("from rank %d", 1)
    assert "from rank 0" in caplog.text and "from rank 1" not in caplog.text
