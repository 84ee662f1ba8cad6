"""The port's ``telemetry/traceassembly.py`` held to the JAX package's on the
same streams: seeded adversarial clock domains (replica monotonic epochs
thousands of seconds off the router's, wire latency on every leg, a replica
wall clock stepping backwards mid-run, a killed attempt, a hot-swap stall)
rebuilt with numpy give equal assembled reports from both packages; the CLIs
return the same exit codes (0 assembled, 1 ``--expect-complete`` violated, 2
no trace events); and a stream the port's serving engine writes (traced
requests across a weights flip, ``swap_stall`` spans) assembles equally in
both packages and gives the doctor equal ``tracing`` evidence."""

import json

import numpy as np
import pytest
import torch

from pyrecover_tpu.telemetry import doctor as jax_doctor
from pyrecover_tpu.telemetry import traceassembly as jax_traceassembly
from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer
from pyrecover_tpu_torch.serving import ServingConfig, ServingEngine
from pyrecover_tpu_torch.telemetry import doctor, metrics, traceassembly, tracing

WALL = 1.7e9


def adversarial_streams(seed):
    """Three clock domains with seeded offsets and wire latencies: one
    request redriven from a killed replica A to replica B (a 150 ms swap
    stall in its decode), and one clean request on B. Returns ``{label:
    events}`` and the true offsets."""
    rng = np.random.default_rng(seed)
    off_a, off_b = float(rng.uniform(1e3, 9e3)), float(rng.uniform(1e3, 9e3))
    wire = rng.uniform(0.5e-3, 4e-3, 6).tolist()
    t1, t2 = tracing.trace_id(f"r1-{seed}"), tracing.trace_id(f"r2-{seed}")

    def ev(event, mono, **f):
        return {"event": event, "ts": WALL + mono, "mono": mono, **f}

    router = [
        ev("trace_root", 100.0, rid="r1", trace=t1, span=f"{t1}:r", verdict="accepted"),
        ev("fleet_send", 100.010, rid="r1", kind="submit", attempt=1, trace=t1),
        ev("span", 100.010, name="fleet_attempt", span=f"{t1}:a1", parent=f"{t1}:r",
           trace=t1, attempt=1, rid="r1", dur_s=0.49, ok=False, redriven=True),
        ev("fleet_send", 100.510, rid="r1", kind="submit", attempt=2, trace=t1),
        ev("fleet_recv", 101.5, rid="r1", kind="done", attempt=2, trace=t1),
        ev("span", 100.510, name="fleet_attempt", span=f"{t1}:a2", parent=f"{t1}:r",
           trace=t1, attempt=2, rid="r1", dur_s=0.99),
        ev("span", 100.0, name="req_root", span=f"{t1}:r", parent=None, trace=t1, attempt=2,
           rid="r1", dur_s=1.5, attempts=2, redrives=1),
        ev("trace_root", 102.0, rid="r2", trace=t2, span=f"{t2}:r", verdict="accepted"),
        ev("fleet_send", 102.010, rid="r2", kind="submit", attempt=1, trace=t2),
        ev("fleet_recv", 102.2, rid="r2", kind="done", attempt=1, trace=t2),
        ev("span", 102.010, name="fleet_attempt", span=f"{t2}:a1", parent=f"{t2}:r",
           trace=t2, attempt=1, rid="r2", dur_s=0.19),
        ev("span", 102.0, name="req_root", span=f"{t2}:r", parent=None, trace=t2, attempt=1,
           rid="r2", dur_s=0.21, attempts=1, redrives=0),
        ev("trace_exemplar", 103.0, rid="r1", trace=t1, reason="redriven", e2e_s=1.5),
    ]

    def eva(event, parent_mono, **f):
        mono = parent_mono - off_a
        step = -50.0 if parent_mono > 100.4 else 0.0  # the wall clock steps back
        return {"event": event, "ts": WALL + 300.0 + mono + step, "mono": mono, **f}

    replica_a = [
        eva("fleet_recv", 100.010 + wire[0], rid="r1", kind="submit", attempt=1, trace=t1),
        # killed mid-span: an unpaired begin, closed as truncated
        eva("span_begin", 100.015, name="req_queue", span=1, parent=f"{t1}:a1", trace=t1,
            attempt=1, rid="r1"),
        eva("heartbeat", 100.5),
    ]

    def evb(event, parent_mono, **f):
        mono = parent_mono - off_b
        return {"event": event, "ts": WALL + 7.0 + mono, "mono": mono, **f}

    r1 = 100.510 + wire[1]
    r2 = 102.010 + wire[3]
    replica_b = [
        evb("fleet_recv", r1, rid="r1", kind="submit", attempt=2, trace=t1),
        evb("span", r1, name="req_queue", span=1, parent=f"{t1}:a2", trace=t1, attempt=2,
            rid="r1", dur_s=0.1),
        evb("span", r1 + 0.1, name="req_prefill", span=2, parent=f"{t1}:a2", trace=t1,
            attempt=2, rid="r1", dur_s=0.2),
        evb("span", r1 + 0.3, name="req_decode", span=3, parent=f"{t1}:a2", trace=t1,
            attempt=2, rid="r1", dur_s=0.6),
        evb("span", r1 + 0.5, name="swap_stall", span=4, parent=f"{t1}:a2", trace=t1,
            attempt=2, rid="r1", dur_s=0.15),
        evb("fleet_send", 101.5 - wire[2], rid="r1", kind="done", attempt=2, trace=t1),
        evb("fleet_recv", r2, rid="r2", kind="submit", attempt=1, trace=t2),
        evb("span", r2, name="req_queue", span=5, parent=f"{t2}:a1", trace=t2, attempt=1,
            rid="r2", dur_s=0.01),
        evb("span", r2 + 0.01, name="req_prefill", span=6, parent=f"{t2}:a1", trace=t2,
            attempt=1, rid="r2", dur_s=0.05),
        evb("span", r2 + 0.06, name="req_decode", span=7, parent=f"{t2}:a1", trace=t2,
            attempt=1, rid="r2", dur_s=0.1),
        evb("fleet_send", 102.2 - wire[4], rid="r2", kind="done", attempt=1, trace=t2),
    ]
    return {"router": router, "replica_a": replica_a, "replica_b": replica_b}, (off_a, off_b)


def _assemble(pkg, streams):
    return pkg.assemble([pkg.Domain(label, [dict(e) for e in events])
                         for label, events in streams.items()])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_adversarial_assembly_equals_jax(seed):
    streams, (off_a, off_b) = adversarial_streams(seed)
    port = _assemble(traceassembly, streams)
    assert port == _assemble(jax_traceassembly, streams)
    offsets = {d["label"]: d for d in port["domains"]}
    assert offsets["replica_b"]["offset_source"] == "markers"
    assert offsets["replica_b"]["clock_offset_s"] == pytest.approx(off_b, abs=3e-3)
    assert offsets["replica_a"]["offset_source"] == "markers-oneway"
    assert offsets["replica_a"]["clock_offset_s"] == pytest.approx(off_a, abs=5e-3)
    assert port["traces"]["completed"] == 2 and port["traces"]["orphan_spans"] == 0
    (t1,) = [t for t, e in port["per_trace"].items() if e["attempts"] == 2]
    buckets = port["per_trace"][t1]["buckets"]
    assert buckets["swap_stall"] == pytest.approx(0.15) and buckets["decode"] == pytest.approx(0.45)
    assert port["residual_violations"] == []


@pytest.mark.parametrize("drop", ["trace_exemplar", "fleet_send"])
def test_fallbacks_equal_jax(drop):
    """Without the router's exemplar marks (the p99 fallback) or without the
    submit markers (one-way and wall-anchor alignment), both packages still
    assemble the same report."""
    streams, _ = adversarial_streams(5)
    streams = {k: [e for e in v if e["event"] != drop] for k, v in streams.items()}
    assert _assemble(traceassembly, streams) == _assemble(jax_traceassembly, streams)


def test_split_events_and_assemble_events_equal_jax():
    streams, _ = adversarial_streams(0)
    merged = streams["router"] + [{**e, "replica": 0} for e in streams["replica_a"]] + \
        [{**e, "replica": 1} for e in streams["replica_b"]]
    port = traceassembly.split_events(merged, label="merged")
    assert [(d.label, len(d.events)) for d in port] == \
        [(d.label, len(d.events)) for d in jax_traceassembly.split_events(merged, label="merged")]
    assert traceassembly.assemble_events(merged) == jax_traceassembly.assemble_events(merged)
    assert traceassembly.has_trace_events(merged)
    assert not traceassembly.has_trace_events([{"event": "step_time", "step": 1}])


def _write(tmp_path, streams):
    paths = []
    for label, events in streams.items():
        p = tmp_path / f"{label}.jsonl"
        p.write_text("".join(json.dumps(e) + "\n" for e in events))
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("mode", ["complete", "orphan", "no_trace"])
def test_cli_exit_codes_equal_jax(tmp_path, capsys, mode):
    if mode == "complete":
        paths = _write(tmp_path, adversarial_streams(0)[0])
    elif mode == "orphan":
        tid = tracing.trace_id("rz")
        paths = _write(tmp_path, {"orphan": [
            {"event": "trace_root", "mono": 1.0, "rid": "rz", "trace": tid, "span": f"{tid}:r",
             "verdict": "accepted"},
            {"event": "span", "mono": 1.2, "name": "req_decode", "span": 9, "parent": "lost:a1",
             "trace": tid, "attempt": 1, "rid": "rz", "dur_s": 0.3}]})
    else:
        paths = _write(tmp_path, {"plain": [{"event": "step_time", "step": 1, "mono": 1.0,
                                             "ts": WALL}]})
    outs, rcs = {}, {}
    for pkg, mod in (("port", traceassembly), ("jax", jax_traceassembly)):
        rcs[pkg] = mod.main(paths + ["--expect-complete", "--json", str(tmp_path / f"{pkg}.json")])
        outs[pkg] = capsys.readouterr().out
    assert rcs["port"] == rcs["jax"] == {"complete": 0, "orphan": 1, "no_trace": 2}[mode]
    assert outs["port"] == outs["jax"]
    if mode != "no_trace":
        assert json.loads((tmp_path / "port.json").read_text()) == \
            json.loads((tmp_path / "jax.json").read_text())


def _engine_stream(tmp_path):
    """A JSONL the port's engine writes: six traced requests (each a root
    span recorded by the client, as a router would) with a weights flip while
    they are in flight, so the flip's ``swap_stall`` spans join their trees."""
    torch.set_num_threads(1)
    cfg = ModelConfig().tiny(max_seq_len=96, vocab_size=64, compute_dtype="float32",
                             param_dtype="float32")
    model = Transformer(cfg, generator=torch.Generator().manual_seed(0))
    engine = ServingEngine(model, ServingConfig(block_size=8, max_seqs=4, prefill_chunk=16,
                                                prefill_token_budget=32))
    path = tmp_path / "engine_telemetry.jsonl"
    sink = telemetry.JsonlSink(path)
    telemetry.add_sink(sink)
    metrics.reset()
    try:
        rng = np.random.default_rng(3)
        reqs = []
        for i in range(6):
            ctx = tracing.mint(f"req-{i}")
            telemetry.emit("trace_root", rid=f"req-{i}", trace=ctx.trace, span=ctx.span,
                           verdict="accepted", mono=0.0)
            with tracing.installed(ctx):
                rid = engine.submit(rng.integers(0, 64, 8).tolist(), 6)
            reqs.append((ctx, rid, engine._waiting[-1]))
        engine.step()
        engine.step()
        engine.install_params(Transformer(cfg, generator=torch.Generator().manual_seed(1)),
                              step=2, info={"path": "ckpt_2.zs.json", "engine": "zerostall"})
        engine.run_until_drained()
        for ctx, rid, req in reqs:
            telemetry.record_span("req_root", req.t_submit, req.t_done, span_id=ctx.span,
                                  trace=ctx.trace, rid=f"req-{rid}", attempts=1, redrives=0)
    finally:
        telemetry.remove_sink(sink)
        sink.close()
    return path


def test_engine_stream_assembles_equally_and_gives_equal_doctor_evidence(tmp_path):
    path = _engine_stream(tmp_path)
    events = telemetry.read_events(path)
    port = traceassembly.assemble_events(events)
    assert port == jax_traceassembly.assemble_events(events)
    assert port["traces"]["assembled"] == port["traces"]["completed"] == 6
    assert port["traces"]["orphan_spans"] == 0
    stalls = [e for e in events if e["event"] == "span" and e["name"] == "swap_stall"]
    (done,) = [e for e in events if e["event"] == "weights_swap_done"]
    assert len(stalls) == done["in_flight"] > 0
    assert sum(e["buckets"]["swap_stall"] > 0 for e in port["per_trace"].values()) == len(stalls)
    evidence = doctor.diagnose(path)["evidence"]["tracing"]
    assert evidence is not None and evidence["assembled"] == 6
    assert evidence == jax_doctor.diagnose(path)["evidence"]["tracing"]
