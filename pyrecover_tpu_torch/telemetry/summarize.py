"""Summarize a telemetry JSONL into a goodput report (the JAX package's
``tools/summarize_telemetry.py``, over the port's streams).

Reads the event stream a run (or a whole interrupt/resume chain: the stream
appends across resume cycles) wrote under ``--telemetry``, and renders:

  * per-run-segment status: steps reached, goodput %, restart tax;
  * aggregate goodput accounting: productive train seconds vs seconds
    lost to checkpoint save/load, restart re-warmup, and replayed steps;
  * step-time breakdown (data-wait vs dispatch vs synced iteration time);
  * checkpoint lifecycle totals per engine (blocking vs background);
  * the goodput-autopilot decision trail (``ckpt_policy`` events: the
    live failure model, the Young-Daly optimum, the chosen interval) and
    the static-policy counterfactual: what the configured static interval
    would have lost on the SAME event stream (interval-spaced saves at the
    measured mean blocking cost + per-death replay);
  * the serving hot-swap trail (``weights_swap_*`` / ``swap_fetch_bytes``:
    swap count, bytes fetched vs reused in place, request p99 across the
    swap windows) and the fleet's traces (``telemetry/traceassembly.py``);
  * preemption / maintenance / data-stall event digests.

Usage::

    python -m pyrecover_tpu_torch.telemetry.summarize RUN_telemetry.jsonl [--json OUT]

``--json OUT`` also writes a benchmark-style blob (``{"metric":
"goodput_pct", "value": ..., "unit": "%", "extra": {...}}``). The stream is
read by ``telemetry/sinks.py::read_events`` (rotated files included).

Exit codes: 0 = report rendered, 2 = unreadable/empty stream.
"""

import argparse
import json
import sys
from collections import defaultdict

from pyrecover_tpu_torch.telemetry import traceassembly
from pyrecover_tpu_torch.telemetry.sinks import read_events


def _fmt_s(x):
    return f"{x:.2f}s"


def _mean(xs):
    return sum(xs) / len(xs) if xs else 0.0


def _wpercentile(samples, q):
    """Weighted percentile over [(value, weight)] samples, or None."""
    if not samples:
        return None
    samples = sorted(samples)
    total = sum(w for _, w in samples)
    rank = q * total
    cum = 0.0
    for v, w in samples:
        cum += w
        if cum >= rank - 1e-12:
            return v
    return samples[-1][0]


def segments(events):
    """Split the stream into run segments: run_start .. run_summary."""
    segs = []
    cur = None
    for e in events:
        if e["event"] == "run_start":
            if cur is not None:
                segs.append(cur)  # previous segment died without a summary
            cur = {"start": e, "events": [], "summary": None}
        elif cur is not None:
            cur["events"].append(e)
            if e["event"] == "run_summary":
                cur["summary"] = e
                segs.append(cur)
                cur = None
    if cur is not None:
        segs.append(cur)
    return segs


def aggregate(events):
    """Whole-stream rollup used by both the report and the JSON blob."""
    by = defaultdict(list)
    for e in events:
        by[e["event"]].append(e)

    agg = {"n_events": len(events), "n_segments": 0, "segments": []}
    total = defaultdict(float)
    for seg in segments(events):
        agg["n_segments"] += 1
        s = seg["summary"]
        row = {
            "status": s["status"] if s else "no summary (killed?)",
            "step": s["step"] if s else None,
        }
        if s:
            for k in ("wall_s", "step_s", "productive_s", "replayed_s",
                      "ckpt_save_s", "ckpt_blocking_s", "ckpt_shadow_s",
                      "ckpt_load_s", "setup_s", "eval_s", "lost_s"):
                total[k] += float(s.get(k, 0.0))
            total["replayed_steps"] += int(s.get("replayed_steps", 0))
            row["goodput_pct"] = s.get("goodput_pct")
            row["replayed_steps"] = s.get("replayed_steps", 0)
        agg["segments"].append(row)
    agg["totals"] = dict(total)
    agg["goodput_pct"] = (
        round(100.0 * total["productive_s"] / total["wall_s"], 2)
        if total.get("wall_s") else None
    )

    steps = by.get("step_time", [])
    syncs = by.get("train_sync", [])
    # synced-interval step-time percentiles: each train_sync contributes
    # its interval-average iter_s weighted by the steps it covered — the
    # same numbers bench.py's metrics_snapshot percentiles report
    iter_samples = [
        (float(e["iter_s"]), int(e.get("steps", 1)) or 1)
        for e in syncs if isinstance(e.get("iter_s"), (int, float))
    ]

    def _pct(q):
        p = _wpercentile(iter_samples, q)
        return round(p, 6) if p is not None else None

    agg["steps"] = {
        "recorded": len(steps),
        "data_wait_s_mean": round(_mean([e["data_wait_s"] for e in steps]), 6),
        "data_wait_s_max": round(max([e["data_wait_s"] for e in steps], default=0.0), 6),
        "dispatch_s_mean": round(_mean([e["dispatch_s"] for e in steps]), 6),
        "iter_s_mean": round(_mean([e["iter_s"] for e in syncs]), 6),
        "iter_s_p50": _pct(0.50),
        "iter_s_p95": _pct(0.95),
        "iter_s_p99": _pct(0.99),
        "sync_s_mean": round(_mean([e["sync_s"] for e in syncs]), 6),
    }
    if syncs:
        agg["loss_first"] = syncs[0].get("loss")
        agg["loss_last"] = syncs[-1].get("loss")

    # latest metrics_snapshot per histogram: the flushed registry carries
    # loader-wait / ckpt-phase / retry-latency percentiles per host
    hists = {}
    gauges = {}
    for e in by.get("metrics_snapshot", []):
        for name, h in (e.get("hists") or {}).items():
            hists[name] = h
        gauges.update(e.get("gauges") or {})
    agg["metric_hists"] = hists
    agg["gauges"] = gauges

    # run-health rollup: the silent-failure detectors' event trail plus
    # peak-HBM-vs-budget from the run_summary records (max over segments)
    health = {
        "recompiles": len(by.get("recompile", [])),
        "implicit_transfers": len(by.get("implicit_transfer", [])),
        "platform_fallbacks": len(by.get("platform_fallback", [])),
        "hangs": len(by.get("hang_detected", [])),
        "flight_dumps": len(by.get("flight_dump", [])),
        "hbm_peak_bytes": None,
        "hbm_budget_bytes": None,
        "hbm_peak_pct": None,
    }
    for e in by.get("run_summary", []):
        peak = e.get("hbm_peak_bytes")
        if isinstance(peak, (int, float)) and (
            health["hbm_peak_bytes"] is None
            or peak > health["hbm_peak_bytes"]
        ):
            health["hbm_peak_bytes"] = int(peak)
            health["hbm_budget_bytes"] = e.get("hbm_budget_bytes")
            health["hbm_peak_pct"] = e.get("hbm_peak_pct")
    if health["hbm_peak_bytes"] is None:
        peak_gauge = gauges.get("hbm_peak_bytes_in_use")
        if isinstance(peak_gauge, (int, float)):
            health["hbm_peak_bytes"] = int(peak_gauge)
    agg["health"] = health

    ckpt = {}

    def _ckpt_engine(e):
        return ckpt.setdefault(
            e.get("engine", "?"),
            {"saves": 0, "blocking_s": 0.0, "blocking_s_max": 0.0,
             "shadow_s": 0.0, "restores": 0, "restore_s": 0.0},
        )

    for e in by.get("ckpt_save_blocking", []):
        eng = _ckpt_engine(e)
        eng["saves"] += 1
        eng["blocking_s"] += e["blocking_s"]
        eng["blocking_s_max"] = max(eng["blocking_s_max"], e["blocking_s"])
    # overlapped background save work (async vanilla writes, the
    # zerostall pipeline): recovered goodput, reported NEXT TO the
    # blocking stall so an async engine's win is visible, never hidden
    for e in by.get("ckpt_save_shadow", []):
        _ckpt_engine(e)["shadow_s"] += e.get("shadow_s", 0.0)
    for e in by.get("ckpt_restore_done", []):
        eng = _ckpt_engine(e)
        eng["restores"] += 1
        eng["restore_s"] += e["seconds"]
    for eng in ckpt.values():
        for k in ("blocking_s", "blocking_s_max", "shadow_s", "restore_s"):
            eng[k] = round(eng[k], 4)
    agg["ckpt"] = ckpt
    agg["ckpt_backpressure"] = {
        "count": len(by.get("ckpt_backpressure", [])),
        "wait_s": round(
            sum(e.get("wait_s", 0.0)
                for e in by.get("ckpt_backpressure", [])), 4
        ),
    }
    agg["emergency"] = {
        "publishes": len(by.get("emergency_publish", [])),
        "restores": len(by.get("emergency_restore", [])),
        "rejected": len(by.get("emergency_restore_rejected", [])),
    }
    agg["ckpt_commits"] = {
        "count": len(by.get("ckpt_commit", [])),
        "bytes": sum(e.get("bytes", 0) for e in by.get("ckpt_commit", [])),
        "write_s": round(
            sum(e.get("write_s", 0.0) for e in by.get("ckpt_commit", [])), 4
        ),
    }
    agg["ckpt_durable_wait_s"] = round(
        sum(e.get("wait_s", 0.0) for e in by.get("ckpt_save_durable", [])), 4
    )
    agg["ckpt_prunes"] = sum(e.get("count", 0) for e in by.get("ckpt_prune", []))
    agg["ckpt_fallbacks"] = (
        len(by.get("ckpt_precheck_failed", []))
        + len(by.get("ckpt_restore_fallback", []))
    )

    stalls = by.get("data_stall", [])
    agg["data_stalls"] = {
        "count": len(stalls),
        "wait_s": round(sum(e["wait_s"] for e in stalls), 4),
    }
    agg["preempt"] = {
        "checks": len(by.get("preempt_check", [])),
        "notices": len(by.get("preempt_notice", [])),
        "stops": [e.get("reason", "") for e in by.get("preempt_stop", [])],
        "maintenance": [
            # obscheck: disable-next=consumer-field-drift -- the JAX package's
            # TPU maintenance watcher emits it (left out of the port by design);
            # this summarizer reads either package's stream
            e.get("description", "") for e in by.get("maintenance_event", [])
        ],
    }
    # bandwidth-lean / overlap trail: what the step was BUILT to move
    # (grad_quantize), the effective bucket layout (grad_bucket)
    # and the remat autoscaling decision (remat_autosize) — one record
    # per run segment; the LAST one describes the current configuration
    wire = {}
    quant = by.get("grad_quantize", [])
    if quant:
        quantize = quant[-1]
        wire["grad_quantize"] = {
            "mode": quantize.get("mode"),
            "optimizer_sharding": quantize.get("optimizer_sharding"),
            "data_replicas": quantize.get("data_replicas"),
            "wire_bytes_per_leg": quantize.get("wire_bytes_per_leg"),
            "grad_bytes_fp32": quantize.get("grad_bytes_fp32"),
        }
    buckets = by.get("grad_bucket", [])
    if buckets:
        bucket = buckets[-1]
        sizes = bucket.get("bucket_bytes_f32") or []
        wire["grad_bucket"] = {
            "bucket_mb": bucket.get("bucket_mb"),
            "mode": bucket.get("mode"),
            "buckets": bucket.get("buckets"),
            "degenerate": bucket.get("degenerate"),
            "min_bucket_bytes": bucket.get("min_bucket_bytes", min(sizes, default=0)),
            "max_bucket_bytes": bucket.get("max_bucket_bytes", max(sizes, default=0)),
            "events": len(buckets),
        }
    remat = by.get("remat_autosize", [])
    if remat:
        autosize = remat[-1]
        wire["remat_autosize"] = {
            "policy": autosize.get("policy"),
            "fits": autosize.get("fits"),
            "device_kind": autosize.get("device_kind"),
            "budget_bytes": autosize.get("budget_bytes"),
            # obscheck: disable-next=consumer-field-drift -- the JAX package's
            # streams carry it; this summarizer reads either package's
            "suggested_batch_per_chip": autosize.get("suggested_batch_per_chip"),
        }
    agg["wire"] = wire

    # serving rollup: request-latency percentiles straight from the
    # request_done trail (ttft/tpot/e2e per finished request), plus the
    # admission/backpressure/weights-loaded digests — the serving
    # engine's observability contract (README "Serving")
    done = by.get("request_done", [])
    serving = {}
    if done or by.get("request_admitted") or by.get("kv_backpressure") \
            or by.get("weights_loaded"):
        def _req_pct(field):
            samples = [
                (float(e[field]), 1)
                for e in done if isinstance(e.get(field), (int, float))
            ]
            return {
                label: (
                    round(_wpercentile(samples, q), 6)
                    if samples else None
                )
                for label, q in (("p50", 0.50), ("p95", 0.95),
                                 ("p99", 0.99))
            }

        serving = {
            "requests_admitted": len(by.get("request_admitted", [])),
            "requests_done": len(done),
            "new_tokens": sum(int(e.get("new_tokens", 0)) for e in done),
            "ttft_s": _req_pct("ttft_s"),
            "tpot_s": _req_pct("tpot_s"),
            "e2e_s": _req_pct("e2e_s"),
            "kv_backpressure": len(by.get("kv_backpressure", [])),
            "weights_loaded": [
                {"engine": e.get("engine"), "step": e.get("step"),
                 "leaves": e.get("leaves"),
                 "resharded_leaves": e.get("resharded_leaves")}
                for e in by.get("weights_loaded", [])
            ],
        }
    agg["serving"] = serving

    # hot-swap rollup: the train→serve distribution plane's trail —
    # completed/rejected swaps, the incremental fetch ledger (bytes
    # moved vs bytes the replica already held), swap-apply latency, and
    # request p99 ACROSS the swap windows (requests finishing between a
    # weights_swap_begin and 1s past its weights_swap_done — the tail
    # the zero-downtime claim is about)
    swap_done = by.get("weights_swap_done", [])
    swap_rejected = by.get("weights_swap_rejected", [])
    swap_fetches = by.get("swap_fetch_bytes", [])
    hotswap = {}
    if swap_done or swap_rejected or swap_fetches:
        windows = []
        begins_by_step = {
            e.get("to_step"): e["ts"]
            for e in by.get("weights_swap_begin", [])
        }
        for e in swap_done:
            start = begins_by_step.get(e.get("step"), e["ts"])
            windows.append((start, e["ts"] + 1.0))
        in_window = [
            (float(e["e2e_s"]), 1) for e in done
            if isinstance(e.get("e2e_s"), (int, float))
            and any(a <= e["ts"] <= b for a, b in windows)
        ]
        swap_s = [
            (float(e["swap_s"]), 1) for e in swap_done
            if isinstance(e.get("swap_s"), (int, float))
        ]
        hotswap = {
            "swaps": len(swap_done),
            "rejected": len(swap_rejected),
            "rejected_reasons": [
                {"path": e.get("path"), "reason": e.get("reason")}
                for e in swap_rejected
            ],
            "fetched_bytes": sum(
                int(e.get("fetched_bytes", 0)) for e in swap_fetches
            ),
            "reused_bytes": sum(
                int(e.get("reused_bytes", 0)) for e in swap_fetches
            ),
            "incremental_fetches": sum(
                1 for e in swap_fetches if e.get("incremental")
            ),
            "last_step": swap_done[-1].get("step") if swap_done else None,
            "swap_s_p50": _wpercentile(swap_s, 0.50),
            "swap_s_p99": _wpercentile(swap_s, 0.99),
            "swap_window_requests": len(in_window),
            "swap_window_e2e_p99": _wpercentile(in_window, 0.99),
        }
    agg["hotswap"] = hotswap

    # fleet rollup: the front door's trail over the merged per-replica
    # shards — supervision (spawns/deaths/quarantines), the redrive and
    # shed ledgers, per-replica vs fleet request latency (request_done
    # events tagged `replica` by the drill's shard merge), and the
    # canary rollout verdict trail (README "Serving fleet")
    spawned = by.get("replica_spawned", [])
    replica_deaths = by.get("replica_dead", [])
    quarantines = by.get("replica_quarantined", [])
    redrives = by.get("request_redriven", [])
    shed = by.get("fleet_shed", [])
    verdicts = by.get("canary_verdict", [])
    fleet = {}
    if spawned or replica_deaths or quarantines or redrives or shed \
            or verdicts:
        per_replica = {}
        for e in done:
            # obscheck: disable-next=consumer-field-drift -- "replica" is
            # stamped by the fleet drill's shard merge (each replica's
            # request_done inherits its shard's slot), not by the
            # engine's emit site; absent on single-engine streams
            r = e.get("replica")
            if r is None or not isinstance(e.get("e2e_s"), (int, float)):
                continue
            per_replica.setdefault(int(r), []).append((float(e["e2e_s"]), 1))
        fleet_samples = [s for v in per_replica.values() for s in v]

        def _e2e_pct(samples):
            return {
                label: (
                    round(_wpercentile(samples, q), 6) if samples else None
                )
                for label, q in (("p50", 0.50), ("p95", 0.95),
                                 ("p99", 0.99))
            }

        replica_done = sum(len(v) for v in per_replica.values())
        replicas_seen = sorted(
            {int(e["replica"]) for e in spawned
             if isinstance(e.get("replica"), int)} | set(per_replica)
        )
        fleet = {
            "replicas_seen": replicas_seen,
            "spawns": len(spawned),
            "deaths": len(replica_deaths),
            "quarantines": len(quarantines),
            "redrives": len(redrives),
            "shed": len(shed),
            "shed_rate_pct": round(
                100.0 * len(shed) / (replica_done + len(shed)), 2
            ) if (replica_done + len(shed)) else 0.0,
            "requests_done": replica_done,
            "e2e_s": _e2e_pct(fleet_samples),
            "per_replica_e2e_s": {
                str(r): _e2e_pct(v) for r, v in sorted(per_replica.items())
            },
            "canary_verdicts": [
                {"verdict": e.get("verdict"), "reason": e.get("reason"),
                 "manifest": e.get("manifest"), "waved": e.get("waved")}
                for e in verdicts
            ],
        }
    agg["fleet"] = fleet

    # cross-process request tracing: reassemble the merged stream into
    # rooted per-request trees (the `replica` tag splits it back into
    # clock domains) and roll up the critical-path attribution — the
    # README "Distributed request tracing" contract
    tracing_agg = {}
    if traceassembly.has_trace_events(events):
        rep = traceassembly.assemble_events(events)
        reasons = defaultdict(int)
        for info in rep["exemplars"].values():
            reasons[info["reason"]] += 1
        tracing_agg = {
            "domains": len(rep["domains"]),
            "assembled": rep["traces"]["assembled"],
            "completed": rep["traces"]["completed"],
            "root_only": rep["traces"]["root_only"],
            "orphan_spans": rep["traces"]["orphan_spans"],
            "buckets": rep["buckets"],
            "dominant_tail_bucket": rep["dominant_tail_bucket"],
            "exemplars": dict(reasons),
            "residual_violations": len(rep["residual_violations"]),
        }
    agg["tracing"] = tracing_agg

    # checkpoint-policy (autopilot) rollup + the static-policy
    # counterfactual: replay the SAME event stream against the configured
    # static interval — saves it would have paid (interval-spaced at the
    # measured mean blocking cost) plus the steps each observed death
    # would have replayed from its last interval-aligned save — so the
    # goodput report can state what the static policy would have lost.
    policies = by.get("ckpt_policy", [])
    saved_events = by.get("ckpt_saved", [])
    save_costs = [
        float(e["blocking_s"]) for e in saved_events
        if isinstance(e.get("blocking_s"), (int, float))
    ]
    # one death per run segment that never reached a run_summary: the
    # last step the stream saw is where the interruption landed
    death_steps = []
    max_step = 0
    for seg in segments(events):
        seg_steps = [
            int(e["step"]) for e in seg["events"] + [seg["start"]]
            if e.get("event") in ("train_sync", "step_time", "ckpt_saved")
            and isinstance(e.get("step"), int)
        ]
        if seg_steps:
            max_step = max(max_step, max(seg_steps))
        if seg["summary"] is None and seg_steps:
            death_steps.append(max(seg_steps))
    static_interval = next(
        (
            int(e["static_interval"]) for e in reversed(policies)
            if isinstance(e.get("static_interval"), int)
            and e["static_interval"] > 0
        ),
        None,
    )
    if static_interval is None and len(saved_events) >= 2:
        # no autopilot trail: infer the static cadence from the modal gap
        # between the run's own saves
        gaps = [
            b["step"] - a["step"]
            for a, b in zip(saved_events, saved_events[1:])
            if isinstance(a.get("step"), int)
            and isinstance(b.get("step"), int)
            and b["step"] > a["step"]
        ]
        if gaps:
            static_interval = max(set(gaps), key=gaps.count)
    autopilot = {}
    if policies:
        last = policies[-1]
        autopilot["decisions"] = len(policies)
        autopilot["segments_with_decisions"] = sum(
            1 for s in segments(events)
            if any(x.get("event") == "ckpt_policy" for x in s["events"])
        )
        autopilot["last"] = {
            k: last.get(k)
            for k in ("step", "interval_steps", "optimum_steps", "cost_s",
                      "mtti_s", "step_iter_s", "failures_observed",
                      "reason", "engine", "engine_recommendation")
        }
        autopilot["interval_trajectory"] = [
            e.get("interval_steps") for e in policies
        ]
        autopilot["engine_recommendations"] = sorted({
            e["engine_recommendation"] for e in policies
            if e.get("engine_recommendation")
        })
    step_time = agg["steps"]["iter_s_mean"] or 0.0
    if static_interval and save_costs and step_time > 0 and max_step > 0:
        mean_cost = _mean(save_costs)
        k = static_interval
        static_saves = max_step // k
        static_save_s = static_saves * mean_cost
        static_replay_steps = sum(d - (d // k) * k for d in death_steps)
        static_replay_s = static_replay_steps * step_time
        t = agg["totals"]
        # the measured side is priced the SAME way (replayed steps x mean
        # step time + blocking save seconds) so the comparison is model
        # vs model on one stream — raw replayed_s wall time also carries
        # each restart's compile, which the static policy would pay too
        measured_replay_steps = int(t.get("replayed_steps", 0))
        measured_lost_s = (
            float(t.get("ckpt_save_s", 0.0))
            + measured_replay_steps * step_time
        )
        autopilot["counterfactual"] = {
            "static_interval": k,
            "static_saves": static_saves,
            "static_save_s": round(static_save_s, 4),
            "static_replay_steps": static_replay_steps,
            "static_replay_s": round(static_replay_s, 4),
            "static_lost_s": round(static_save_s + static_replay_s, 4),
            "measured_lost_s": round(measured_lost_s, 4),
            "delta_s": round(
                static_save_s + static_replay_s - measured_lost_s, 4
            ),
            "deaths": len(death_steps),
            "measured_replay_steps": measured_replay_steps,
            "mean_save_cost_s": round(mean_cost, 6),
        }
    agg["autopilot"] = autopilot

    # SLO alert rollup: the live-metrics exporter's burn-rate rule trail
    # (``slo_alert`` firing/cleared transitions, README "Live metrics") —
    # per rule: fire/clear counts, first/last fire offset into the
    # stream, and the duty cycle (fraction of the stream's span the rule
    # spent firing; a rule still firing at stream end accrues to the
    # last event and is flagged)
    alerts = by.get("slo_alert", [])
    alert_agg = {}
    if alerts:
        ts_all = [
            e["ts"] for e in events
            if isinstance(e.get("ts"), (int, float))
        ]
        span_start = min(ts_all) if ts_all else 0.0
        span_end = max(ts_all) if ts_all else 0.0
        span_s = max(span_end - span_start, 1e-9)
        rules = {}
        for e in alerts:
            r = rules.setdefault(e.get("rule", "?"), {
                "kind": e.get("kind"),
                "threshold": e.get("threshold"),
                "window_s": e.get("window_s"),
                "fires": 0, "clears": 0,
                "first_fire_s": None, "last_fire_s": None,
                "firing_s": 0.0, "firing_at_end": False,
                "peak_value": None, "_since": None,
            })
            ts = e.get("ts")
            if not isinstance(ts, (int, float)):
                ts = None
            if e.get("state") == "firing":
                r["fires"] += 1
                rel = round(ts - span_start, 3) if ts is not None else None
                if r["first_fire_s"] is None:
                    r["first_fire_s"] = rel
                r["last_fire_s"] = rel
                if r["_since"] is None and ts is not None:
                    r["_since"] = ts
                v = e.get("value")
                if isinstance(v, (int, float)) and (
                    r["peak_value"] is None or v > r["peak_value"]
                ):
                    r["peak_value"] = v
            elif e.get("state") == "cleared":
                r["clears"] += 1
                if r["_since"] is not None and ts is not None:
                    r["firing_s"] += ts - r["_since"]
                r["_since"] = None
        for r in rules.values():
            if r["_since"] is not None:  # still firing at stream end
                r["firing_s"] += span_end - r["_since"]
                r["firing_at_end"] = True
            del r["_since"]
            r["firing_s"] = round(r["firing_s"], 4)
            r["duty_pct"] = round(100.0 * r["firing_s"] / span_s, 2)
        alert_agg = {
            "events": len(alerts),
            "total_fires": sum(r["fires"] for r in rules.values()),
            "span_s": round(span_s, 4),
            "rules": rules,
        }
    agg["alerts"] = alert_agg

    agg["warnings"] = [
        f"MFU denominator unknown for device kind {e.get('device_kind')!r}"
        for e in by.get("mfu_peak_unknown", [])
    ]
    return agg


def render(agg, out=None):
    w = (out or sys.stdout).write
    t = agg["totals"]
    w(f"telemetry summary: {agg['n_events']} events, "
      f"{agg['n_segments']} run segment(s)\n")
    w("\n-- run segments ------------------------------------------------\n")
    for i, seg in enumerate(agg["segments"]):
        good = (
            f" | goodput {seg['goodput_pct']:.1f}%"
            if seg.get("goodput_pct") is not None else ""
        )
        rep = (
            f" | replayed {seg['replayed_steps']} steps"
            if seg.get("replayed_steps") else ""
        )
        w(f"  [{i}] {seg['status']} at step {seg['step']}{good}{rep}\n")
    if t:
        w("\n-- goodput accounting (all segments) ---------------------------\n")
        w(f"  wall time          {_fmt_s(t.get('wall_s', 0.0))}\n")
        w(f"  productive train   {_fmt_s(t.get('productive_s', 0.0))}"
          f"  <- stepping time that moved training forward once\n")
        w(f"  lost: ckpt save    {_fmt_s(t.get('ckpt_save_s', 0.0))}"
          f"  <- blocking train-loop stall only\n")
        if t.get("ckpt_shadow_s"):
            w(f"  recovered: shadow  {_fmt_s(t.get('ckpt_shadow_s', 0.0))}"
              f"  <- save work overlapped with training (not lost)\n")
        w(f"  lost: ckpt load    {_fmt_s(t.get('ckpt_load_s', 0.0))}\n")
        w(f"  lost: re-warmup    {_fmt_s(t.get('setup_s', 0.0))}\n")
        w(f"  lost: replayed     {_fmt_s(t.get('replayed_s', 0.0))}"
          f"  ({int(t.get('replayed_steps', 0))} steps re-done after resume)\n")
        w(f"  eval               {_fmt_s(t.get('eval_s', 0.0))}\n")
        if agg["goodput_pct"] is not None:
            w(f"  GOODPUT            {agg['goodput_pct']:.1f}%\n")
        cf = (agg.get("autopilot") or {}).get("counterfactual")
        if cf:
            w(f"  static policy      every {cf['static_interval']} steps "
              f"would have lost {_fmt_s(cf['static_lost_s'])} "
              f"(saves {_fmt_s(cf['static_save_s'])} + replay "
              f"{_fmt_s(cf['static_replay_s'])} over {cf['deaths']} "
              f"death(s)) vs {_fmt_s(cf['measured_lost_s'])} measured\n")
    st = agg["steps"]
    if st["recorded"]:
        w("\n-- step-time breakdown -----------------------------------------\n")
        w(f"  steps recorded     {st['recorded']}\n")
        w(f"  data wait          mean {st['data_wait_s_mean'] * 1e3:.2f}ms"
          f"  max {st['data_wait_s_max'] * 1e3:.2f}ms\n")
        w(f"  dispatch           mean {st['dispatch_s_mean'] * 1e3:.2f}ms\n")
        w(f"  synced iter time   mean {st['iter_s_mean'] * 1e3:.2f}ms"
          f"  (sync cost mean {st['sync_s_mean'] * 1e3:.2f}ms)\n")
        if st.get("iter_s_p50") is not None:
            w(f"  iter percentiles   p50 {st['iter_s_p50'] * 1e3:.2f}ms  "
              f"p95 {st['iter_s_p95'] * 1e3:.2f}ms  "
              f"p99 {st['iter_s_p99'] * 1e3:.2f}ms\n")
        if "loss_first" in agg:
            w(f"  loss               {agg['loss_first']} -> {agg['loss_last']}\n")
    if agg.get("metric_hists"):
        w("\n-- metrics percentiles (last metrics_snapshot) -----------------\n")
        for name, h in sorted(agg["metric_hists"].items()):
            p50 = h.get("p50")
            p95 = h.get("p95")
            p99 = h.get("p99")
            if p50 is None:
                continue
            w(f"  {name:<24} x{h.get('count', 0):<6} p50 {p50 * 1e3:9.2f}ms  "
              f"p95 {p95 * 1e3:9.2f}ms  p99 {p99 * 1e3:9.2f}ms\n")
    h = agg.get("health", {})
    if h.get("hbm_peak_bytes") is not None or any(
        h.get(k) for k in ("recompiles", "implicit_transfers",
                           "platform_fallbacks", "hangs", "flight_dumps")
    ):
        w("\n-- run health (silent-failure detectors) -----------------------\n")
        if h.get("hbm_peak_bytes") is not None:
            line = f"  peak HBM           {h['hbm_peak_bytes'] / 1e9:.2f} GB"
            if h.get("hbm_peak_pct") is not None:
                line += (
                    f"  ({h['hbm_peak_pct']:.1f}% of "
                    f"{h['hbm_budget_bytes'] / 1e9:.1f} GB budget)"
                )
            w(line + "\n")
        w(f"  recompiles         {h.get('recompiles', 0)}"
          + ("  <- shape/dtype drift retracing the train step"
             if h.get("recompiles") else "") + "\n")
        if h.get("implicit_transfers"):
            w(f"  implicit transfers {h['implicit_transfers']}"
              f"  <- host<->device syncs inside the guarded dispatch\n")
        if h.get("platform_fallbacks"):
            w(f"  PLATFORM FALLBACKS {h['platform_fallbacks']}"
              f"  <- ran on CPU; perf numbers are not accelerator numbers\n")
        if h.get("hangs"):
            w(f"  HANGS DETECTED     {h['hangs']}"
              f"  (postmortem bundles: {h.get('flight_dumps', 0)} — "
              f"run `doctor` on the experiment dir)\n")
        elif h.get("flight_dumps"):
            w(f"  flight dumps       {h['flight_dumps']}\n")
    if agg["ckpt"]:
        w("\n-- checkpoint lifecycle ----------------------------------------\n")
        for eng, c in sorted(agg["ckpt"].items()):
            shadow = (
                f", shadow {c['shadow_s']}s overlapped"
                if c.get("shadow_s") else ""
            )
            w(f"  [{eng}] {c['saves']} saves, blocking {c['blocking_s']}s "
              f"(max {c['blocking_s_max']}s{shadow}); {c['restores']} "
              f"restores, {c['restore_s']}s\n")
        bp = agg.get("ckpt_backpressure") or {}
        if bp.get("count"):
            w(f"  BACKPRESSURE: {bp['count']} save(s) waited "
              f"{bp['wait_s']}s on the in-flight queue\n")
        em = agg.get("emergency") or {}
        if em.get("publishes") or em.get("restores") or em.get("rejected"):
            w(f"  emergency tier: {em['publishes']} publishes, "
              f"{em['restores']} RAM restores"
              + (f", {em['rejected']} REJECTED records"
                 if em.get("rejected") else "") + "\n")
        cm = agg["ckpt_commits"]
        if cm["count"]:
            w(f"  commits: {cm['count']} ({cm['bytes']} bytes, "
              f"{cm['write_s']}s background write)\n")
        if agg["ckpt_durable_wait_s"]:
            w(f"  durability waits: {agg['ckpt_durable_wait_s']}s\n")
        if agg["ckpt_prunes"]:
            w(f"  pruned: {agg['ckpt_prunes']} old checkpoint(s)\n")
        if agg["ckpt_fallbacks"]:
            w(f"  RESTORE FALLBACKS: {agg['ckpt_fallbacks']} "
              f"(corrupt/torn candidates skipped)\n")
    wire = agg.get("wire") or {}
    if wire:
        w("\n-- bandwidth-lean / overlap configuration ----------------------\n")
        gq = wire.get("grad_quantize")
        if gq:
            w(f"  gradient wire      {gq['mode']}/{gq['optimizer_sharding']} "
              f"over {gq['data_replicas']} data replicas — "
              f"{(gq.get('wire_bytes_per_leg') or 0) / 2**20:.1f} MiB/leg "
              f"(fp32 grads {(gq.get('grad_bytes_fp32') or 0) / 2**20:.1f} "
              f"MiB)\n")
        gb = wire.get("grad_bucket")
        if gb:
            if gb.get("degenerate"):
                w(f"  grad buckets       cap {gb['bucket_mb']:g} MiB "
                  f"degenerate (one bucket) — unbucketed single "
                  f"collective\n")
            else:
                w(f"  grad buckets       {gb['buckets']} @ cap "
                  f"{gb['bucket_mb']:g} MiB ({gb['mode']}), "
                  f"{(gb.get('min_bucket_bytes') or 0) / 2**20:.2f}.."
                  f"{(gb.get('max_bucket_bytes') or 0) / 2**20:.2f} MiB "
                  f"f32 each — per-bucket collectives overlap the "
                  f"backward\n")
        ra = wire.get("remat_autosize")
        if ra:
            budget = (
                f"{(ra.get('budget_bytes') or 0) / 2**30:.1f} GiB"
                if ra.get("budget_bytes") else "unknown"
            )
            w(f"  remat auto         policy {ra['policy']} on "
              f"{ra.get('device_kind') or '<unknown>'} (budget {budget}, "
              f"suggested per-chip batch "
              f"{ra.get('suggested_batch_per_chip')})\n")
    ap = agg.get("autopilot") or {}
    if ap.get("decisions"):
        w("\n-- checkpoint policy (autopilot) --------------------------------\n")
        last = ap["last"]
        w(f"  decisions          {ap['decisions']} across "
          f"{ap['segments_with_decisions']} run segment(s)\n")
        w(f"  last decision      every {last['interval_steps']} steps @ "
          f"step {last['step']} ({last['reason']}; engine "
          f"{last['engine']})\n")
        if last.get("mtti_s") is not None:
            w(f"  failure model      {last['failures_observed']} "
              f"interruption(s), MTTI ~{last['mtti_s']:.1f}s, save cost "
              f"~{last['cost_s']:.3f}s, step ~"
              f"{(last['step_iter_s'] or 0) * 1e3:.1f}ms\n")
        if last.get("optimum_steps") is not None:
            w(f"  Young-Daly optimum {last['optimum_steps']:.1f} steps "
              f"(sqrt(2 * cost * MTTI))\n")
        traj = ap.get("interval_trajectory") or []
        if len(traj) > 1:
            w(f"  interval trail     {' -> '.join(str(i) for i in traj)}\n")
        for eng in ap.get("engine_recommendations") or []:
            w(f"  RECOMMENDATION     switch --checkpoint-engine to {eng} "
              f"(measured save cost indefensible for the current "
              f"engine)\n")
        cf = ap.get("counterfactual")
        if cf:
            verb = "saved" if cf["delta_s"] >= 0 else "COST"
            w(f"  vs static          {verb} {_fmt_s(abs(cf['delta_s']))} "
              f"against the every-{cf['static_interval']}-steps static "
              f"policy on this event stream\n")
    sv = agg.get("serving") or {}
    if sv:
        w("\n-- serving (request latency) -----------------------------------\n")
        w(f"  requests           {sv['requests_done']} done of "
          f"{sv['requests_admitted']} admitted "
          f"({sv['new_tokens']} tokens generated)\n")
        for name, label in (("ttft_s", "ttft"), ("tpot_s", "tpot"),
                            ("e2e_s", "e2e")):
            p = sv.get(name) or {}
            if p.get("p50") is None:
                continue
            w(f"  {label:<18} p50 {p['p50'] * 1e3:9.2f}ms  "
              f"p95 {p['p95'] * 1e3:9.2f}ms  "
              f"p99 {p['p99'] * 1e3:9.2f}ms\n")
        if sv.get("kv_backpressure"):
            w(f"  KV BACKPRESSURE    {sv['kv_backpressure']} admission "
              f"stall(s) — pool exhausted, requests queued loudly\n")
        for wl in sv.get("weights_loaded", []):
            w(f"  weights loaded     {wl.get('engine')} checkpoint @ step "
              f"{wl.get('step')} ({wl.get('leaves')} leaves, "
              f"{wl.get('resharded_leaves')} resharded)\n")
    hs = agg.get("hotswap") or {}
    if hs:
        w("\n-- hot-swap (train→serve weights) ------------------------------\n")
        w(f"  swaps              {hs['swaps']} completed, "
          f"{hs['rejected']} rejected (serving @ step "
          f"{hs['last_step']})\n")
        total = hs["fetched_bytes"] + hs["reused_bytes"]
        pct = 100.0 * hs["reused_bytes"] / total if total else 0.0
        w(f"  bytes fetched      {hs['fetched_bytes'] / 2**20:.2f} MiB "
          f"({hs['reused_bytes'] / 2**20:.2f} MiB reused in place — "
          f"{pct:.1f}% of the state never moved)\n")
        if hs.get("swap_s_p50") is not None:
            w(f"  swap apply         p50 {hs['swap_s_p50'] * 1e3:.2f}ms  "
              f"p99 {hs['swap_s_p99'] * 1e3:.2f}ms "
              f"(fetch+verify+place, off the serve loop)\n")
        if hs.get("swap_window_e2e_p99") is not None:
            w(f"  p99 across swaps   "
              f"{hs['swap_window_e2e_p99'] * 1e3:.2f}ms e2e over "
              f"{hs['swap_window_requests']} request(s) finishing in a "
              f"swap window\n")
        for r in hs.get("rejected_reasons", []):
            w(f"  REJECTED           {r['path']}: {r['reason']}\n")
    fl = agg.get("fleet") or {}
    if fl:
        w("\n-- serving fleet (front door) ----------------------------------\n")
        w(f"  replicas           {len(fl['replicas_seen'])} seen "
          f"({', '.join(str(r) for r in fl['replicas_seen'])}) — "
          f"{fl['spawns']} spawn(s), {fl['deaths']} death(s), "
          f"{fl['quarantines']} quarantine(s)\n")
        w(f"  redrives           {fl['redrives']} request(s) redriven "
          f"across replica deaths (zero silent losses by accounting)\n")
        w(f"  shed               {fl['shed']} request(s) — "
          f"{fl['shed_rate_pct']:.2f}% of admitted traffic\n")
        p = fl.get("e2e_s") or {}
        if p.get("p50") is not None:
            w(f"  fleet e2e          p50 {p['p50'] * 1e3:9.2f}ms  "
              f"p95 {p['p95'] * 1e3:9.2f}ms  "
              f"p99 {p['p99'] * 1e3:9.2f}ms "
              f"({fl['requests_done']} request(s))\n")
        for rid_, rp in sorted(fl.get("per_replica_e2e_s", {}).items()):
            if rp.get("p50") is None:
                continue
            w(f"    replica {rid_:<8} p50 {rp['p50'] * 1e3:9.2f}ms  "
              f"p95 {rp['p95'] * 1e3:9.2f}ms  "
              f"p99 {rp['p99'] * 1e3:9.2f}ms\n")
        for v in fl.get("canary_verdicts", []):
            tail = f" ({v['reason']})" if v.get("reason") else ""
            w(f"  canary             {v['verdict'].upper()}{tail} — "
              f"{v.get('manifest')}, waved {v.get('waved')}\n")
    tr = agg.get("tracing") or {}
    if tr:
        w("\n-- request tracing (cross-process) -----------------------------\n")
        w(f"  traces             {tr['assembled']} assembled over "
          f"{tr['domains']} clock domain(s) — {tr['completed']} completed, "
          f"{tr['root_only']} root-only, {tr['orphan_spans']} orphan "
          f"span(s)\n")
        for bucket in traceassembly.BUCKETS:
            st = (tr.get("buckets") or {}).get(bucket)
            if st is None:
                continue
            w(f"    {bucket:<12} p50 {st['p50_s'] * 1e3:9.2f}ms  "
              f"p99 {st['p99_s'] * 1e3:9.2f}ms\n")
        if tr.get("exemplars"):
            kinds = ", ".join(
                f"{n} {r}" for r, n in sorted(tr["exemplars"].items()))
            w(f"  tail exemplars     {sum(tr['exemplars'].values())} "
              f"full tree(s) retained ({kinds})")
            if tr.get("dominant_tail_bucket"):
                w(f" — dominated by {tr['dominant_tail_bucket']}")
            w("\n")
        if tr.get("residual_violations"):
            w(f"  RESIDUAL           {tr['residual_violations']} trace(s) "
              f"outside the named tolerance\n")
    al = agg.get("alerts") or {}
    if al.get("events"):
        w("\n-- SLO alerts (exporter burn-rate rules) -----------------------\n")
        w(f"  {al['total_fires']} fire(s) across {len(al['rules'])} "
          f"rule(s) over a {al['span_s']:.1f}s stream\n")
        for name, r in sorted(al["rules"].items()):
            peak = (
                f", peak {r['peak_value']:.4g} vs threshold "
                f"{r['threshold']:.4g}"
                if isinstance(r.get("peak_value"), (int, float))
                and isinstance(r.get("threshold"), (int, float)) else ""
            )
            w(f"  {name:<18} {r['fires']} fire(s) / {r['clears']} "
              f"clear(s), first @ +{r['first_fire_s']}s, last @ "
              f"+{r['last_fire_s']}s\n")
            w(f"  {'':<18} firing {r['firing_s']}s — duty "
              f"{r['duty_pct']:.1f}%{peak}\n")
            if r.get("firing_at_end"):
                w(f"  {'':<18} STILL FIRING at stream end\n")
    ds = agg["data_stalls"]
    if ds["count"]:
        w(f"\n-- data loader: {ds['count']} stall(s), {ds['wait_s']}s waiting "
          f"on host-side tokenize/collate\n")
    pre = agg["preempt"]
    if pre["checks"] or pre["notices"] or pre["stops"] or pre["maintenance"]:
        w("\n-- preemption / maintenance ------------------------------------\n")
        w(f"  deadline checks {pre['checks']} | notices {pre['notices']}\n")
        for r in pre["stops"]:
            w(f"  STOP: {r}\n")
        for d in pre["maintenance"]:
            w(f"  MAINTENANCE: {d}\n")
    for warning in agg["warnings"]:
        w(f"\n  WARNING: {warning}\n")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("path", help="telemetry JSONL file")
    p.add_argument("--json", dest="json_out", default=None,
                   help="also write a BENCH-compatible JSON blob here")
    args = p.parse_args(argv)

    events = read_events(args.path)
    if not events:
        print(f"error: no telemetry events readable from {args.path}",
              file=sys.stderr)
        return 2
    agg = aggregate(events)
    render(agg)
    if args.json_out:
        blob = {
            "metric": "goodput_pct",
            "value": agg["goodput_pct"],
            "unit": "%",
            "extra": {
                "segments": agg["segments"],
                "totals": agg["totals"],
                "steps": agg["steps"],
                "metric_hists": agg["metric_hists"],
                "gauges": agg["gauges"],
                "health": agg["health"],
                "ckpt": agg["ckpt"],
                "ckpt_backpressure": agg["ckpt_backpressure"],
                "emergency": agg["emergency"],
                "wire": agg["wire"],
                "autopilot": agg["autopilot"],
                "serving": agg["serving"],
                "hotswap": agg["hotswap"],
                "fleet": agg["fleet"],
                "alerts": agg["alerts"],
                "data_stalls": agg["data_stalls"],
                "preempt": agg["preempt"],
            },
        }
        # a report artifact, written anew every run: a torn one fails its
        # reader loudly and is simply produced again
        with open(args.json_out, "w") as f:
            json.dump(blob, f, indent=2)
        print(f"\nwrote {args.json_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
