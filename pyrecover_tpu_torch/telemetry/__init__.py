"""pyrecover_tpu_torch.telemetry — structured event bus with pluggable sinks
(the JAX package's ``telemetry``: the same event names, fields, envelope,
JSONL files and postmortem bundles, so either package's readers read the
other's artifacts).

Every subsystem emits structured events (``emit("ckpt_commit", path=...,
write_s=...)``) through one process-wide bus into pluggable sinks: a host-0
JSONL file for real runs, an in-memory list for tests, the text log for
eyeballs. Costs nothing when no sink is registered and never synchronises
the device.

Event envelope (every record):
    ts      unix seconds (float)
    event   event name (str)
    host    torch.distributed rank of the emitting process (0 without one)

Core event names across the stack (fields beyond the envelope):
    run_start         devices, device_kind, processes, mesh, params_m, ...
    step_time         step, data_wait_s, dispatch_s
    train_sync        step, loss, steps, interval_s, iter_s, sync_s
    throughput        step, tokens_per_sec, mfu_pct, tflops, ...
    eval              step, loss, seconds
    ckpt_save_start   engine, path, background
    ckpt_commit       engine, path, bytes, write_s, checksum
    ckpt_save_blocking engine, path, blocking_s, background
    ckpt_save_shadow  engine, path, shadow_s, ok (background save work
                      that OVERLAPPED training — recovered goodput, split
                      from the blocking stall in WallTimeTotals)
    ckpt_saved        engine, path, step, blocking_s, final (one fully
                      handed-off save)
    ckpt_backpressure engine, path, wait_s (a save arrived while the
                      previous zerostall save was still writing; the
                      depth-1 queue made it wait, loudly)
    ckpt_gc           engine, removed, removed_bytes, kept, seconds
                      (refcounted chunk GC collected orphans; a chunk any
                      live manifest references is never collected)
    emergency_publish engine, step, exp_dir, leaves, bytes (a committed
                      zerostall snapshot entered the in-RAM tier)
    emergency_restore engine, step, seconds (_resume restored from RAM,
                      the disk tier bypassed)
    emergency_restore_rejected  reason, step (the freshness/digest gate
                      refused the RAM record; the disk tier is used)
    emergency_peer_exchange  engine, step, exp_dir, leaves, bytes (host 0's
                      record landed in every rank's RAM)
    elastic_resume    path, step, saved_topology, target_topology,
                      resharded_leaves, plan_bytes_moved (a checkpoint was
                      restored onto another topology, in a `reshard` span)
    elastic_preflight_failed  path, reason (the preflight rejected the
                      plan, SC11/SC05, before any restore I/O; the resume
                      falls back to an older checkpoint that fits)
    topology_mismatch path, reason, elastic_resume (--elastic-resume off and
                      the saved topology differs: TopologyMismatchError)
    ckpt_policy       step, source, engine, interval_steps,
                      prev_interval_steps, optimum_steps, optimum_s, cost_s,
                      mtti_s, step_iter_s, failures_observed,
                      failures_window, reason, floor, ceiling,
                      static_interval, engine_recommendation (one autopilot
                      decision under --checkpoint-frequency auto)
    ckpt_policy_sidecar_error  error (the failure-history sidecar could not
                      be written; the policy goes on with stale estimates)
    ckpt_bg_join      engine, waited_s, completed, ok, bounded (a pending
                      background save handle was joined — mid-run before
                      the next save, and with a bounded timeout on
                      train()'s unwind)
    remat_autosize    policy, fits, device_kind, budget_bytes,
                      table_bytes, batch_size, suggested_batch_size,
                      suggested_total_bytes (once per run under
                      --remat-policy auto)
    ckpt_save_durable engine, wait_s (a sharded save in flight was joined
                      and is durable)
    ckpt_restore_start/ckpt_restore_done  engine, path, seconds
    ckpt_precheck_failed / ckpt_restore_fallback  path, reason
    ckpt_io_retry     op, path, attempt, errno, delay_s (transient-IO retry)
    ckpt_quarantined  path, dest, reason (moved into .corrupt/, never pruned)
    ckpt_prune        engine, count, removed
    ckpt_pruned       engine, path, step (one per retention removal)
    resume            path, step, seconds; resume_replay: replayed_steps
    sampler_rescaled  saved_replicas, target_replicas, consumed (a resume at
                      another data-parallel size: the global cursor kept,
                      each replica's rows re-split)
    request_admitted  rid, prompt_tokens, max_new_tokens, blocks, slot,
                      queue_s (the serving scheduler admitted a request:
                      a decode slot plus its WHOLE KV-block footprint
                      were reserved)
    request_done      rid, prompt_tokens, new_tokens, blocks_released,
                      ttft_s, tpot_s, e2e_s (a request finished; its KV
                      blocks went back to the free list and its latencies
                      fed the ttft_s/tpot_s/e2e_s histograms)
    kv_backpressure   rid, needed_blocks, free_blocks, free_slots,
                      queued (the KV pool or slot table cannot admit the
                      head-of-queue request; once per stall episode)
    weights_loaded    engine, path, step, leaves, bytes, resharded_leaves,
                      plan_bytes_moved, seconds, target_topology (the
                      serving restore read the .params leaves of a
                      checkpoint of any engine onto the card)
    weights_swap_begin  path, engine, from_step, to_step (the hot-swap
                      watcher found a newer committed checkpoint and
                      started fetching; serving continues on the old
                      weights throughout)
    weights_swap_done  step, swap_s, in_flight, path, engine, from_step,
                      fetched_bytes, reused_bytes (the serving engine
                      flipped its model reference at a pass boundary;
                      swap_s covers fetch+verify+place+flip, in_flight
                      the requests that rode through untouched)
    weights_swap_rejected  path, engine, from_step, to_step, reason (a
                      fetch/digest/shape-stability failure: the manifest
                      is remembered as rejected, with no retry loop, and
                      the engine keeps serving the old weights)
    swap_fetch_bytes  path, incremental, fetched_bytes, reused_bytes,
                      chunks_fetched, chunks_reused, changed_leaves,
                      leaves (the swap's transfer ledger: an incremental
                      zerostall fetch moves only changed-digest chunks;
                      vanilla/sharded take a full read with reused_bytes 0)
    replica_spawned   replica, incarnation, pid, backoff_s (the fleet
                      supervisor (re)spawned a serving-replica subprocess;
                      incarnation 0 is the first spawn, backoff_s the
                      capped-exponential delay served before a respawn)
    replica_dead      replica, rc, incarnation, was_ready (the supervisor
                      saw a replica process exit; the router redrives its
                      orphaned requests and the slot heads to backoff or
                      quarantine)
    replica_quarantined  replica, strikes, rc (a slot died before becoming
                      ready `quarantine_after` consecutive times: it is
                      parked, never respawned)
    request_redriven  rid, from_replica, attempt, trace (a replica died
                      owning this accepted request; the router re-queued it
                      at the head of the line through the router_redrive
                      seam under io_retry)
    fleet_shed        rid, queued, inflight, replicas (SLO-aware admission
                      refused a request: every replica at max_inflight and
                      the router queue full; submitted == done + shed)
    trace_root        rid, trace, span, verdict, mono (the router minted a
                      distributed trace at admission: the deterministic
                      16-hex id of the rid and the ``<trace>:r`` root every
                      cross-process span of the request hangs under)
    fleet_send        rid, kind, attempt, trace, mono (a traced frame left a
                      process at the socket edge: kind "submit" on the
                      router, "done" on the replica; one half of the
                      skew-anchor pair traceassembly aligns clocks with)
    fleet_recv        rid, kind, attempt, trace, mono (the matching arrival
                      edge: "submit" on the replica, "done" on the router; a
                      killed attempt leaves its done legs unpaired)
    trace_exemplar    rid, trace, reason, e2e_s (tail-based retention mark
                      after a drain: reason redriven|shed|p99_tail;
                      traceassembly keeps the full tree only for these)
    canary_verdict    verdict, manifest, reason, canary, waved,
                      probe_p99_s, p99_gate_s (one canary rollout's outcome:
                      "pass" waved the manifest fleet-wide, "fail" rolled
                      every touched replica back to the pin-leased old
                      manifest; reason swap_rejected/token_mismatch/
                      p99_regression)
    preempt_check     step, time_left_s, threshold_s
    preempt_notice / preempt_stop / preempt_estimate
    preempt_signal_escalation  signal, count, step (2nd signal mid-save)
    data_stall        wait_s, depth, batch
    loader_stall_timeout  wait_s, timeout_s, batch (stall watchdog tripped)
    fault_injected    type, site, ... (resilience.faults fired an injection)
    mfu_peak_unknown  device_kind, fallback_flops
    hang_detected     silent_s, window_s, sources{} (run-health watchdog:
                      no heartbeat progress for a full window)
    flight_dump       reason, path, last_step (a postmortem bundle was
                      written under <exp_dir>/.postmortem/)
    recompile         fn, count, changed (train-step signature drift)
    implicit_transfer fn, step, error (a synchronizing CUDA call inside
                      the dispatch under --transfer-guard disallow)
    platform_fallback reason, resolved, expected (run is on CPU when an
                      accelerator was expected — perf numbers are not
                      accelerator numbers)
    distributed_wait_timeout  phase, timeout_s (a collective_phase-bounded
                      cross-process wait outlived its bound; a flight
                      bundle is dumped)
    ckpt_manifest_dtype_drift  path, detail (resume will cast the leaf)
    run_summary       status, step, + WallTimeTotals.as_dict() (goodput)

Serving spans + histograms (``serving/engine.py``): retroactive
``req_queue`` / ``req_prefill`` / ``req_decode`` spans per finished request,
a ``serving_restore`` span around the weight restore, and the ``ttft_s`` /
``tpot_s`` / ``e2e_s`` request-latency histograms. The fleet router
(``serving/fleet/router.py``) records the cross-process trace skeleton:
retroactive ``req_root`` (one per request, ``<trace>:r``) and
``fleet_attempt`` (one per dispatch attempt, ``<trace>:a<N>``) spans that
every replica-side span parents under.

Tracing + metrics events (``spans.py`` / ``metrics.py``):
    span_begin        name, span, parent, tid, thread, mono, ...
    span_end          name, span, parent, tid, mono, dur_s [, ok, error]
    span              retroactive span: name, span, parent, mono, dur_s
    metrics_snapshot  reason, counters{}, gauges{}, hists{name: {count,
                      sum, min, max, p50, p95, p99}}

Live metrics plane (``exporter.py`` / ``aggregate.py``): a per-process
HTTP exposition endpoint over the metrics registry, a fleet aggregator that
scrapes N endpoints over TCP, and SLO burn-rate alert rules evaluated on the
exporter's serve thread:
    exporter_started  host, port, url, rules[] (exposition endpoint up)
    exporter_stopped  host, port, scrapes, uptime_s (bounded-join stop)
    metrics_scrape    poll, targets, ok, stale, seconds (one aggregator
                      sweep over its scrape targets)
    slo_alert         rule, kind, state (firing|cleared), value,
                      threshold, window_s, series (a burn-rate rule
                      transitioned; the ``slo_alerts_total`` counter rides
                      along, and the doctor reads the trail)

``traceview.py`` merges multi-host shards into a Perfetto-loadable Chrome
trace with straggler, spike and checkpoint-phase analysis;
``traceassembly.py`` reassembles per-request trace trees from per-process
shards and attributes each request's latency to critical-path buckets
(``swap_stall`` included); ``top.py`` is the terminal dashboard over the
aggregator.

Failure-time half (``flight.py`` / ``watchdog.py`` / ``detectors.py`` /
``doctor.py``): an always-on in-memory ring of recent events + open spans,
black-box postmortem bundles under ``<exp_dir>/.postmortem/`` (unhandled
exceptions, fatal signals, SIGTERM escalation, watchdog hangs, explicit
``flight.dump``), silent-failure detectors (recompile / implicit sync /
platform fallback / device-memory gauges), and the ``doctor`` CLI
(``python -m pyrecover_tpu_torch.telemetry.doctor``) that classifies a dead
run from those artifacts.

Not ported, with the module that emits them: the maintenance watcher's
events (``maintenance.py`` polls the GCE metadata server for TPU events).
"""

from pyrecover_tpu_torch.telemetry import flight, metrics, spans, tracing, watchdog
from pyrecover_tpu_torch.telemetry.bus import (
    add_sink,
    close,
    emit,
    enabled,
    remove_sink,
)
from pyrecover_tpu_torch.telemetry.sinks import (
    JsonlSink,
    LogSink,
    MemorySink,
    last_recorded_step,
    read_events,
    rotated_paths,
)
from pyrecover_tpu_torch.telemetry.spans import collective_phase, record_span, span

__all__ = [
    "collective_phase",
    "emit",
    "enabled",
    "add_sink",
    "remove_sink",
    "close",
    "JsonlSink",
    "MemorySink",
    "LogSink",
    "read_events",
    "rotated_paths",
    "last_recorded_step",
    "span",
    "record_span",
    "spans",
    "tracing",
    "metrics",
    "flight",
    "watchdog",
]
