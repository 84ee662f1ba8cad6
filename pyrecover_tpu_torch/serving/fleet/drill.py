"""Fleet proof harness: the replica-loss chaos drill and the canary-rollback
drill (the JAX package's ``serving/fleet/drill.py``: the same verdicts).

  * :func:`fleet_chaos_drill`: two or more replica subprocesses behind the
    front door under seeded open-loop load. One replica is SIGKILLed
    mid-flight through the ``replica_kill`` fault seam (rc -9, an
    announce-then-kill trail in its telemetry shard) while the parent
    injects a transient I/O error into the router's ``router_redrive`` seam.
    Verdicts: the multi-target workload split reassembles into the
    single-stream Poisson process exactly; the baseline's accounting is
    exact; every replica's probe equals a cold restore's; the aggregator
    sees every replica live; admission under zeroed capacity sheds loudly
    (a ``fleet_shed`` per request, counted); the killed replica exits rc -9;
    ``submitted == done + shed`` with at least one request redriven and every
    result equal to the no-kill baseline's; the kill-window fleet p99 stays
    within ``P99_FACTOR * baseline_p99 + P99_SLACK_S``; the supervisor
    respawns the killed replica and the respawn serves the cold-restore
    probe; a crash-looping replica (no checkpoint, rc 2), run beside the
    rest, is quarantined after exactly ``quarantine_after`` spawns. Every completed request
    assembles (:mod:`pyrecover_tpu_torch.telemetry.traceassembly`) into
    exactly one rooted trace with zero orphan spans, the redriven request's
    trace links both attempts under one root with the kill hole in
    ``redrive_gap``, and the critical-path buckets sum to e2e within the
    named residual tolerance. The parent's fleet events and every replica's
    shard (tagged by replica) are merged into one ``fleet_telemetry.jsonl``.
  * :func:`canary_rollout_drill`: three manifests: old (serving), healthy
    (the true next release), divergent (other weights claiming the same
    release). Rolling out the divergent one canaries it on one replica,
    fails the token gate, rolls back, and leaves every replica on the old
    manifest serving a cold restore's probe tokens, with the pin lease still
    held and the other replica never off the old step. Rolling out the
    healthy one passes the canary gate and waves to every replica with no
    swap rejected.

Both run on the card unless ``device="cpu"`` is asked for, at the
``model_config`` given (the tiny fp32 model by default): the parent's
checkpoints, cold restores and every replica process use the same config and
device. Token equality: on the CPU every comparison is exact, as the JAX
drill's. On the card a result decoded in another batch (a redriven request,
a probe in a live engine) may differ from its reference in the last bits of
fp32 products, so a divergence is excused only at a near-tie: where greedy
lockstep decoding (``generate_tokens``) of a cold restore of the same
manifest has its top two logits within ``NEAR_TIE_GAP`` at the first token
that departs from it. Each report counts the divergences it excused.

The replica process is :mod:`replica` (``python -m
pyrecover_tpu_torch.serving.fleet.replica``). ``python -m
pyrecover_tpu_torch.serving.fleet.drill WORKDIR [--drill chaos|canary|both]
[--device cpu] [--model-config JSON] [--json OUT]`` runs the drills and
prints their report as one JSON line.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.resilience import faults
from pyrecover_tpu_torch.serving.fleet.rollout import _p99, canary_rollout
from pyrecover_tpu_torch.serving.fleet.router import FleetRouter
from pyrecover_tpu_torch.serving.fleet.supervisor import QUARANTINED, READY, ReplicaSupervisor
from pyrecover_tpu_torch.serving.hotswap.drill import (
    P99_FACTOR,
    P99_SLACK_S,
    SEED,
    _restore,
    _scan_status,
    _serving_config,
    _train_state,
    drill_model_config,
    probe_workload,
    run_probe,
    save_zs,
)
from pyrecover_tpu_torch.serving.loadgen import open_loop_workload, request_id
from pyrecover_tpu_torch.telemetry import traceassembly, tracing

_READY_TIMEOUT_S = 180.0
# the chaos drill's fleet and load, the JAX drill's defaults: N_REPLICAS
# replicas, DURATION_S of seeded open-loop arrivals at ARRIVAL_RATE a second,
# the kill after KILL_AFTER completed requests
N_REPLICAS, DURATION_S, ARRIVAL_RATE, KILL_AFTER = 2, 2.0, 25.0, 3
# how long a drill waits for a drain, or for a rollout's replies
DRILL_TIMEOUT_S = 240.0
# the top-two logit gap under which an fp32 greedy pick on the card may go
# either way with the batch a token was decoded in (chip_smoke.py's
# GREEDY_GAP, item 8)
NEAR_TIE_GAP = 1e-3


# ---- replica process plumbing ----------------------------------------------


def _replica_cmd(exp, status, telem, cfg, device, *, replica_id, manifest=None):
    cmd = [sys.executable, "-m", "pyrecover_tpu_torch.serving.fleet.replica",
           "--exp", str(exp), "--status", str(status), "--telemetry", str(telem),
           "--replica-id", str(replica_id), "--device", device.type,
           "--model-config", json.dumps(dataclasses.asdict(cfg))]
    if manifest is not None:
        cmd += ["--manifest", str(manifest)]
    return cmd


def _spawn_replica(exp, status, telem, cfg, device, *, log, fault_plan=None, **kw):
    env = dict(os.environ)
    env.pop("PYRECOVER_METRICS_PORT", None)
    if fault_plan is not None:
        env["PYRECOVER_FAULT_PLAN"] = json.dumps(fault_plan)
    else:
        env.pop("PYRECOVER_FAULT_PLAN", None)
    with open(log, "ab") as out:
        return subprocess.Popen(_replica_cmd(exp, status, telem, cfg, device, **kw), env=env,
                                stdout=out, stderr=subprocess.STDOUT)


class _Fleet:
    """Drill-side wiring: a supervisor spawning real replica subprocesses,
    readiness through each incarnation's status JSONL, and a router that
    attaches each replica as it reports ready. Each incarnation's output
    goes to ``replica_<slot>_<incarnation>.log`` in ``workdir``."""

    def __init__(self, exp, workdir, n_replicas, cfg, device, *, fault_plans=None,
                 manifest=None, backoff_base_s=0.1, backoff_max_s=1.0, quarantine_after=3,
                 max_inflight=8, max_queue=256, trace_epoch=""):
        self.exp = Path(exp)
        self.workdir = _fresh_dir(workdir)
        self.n_replicas = n_replicas
        self.cfg = cfg
        self.device = device
        self.manifest = manifest
        self.fault_plans = dict(fault_plans or {})
        self.shards = {slot: self.workdir / f"replica_{slot}_telemetry.jsonl"
                       for slot in range(n_replicas)}
        # guards procs/status/t_spawn/ready_info/ready_s (monitor thread + drill)
        self._plock = threading.Lock()
        self.procs = {}       # (slot, incarnation) -> Popen
        self.status = {}      # (slot, incarnation) -> status path
        self.t_spawn = {}     # (slot, incarnation) -> monotonic spawn time
        self.ready_info = {}  # slot -> latest ready record
        self.ready_s = {}     # (slot, incarnation) -> spawn-to-ready, restore, warm s
        self.router = FleetRouter(max_inflight=max_inflight, max_queue=max_queue,
                                  trace_epoch=trace_epoch)
        self.sup = ReplicaSupervisor(n_replicas, self._spawn, self._ready_check,
                                     on_ready=self._on_ready, backoff_base_s=backoff_base_s,
                                     backoff_max_s=backoff_max_s,
                                     quarantine_after=quarantine_after)

    def _spawn(self, slot, incarnation):
        status = self.workdir / f"replica_{slot}_{incarnation}.status.jsonl"
        t0 = time.monotonic()
        proc = _spawn_replica(self.exp, status, self.shards[slot], self.cfg, self.device,
                              log=self.workdir / f"replica_{slot}_{incarnation}.log",
                              replica_id=slot, manifest=self.manifest,
                              fault_plan=self.fault_plans.get((slot, incarnation)))
        with self._plock:
            self.procs[(slot, incarnation)] = proc
            self.status[(slot, incarnation)] = status
            self.t_spawn[(slot, incarnation)] = t0
        return proc

    def _ready_check(self, slot, incarnation, proc):
        with self._plock:
            status = self.status[(slot, incarnation)]
        rec = _scan_status(status, "ready")
        return None if rec is None else dict(rec, incarnation=incarnation)

    def _on_ready(self, slot, info):
        key = (slot, info["incarnation"])
        t_ready = time.monotonic()
        self.router.connect(slot, "127.0.0.1", info["port"])
        # recorded once the router can reach it
        with self._plock:
            self.ready_info[slot] = dict(info)
            self.ready_s[key] = {"ready_s": round(t_ready - self.t_spawn[key], 3),
                                 "restore_s": info.get("restore_s"),
                                 "warm_s": info.get("warm_s")}

    def proc(self, slot, incarnation):
        with self._plock:
            return self.procs[(slot, incarnation)]

    def spawn_to_ready_s(self):
        """``{"<slot>.<incarnation>": {"ready_s", "restore_s", "warm_s"}}`` of
        every incarnation that became ready: its spawn-to-ready seconds, and
        the restore's and warm-up's seconds within them."""
        with self._plock:
            return {f"{s}.{i}": dict(v) for (s, i), v in sorted(self.ready_s.items())}

    def metrics_targets(self):
        with self._plock:
            return [f"127.0.0.1:{info['metrics_port']}"
                    for _, info in sorted(self.ready_info.items())]

    def start(self, *, timeout_s=_READY_TIMEOUT_S):
        self.sup.start()
        self.wait_ready(timeout_s=timeout_s)

    def wait_ready(self, slots=None, *, timeout_s=_READY_TIMEOUT_S):
        slots = list(range(self.n_replicas)) if slots is None else slots
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            states = self.sup.states()
            if all(states[s] == READY for s in slots):
                return
            time.sleep(0.05)
        raise TimeoutError(f"fleet drill: replicas not ready within {timeout_s}s "
                           f"(states {self.sup.states()}; logs in {self.workdir})")

    def probe(self, slot, *, timeout_s=120.0):
        return self.router.request(slot, {"type": "probe", "seed": SEED}, "probe_result",
                                   timeout_s=timeout_s)

    def status_of(self, slot, *, timeout_s=60.0):
        return self.router.request(slot, {"type": "status"}, "status_result",
                                   timeout_s=timeout_s)

    def stop(self):
        self.router.close()
        self.sup.stop()


def _fresh_dir(path):
    """``path`` emptied: a rerun must not read an earlier run's status
    records, shards or manifests."""
    path = Path(path)
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def _run_open_loop(router, workload, *, timeout_s=120.0):
    """Drive the seeded arrival process through the front door and drain.
    Returns the router's accounting after the drain."""
    t0 = time.monotonic()
    for req in workload:
        delay = req["arrival_s"] - (time.monotonic() - t0)
        if delay > 0:
            time.sleep(delay)
        router.submit({"rid": req["rid"], "prompt": req["prompt"],
                       "max_new_tokens": req["max_new_tokens"]})
    router.drain(timeout_s)
    return router.accounting()


def _cold_probe(manifest, cfg, device):
    """Ground truth: restore the manifest cold in the parent and serve the
    probe through a fresh engine."""
    from pyrecover_tpu_torch.serving.engine import ServingEngine

    engine = ServingEngine(_restore(Path(manifest), cfg, device), _serving_config())
    tokens = run_probe(engine, probe_workload(cfg))
    del engine
    _free_cached(device)
    return tokens


def _free_cached(device):
    if device.type == "cuda":
        import torch

        torch.cuda.empty_cache()


def _merge_shards(out_path, parent_jsonl, shards):
    """Merge the parent's fleet events with every replica's telemetry shard
    (tagged ``replica=<slot>``) into one JSONL."""
    lines = []
    if Path(parent_jsonl).exists():
        for e in telemetry.read_events(parent_jsonl):
            lines.append(json.dumps(e))
    for slot, shard in sorted(shards.items()):
        if not Path(shard).exists():
            continue
        for e in telemetry.read_events(shard):
            e.setdefault("replica", slot)
            lines.append(json.dumps(e))
    # a report artifact, rebuilt from the shards on every drill run
    Path(out_path).write_text("\n".join(lines) + "\n")
    return len(lines)


class _TokenCheck:
    """Token equality of served results with a reference on one manifest
    (the module docstring's rule): exact on the CPU; on the card
    (``near_ties``) a divergence is excused only at a near-tie of lockstep
    decoding of the manifest's cold restore. ``excused`` counts the excused
    results, ``gaps`` holds their top-two gaps."""

    def __init__(self, manifest, cfg, device, *, near_ties=None):
        self.manifest, self.cfg, self.device = Path(manifest), cfg, device
        self.near_ties = device.type == "cuda" if near_ties is None else near_ties
        self.excused = 0
        self.gaps = []
        self._model = None

    def _gap(self, ref, j):
        """Lockstep's top-two logit gap at position ``j`` of its own
        sequence ``ref``."""
        import torch

        from pyrecover_tpu_torch.models.decode import decode_forward, init_kv_cache

        cache = init_kv_cache(self._model.config, 1, j, device=self.device)
        with torch.inference_mode():
            top2 = decode_forward(self._model, cache,
                                  torch.tensor([ref[:j]], device=self.device), 0)[0, -1]
            top2 = top2.float().topk(2).values
        return (top2[0] - top2[1]).item()

    def same(self, reqs, gots, wants):
        """True when every ``got`` equals its ``want``, or (on the card) each
        that differs departs from lockstep only at a near-tie; the excused
        count moves only when the whole set passes."""
        if len(gots) != len(wants):
            return False
        diverged = [(r, g, w) for r, g, w in zip(reqs, gots, wants) if g != w]
        if not diverged:
            return True
        if not self.near_ties or any(g is None or w is None for _, g, w in diverged):
            return False
        from pyrecover_tpu_torch.models.decode import generate_tokens

        if self._model is None:
            self._model = _restore(self.manifest, self.cfg, self.device)
        gaps = []
        for req, got, want in diverged:
            ref = generate_tokens(self._model, req["prompt"], req["max_new_tokens"])
            for seq in (got, want):
                if seq == ref:
                    continue
                if len(seq) != len(ref):
                    return False
                gaps.append(self._gap(ref, next(i for i, (a, b) in enumerate(zip(seq, ref))
                                                if a != b)))
        if any(g > NEAR_TIE_GAP for g in gaps):
            return False
        self.gaps += [round(g, 6) for g in gaps]
        self.excused += len(diverged)
        return True

    def release(self):
        self._model = None
        _free_cached(self.device)


# ---- replica-loss chaos drill ----------------------------------------------


def fleet_chaos_drill(workdir, *, model_config=None, device="cuda"):
    """SIGKILL a replica under open-loop load; prove zero silent loss (the
    module docstring's verdicts). Returns the report dict; raises
    AssertionError on any violated invariant."""
    from pyrecover_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    cfg = model_config or drill_model_config()
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    parent_jsonl = workdir / "fleet_parent_telemetry.jsonl"
    parent_jsonl.unlink(missing_ok=True)
    sink = telemetry.JsonlSink(parent_jsonl)
    telemetry.add_sink(sink)
    mem = telemetry.MemorySink()
    telemetry.add_sink(mem)
    # phase C, started first: a crash-looper (nothing to serve) runs beside
    # phases A and B, and must be quarantined, not restarted forever
    fleet_c = _Fleet(_fresh_dir(workdir / "empty_exp"), workdir / "fleet_c", 1, cfg, device,
                     backoff_base_s=0.05, backoff_max_s=0.2, quarantine_after=3,
                     trace_epoch="c")
    try:
        fleet_c.sup.start()
        report = _chaos_body(workdir, mem, cfg, device, fleet_c)
    finally:
        fleet_c.sup.stop()
        telemetry.remove_sink(mem)
        telemetry.remove_sink(sink)
        sink.close()
    shards = {slot: workdir / f"fleet_b/replica_{slot}_telemetry.jsonl"
              for slot in range(N_REPLICAS)}
    shards[N_REPLICAS] = workdir / "fleet_c/replica_0_telemetry.jsonl"
    report["telemetry_records"] = _merge_shards(workdir / "fleet_telemetry.jsonl", parent_jsonl,
                                                shards)
    return report


def _chaos_body(workdir, mem, cfg, device, fleet_c):
    exp = _fresh_dir(workdir / "exp")
    model, optimizer = _train_state(cfg, SEED, device)
    manifest = save_zs(exp, 1, model, optimizer)
    del model, optimizer
    _free_cached(device)
    probe = probe_workload(cfg)
    probe_tokens = _cold_probe(manifest, cfg, device)
    check = _TokenCheck(manifest, cfg, device)

    # ---- the multi-target split must BE the single-stream process ----
    max_len = _serving_config().max_model_len
    single = open_loop_workload(DURATION_S, vocab_size=cfg.vocab_size, max_model_len=max_len,
                                seed=SEED, arrival_rate=ARRIVAL_RATE)
    streams = open_loop_workload(DURATION_S, vocab_size=cfg.vocab_size, max_model_len=max_len,
                                 seed=SEED, arrival_rate=ARRIVAL_RATE, targets=N_REPLICAS)
    merged = sorted((req for stream in streams for req in stream), key=lambda r: r["arrival_s"])
    if merged != single:
        raise AssertionError("fleet drill: the multi-target split does not reassemble into the "
                             "global Poisson process")
    by_rid = {req["rid"]: req for req in single}

    # ---- phase A: the no-kill baseline fleet --------------------------
    fleet_a = _Fleet(exp, workdir / "fleet_a", N_REPLICAS, cfg, device, trace_epoch="a")
    try:
        fleet_a.start()
        acc_a = _run_open_loop(fleet_a.router, single, timeout_s=DRILL_TIMEOUT_S)
        if acc_a["done"] != acc_a["submitted"] or acc_a["shed"]:
            raise AssertionError(f"fleet drill: baseline accounting {acc_a}")
        baseline = fleet_a.router.results
        baseline_p99 = _p99(fleet_a.router.latencies())
        for slot in range(N_REPLICAS):
            if not check.same(probe, fleet_a.probe(slot)["tokens"], probe_tokens):
                raise AssertionError(f"fleet drill: baseline replica {slot} probe diverged from "
                                     "the cold restore")
        peak_mem = {slot: fleet_a.status_of(slot).get("peak_mem_bytes")
                    for slot in range(N_REPLICAS)}

        # one merged fleet view over every replica's live metrics exporter
        from pyrecover_tpu_torch.telemetry.aggregate import FleetAggregator

        snap = FleetAggregator(fleet_a.metrics_targets()).poll()
        if len(snap["targets"]) != N_REPLICAS or snap["stale"]:
            raise AssertionError(f"fleet drill: the aggregator saw {len(snap['targets'])} "
                                 f"targets (stale {snap['stale']}), wanted {N_REPLICAS} live")

        # admission under zero capacity sheds loudly, never silently
        fleet_a.router.max_inflight = 0
        fleet_a.router.max_queue = 0
        shed_rids = [request_id(SEED + 777, i) for i in range(3)]
        for rid in shed_rids:
            verdict = fleet_a.router.submit({"rid": rid, "prompt": [1, 2, 3],
                                             "max_new_tokens": 2})
            if verdict != "shed":
                raise AssertionError(f"fleet drill: zero-capacity submit was {verdict!r}")
        shed_events = {e["rid"] for e in mem.events if e["event"] == "fleet_shed"}
        if not set(shed_rids) <= shed_events:
            raise AssertionError("fleet drill: shed requests are missing their events")
        acc_a = fleet_a.router.accounting()
        if acc_a["submitted"] != acc_a["done"] + acc_a["shed"]:
            raise AssertionError(f"fleet drill: shed accounting leaks requests {acc_a}")
        ready_a = fleet_a.spawn_to_ready_s()
    finally:
        fleet_a.stop()

    # ---- phase B: SIGKILL one replica mid-flight ----------------------
    # replica 1's first incarnation carries the kill plan: announce
    # fault_injected to its shard, then SIGKILL itself after `KILL_AFTER`
    # completed requests. Respawns carry no plan.
    kill_plan = {"seed": SEED, "faults": [{"type": "kill9_during_save", "site": "replica_kill",
                                           "save_index": 0, "after_bytes": KILL_AFTER}]}
    fleet_b = _Fleet(exp, workdir / "fleet_b", N_REPLICAS, cfg, device,
                     fault_plans={(1, 0): kill_plan}, trace_epoch="b")
    try:
        # the parent's redrive seam: the first redrive hits a transient I/O
        # error and must retry through io_retry, never drop the request
        faults.install({"seed": SEED, "faults": [{"type": "transient_io_error", "op": "redrive",
                                                  "fail_count": 1}]})
        try:
            fleet_b.start()
            acc_b = _run_open_loop(fleet_b.router, single, timeout_s=DRILL_TIMEOUT_S)
        finally:
            faults.clear()
        kill_p99 = _p99(fleet_b.router.latencies())
        p99_gate = P99_FACTOR * baseline_p99 + P99_SLACK_S

        proc_killed = fleet_b.proc(1, 0)
        proc_killed.wait(timeout=30)
        if proc_killed.returncode != -9:
            raise AssertionError(f"fleet drill: the killed replica exited rc "
                                 f"{proc_killed.returncode}, wanted -9 (SIGKILL)")
        if acc_b["submitted"] != acc_b["done"] + acc_b["shed"] or acc_b["shed"]:
            raise AssertionError(f"fleet drill: kill-run accounting leaks requests {acc_b}")
        if acc_b["redriven"] < 1:
            raise AssertionError("fleet drill: a replica died but nothing was redriven")
        results_b = fleet_b.router.results
        for rid, tokens in baseline.items():
            if not check.same([by_rid[rid]], [results_b.get(rid)], [tokens]):
                raise AssertionError(f"fleet drill: request {rid} diverged after the redrive")
        if kill_p99 > p99_gate:
            raise AssertionError(f"fleet drill: kill-window p99 {kill_p99:.3f}s exceeds "
                                 f"{P99_FACTOR}x baseline {baseline_p99:.3f}s + {P99_SLACK_S}s")

        # the announce-then-kill trail in the killed replica's shard
        shard = telemetry.read_events(fleet_b.shards[1])
        kills = [e for e in shard
                 if e["event"] == "fault_injected" and e.get("site") == "replica_kill"]
        if not kills:
            raise AssertionError("fleet drill: no fault_injected trail in the killed replica's "
                                 "shard: the kill was silent")
        # the parent's redrive trail: event, injected transient, and retry
        redriven = [e for e in mem.events if e["event"] == "request_redriven"]
        seam = [e for e in mem.events
                if e["event"] == "fault_injected" and e.get("site") == "router_redrive"]
        retries = [e for e in mem.events
                   if e["event"] == "ckpt_io_retry" and e.get("op") == "redrive"]
        if not redriven or not seam or not retries:
            raise AssertionError(f"fleet drill: torn redrive trail: redriven={len(redriven)} "
                                 f"seam={len(seam)} retries={len(retries)}")

        # the supervisor respawned the dead slot (this fleet's incarnation 1
        # became ready), and the respawn serves the same weights
        deadline = time.monotonic() + _READY_TIMEOUT_S
        while "1.1" not in fleet_b.spawn_to_ready_s() and time.monotonic() < deadline:
            time.sleep(0.05)
        spawned = fleet_b.sup.spawns(1)
        if "1.1" not in fleet_b.spawn_to_ready_s():
            raise AssertionError(f"fleet drill: the killed replica was not respawned ready "
                                 f"({spawned} spawns, states {fleet_b.sup.states()})")
        if not check.same(probe, fleet_b.probe(1)["tokens"], probe_tokens):
            raise AssertionError("fleet drill: the respawned replica's probe diverged")
        dead = [e for e in mem.events if e["event"] == "replica_dead" and e.get("replica") == 1]
        if not dead:
            raise AssertionError("fleet drill: the replica's death went unobserved")
        ready_b = fleet_b.spawn_to_ready_s()
    finally:
        fleet_b.stop()
    check.release()

    # ---- trace completeness -------------------------------------------
    # Every completed request assembles into exactly ONE rooted,
    # skew-corrected trace with zero orphan spans; the redriven request
    # links BOTH attempts under one root with the kill hole in redrive_gap;
    # the critical-path buckets sum to e2e within the named residual
    # tolerance. The replica shards are whole here (both fleets stopped,
    # each event flushed as written).
    domains = [traceassembly.Domain("parent", list(mem.events))]
    for fleet, tag in ((fleet_a, "fleet_a"), (fleet_b, "fleet_b")):
        for slot in range(N_REPLICAS):
            events = telemetry.read_events(fleet.shards[slot])
            if events:
                domains.append(traceassembly.Domain(f"{tag}/replica_{slot}", events))
    trace_report = traceassembly.assemble(domains)
    per_trace = trace_report["per_trace"]
    if trace_report["traces"]["orphan_spans"]:
        raise AssertionError(f"fleet drill: {trace_report['traces']['orphan_spans']} orphan "
                             f"span(s) detached from their request roots "
                             f"(e.g. {trace_report['orphans'][:3]})")
    untraced = [(epoch, rid) for epoch, results in (("a", baseline), ("b", results_b))
                for rid in results
                if "e2e_s" not in per_trace.get(tracing.trace_id(rid, epoch), {})]
    if untraced:
        raise AssertionError(f"fleet drill: {len(untraced)} completed request(s) have no "
                             f"completed trace (e.g. {untraced[:3]})")
    redriven_rids = sorted({e["rid"] for e in redriven})
    redrive_gap_s = 0.0
    for rid in redriven_rids:
        entry = per_trace[tracing.trace_id(rid, "b")]
        gap = entry["buckets"]["redrive_gap"]
        if entry["attempts"] < 2 or gap <= 0.0:
            raise AssertionError(f"fleet drill: redriven request {rid}'s trace does not link both "
                                 f"attempts under one root with the kill hole in redrive_gap "
                                 f"({entry})")
        redrive_gap_s = max(redrive_gap_s, gap)
    residual_bad = [e for e in per_trace.values() if e.get("complete") and not e["residual_ok"]]
    if residual_bad:
        raise AssertionError(f"fleet drill: critical-path buckets do not sum to e2e within the "
                             f"named residual tolerance for {len(residual_bad)} trace(s) "
                             f"(e.g. {residual_bad[:2]})")

    # ---- phase C (started before phase A): the crash-looper ------------
    deadline = time.monotonic() + _READY_TIMEOUT_S
    while fleet_c.sup.state(0) != QUARANTINED and time.monotonic() < deadline:
        time.sleep(0.05)
    state = fleet_c.sup.state(0)
    spawns = fleet_c.sup.spawns(0)
    if state != QUARANTINED:
        raise AssertionError(f"fleet drill: crash-looper state {state!r}, not quarantined")
    if spawns != 3:
        raise AssertionError(f"fleet drill: the crash-looper spawned {spawns} times, wanted "
                             "exactly 3 (quarantine_after)")
    if not [e for e in mem.events if e["event"] == "replica_quarantined"]:
        raise AssertionError("fleet drill: the quarantine was silent")

    return {
        "replicas": N_REPLICAS,
        "device": device.type,
        "requests": len(single),
        "spawn_to_ready_s": {"a": ready_a, "b": ready_b},
        "peak_mem_bytes": peak_mem,
        "baseline_p99_s": round(baseline_p99, 4),
        "kill_p99_s": round(kill_p99, 4),
        "p99_gate_s": round(p99_gate, 4),
        "killed_rc": proc_killed.returncode,
        "accounting": acc_b,
        "redriven": acc_b["redriven"],
        "shed": len(shed_rids),
        "respawns": spawned - 1,
        "quarantine_spawns": spawns,
        "aggregator_targets": len(snap["targets"]),
        "near_ties_excused": check.excused,
        "near_tie_gaps": check.gaps,
        "trace_assembled": trace_report["traces"]["assembled"],
        "trace_completed": trace_report["traces"]["completed"],
        "trace_orphans": trace_report["traces"]["orphan_spans"],
        "trace_redriven_linked": len(redriven_rids),
        "trace_redrive_gap_s": round(redrive_gap_s, 4),
        "trace_residual_violations": len(residual_bad),
        "trace_dominant_tail_bucket": trace_report["dominant_tail_bucket"],
    }


# ---- canary-rollback drill --------------------------------------------------


def canary_rollout_drill(workdir, *, model_config=None, device="cuda"):
    """A divergent manifest fails the canary gate and rolls back to the
    pinned old manifest; a healthy manifest waves to every replica. Returns
    the report dict; raises AssertionError on any violation."""
    from pyrecover_tpu_torch.checkpoint.zerostall import pins
    from pyrecover_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    cfg = model_config or drill_model_config()
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "canary_telemetry.jsonl").unlink(missing_ok=True)
    sink = telemetry.JsonlSink(workdir / "canary_telemetry.jsonl")
    telemetry.add_sink(sink)
    mem = telemetry.MemorySink()
    telemetry.add_sink(mem)
    fleet = None
    try:
        exp = _fresh_dir(workdir / "exp")
        # three releases with independently initialized weights: the gate
        # needs probe tokens that DIFFER between releases (the hot-swap
        # drill's lm-head perturbation moves every logit alike)
        releases = []
        for step in (1, 2, 3):
            model, optimizer = _train_state(cfg, SEED + step - 1, device)
            releases.append(save_zs(exp, step, model, optimizer))
            del model, optimizer
            _free_cached(device)
        m_old, m_healthy, m_divergent = releases
        probe = probe_workload(cfg)
        probe_old = _cold_probe(m_old, cfg, device)
        probe_new = _cold_probe(m_healthy, cfg, device)
        if probe_old == probe_new:
            raise AssertionError("canary drill: the releases serve identical probe tokens")
        check_old = _TokenCheck(m_old, cfg, device)
        check_new = _TokenCheck(m_healthy, cfg, device)

        fleet = _Fleet(exp, workdir / "fleet", 2, cfg, device, manifest=m_old,
                       trace_epoch="canary")
        fleet.start()
        pre = fleet.probe(0)
        if not check_old.same(probe, pre["tokens"], probe_old):
            raise AssertionError("canary drill: the fleet does not serve the old manifest")
        baseline_p99 = _p99(pre["e2e_s"])

        def rollout(manifest):
            return canary_rollout(fleet.router, [0, 1], manifest=manifest, old_manifest=m_old,
                                  exp_dir=exp, expected_tokens=probe_new,
                                  baseline_p99_s=baseline_p99, timeout_s=DRILL_TIMEOUT_S,
                                  tokens_match=lambda got, want: check_new.same(probe, got,
                                                                                want))

        # the divergent artifact claims to be the next release: it swaps
        # fine (a valid checkpoint) and the TOKEN gate catches it
        bad = rollout(m_divergent)
        if bad["verdict"] != "fail" or bad["reason"] != "token_mismatch":
            raise AssertionError(f"canary drill: divergent rollout verdict {bad['verdict']} "
                                 f"({bad['reason']}), wanted a token_mismatch fail")
        if bad["waved"]:
            raise AssertionError("canary drill: the divergent manifest leaked past the canary")
        live = [p.name for p in pins.live_pins(exp)]
        if not any(Path(m_old).name in name for name in live):
            raise AssertionError(f"canary drill: the old manifest is not pinned after the "
                                 f"rollback (live pins {live})")
        for slot in (0, 1):
            status = fleet.status_of(slot)
            if status["loaded_step"] != 1:
                raise AssertionError(f"canary drill: replica {slot} on step "
                                     f"{status['loaded_step']} after the rollback, wanted 1")
            if not check_old.same(probe, fleet.probe(slot)["tokens"], probe_old):
                raise AssertionError(f"canary drill: replica {slot}'s probe diverged from the "
                                     "cold restore after the rollback")
        pinned_after_rollback = live
        bad["lease"].release()  # the operator acks the failed rollout

        # the healthy release canaries, passes, and waves everywhere
        good = rollout(m_healthy)
        if good["verdict"] != "pass":
            raise AssertionError(f"canary drill: the healthy rollout failed ({good['reason']})")
        peak_mem = {}
        for slot in (0, 1):
            status = fleet.status_of(slot)
            peak_mem[slot] = status.get("peak_mem_bytes")
            if status["loaded_step"] != 2 or status["rejected"]:
                raise AssertionError(f"canary drill: replica {slot} step {status['loaded_step']} "
                                     f"rejected {status['rejected']} after the healthy wave")
            if not check_new.same(probe, fleet.probe(slot)["tokens"], probe_new):
                raise AssertionError(f"canary drill: replica {slot}'s probe diverged after the "
                                     "healthy wave")
        verdicts = [(e["verdict"], e["reason"]) for e in mem.events
                    if e["event"] == "canary_verdict"]
        if verdicts != [("fail", "token_mismatch"), ("pass", "")]:
            raise AssertionError(f"canary drill: verdict trail {verdicts}")
        spawn_to_ready = fleet.spawn_to_ready_s()
        fleet.stop()
        fleet = None
        # each swap as its replica recorded it (the shards are whole now)
        swaps = [{"replica": slot, "step": e["step"], "swap_s": e["swap_s"],
                  "fetched_bytes": e["fetched_bytes"], "reused_bytes": e["reused_bytes"]}
                 for slot in (0, 1)
                 for e in telemetry.read_events(workdir / "fleet" /
                                                f"replica_{slot}_telemetry.jsonl")
                 if e["event"] == "weights_swap_done"]
        return {
            "device": device.type,
            "divergent_verdict": bad["verdict"],
            "divergent_reason": bad["reason"],
            "rolled_back": bad["rolled_back"],
            "pinned_after_rollback": pinned_after_rollback,
            "healthy_verdict": good["verdict"],
            "healthy_waved": len(good["waved"]),
            "baseline_p99_s": round(baseline_p99, 4),
            "probe_p99_s": good["probe_p99_s"],
            "p99_gate_s": good["p99_gate_s"],
            "swaps": swaps,
            "spawn_to_ready_s": spawn_to_ready,
            "peak_mem_bytes": peak_mem,
            "near_ties_excused": check_old.excused + check_new.excused,
            "near_tie_gaps": check_old.gaps + check_new.gaps,
        }
    finally:
        if fleet is not None:
            fleet.stop()
        telemetry.remove_sink(mem)
        telemetry.remove_sink(sink)
        sink.close()


def fleet_smoke(workdir, *, model_config=None, device="cuda"):
    """Both drills, one merged report."""
    workdir = Path(workdir)
    return {"chaos": fleet_chaos_drill(workdir / "chaos", model_config=model_config,
                                       device=device),
            "canary": canary_rollout_drill(workdir / "canary", model_config=model_config,
                                           device=device)}


def main(argv=None):
    import argparse

    from pyrecover_tpu_torch.models.llama import ModelConfig

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir", help="the drills' working directory")
    ap.add_argument("--drill", choices=("chaos", "canary", "both"), default="both")
    ap.add_argument("--device", default="cuda",
                    help="the device to serve on (the card unless cpu is asked for)")
    ap.add_argument("--model-config", default=None,
                    help="the ModelConfig's fields as JSON (default: the tiny fp32 model)")
    ap.add_argument("--json", default=None, help="also write the report to this file")
    args = ap.parse_args(argv)
    cfg = ModelConfig(**json.loads(args.model_config)) if args.model_config else None
    workdir = Path(args.workdir)
    t0 = time.monotonic()
    if args.drill == "both":
        report = fleet_smoke(workdir, model_config=cfg, device=args.device)
    elif args.drill == "chaos":
        report = {"chaos": fleet_chaos_drill(workdir, model_config=cfg, device=args.device)}
    else:
        report = {"canary": canary_rollout_drill(workdir, model_config=cfg, device=args.device)}
    report["seconds"] = round(time.monotonic() - t0, 3)
    line = json.dumps(report)
    if args.json:
        Path(args.json).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
