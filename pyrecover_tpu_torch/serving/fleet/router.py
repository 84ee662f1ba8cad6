"""Fleet front-door router: least-loaded dispatch, SLO-aware admission and
redrive on death (the JAX package's ``serving/fleet/router.py``: the same
decisions, accounting and events).

The :class:`FleetRouter` owns every accepted request until it is done or
explicitly shed, never silently dropped:

* **Dispatch** is least-loaded (fewest outstanding requests, ties to the
  lower replica id) over the attached replicas, with optional session
  affinity: ``req["session"]`` picks a preferred replica by
  ``hash(str(session)) % n``, falling back to least-loaded when that
  replica is full or gone. The hash is Python's, so it varies with
  ``PYTHONHASHSEED`` across router processes, as the reference's does
  (``ROADMAP.md``, Queue 3); within one process both packages pick alike.
* **Admission** is SLO-aware: each replica carries at most
  ``max_inflight`` outstanding requests, overflow waits in a bounded router
  queue, and when that is full the request is **shed loudly**: a
  ``fleet_shed`` event and an exact entry in the accounting
  (``submitted == done + shed`` at drain).
* **Redrive**: request ids are deterministic (loadgen's
  ``request_id(seed, index)``) and the router tracks per-request ownership,
  so a replica death (connection EOF) turns every orphaned request into a
  ``request_redriven`` event plus a re-queue at the FRONT of the queue. The
  re-queue runs under ``io_retry(op="redrive")`` around the
  ``router_redrive`` fault seam: an injected transient I/O error retries
  with backoff, it never drops the request. Duplicate ``done`` frames (a
  replica that finished just as we redrove) dedup by rid.
* **Tracing**: the router is the trace authority. Admission mints a
  deterministic per-request trace (``trace_root`` event); each dispatch
  stamps an attempt context onto the wire frame (``fleet_send`` marker at
  the socket edge) and completion or redrive records the attempt span
  (``fleet_attempt``) plus, at completion, the ``req_root`` span, so a
  redriven request's attempts hang under one root. After a successful
  ``drain()`` the router marks tail exemplars (``trace_exemplar``: every
  redriven and shed rid plus the p99-slowest).

One lock (``_lock``) guards all tables; socket work (connect, send) and
every telemetry emit happen outside it. Reader threads live in
:class:`protocol.Connection`; ``close()`` bounds every join.
"""

import threading
import time
from collections import deque

from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.resilience import faults
from pyrecover_tpu_torch.resilience.retry import io_retry
from pyrecover_tpu_torch.serving.fleet import protocol
from pyrecover_tpu_torch.telemetry import tracing

_REPLY_TYPES = ("probe_result", "swap_result", "status_result")


class FleetRouter:
    """Route requests across replica connections; see the module docstring."""

    def __init__(self, *, max_inflight=8, max_queue=256, affinity=False, trace_epoch=""):
        self.max_inflight = int(max_inflight)
        self.max_queue = int(max_queue)
        self.affinity = bool(affinity)
        # deterministic trace-id qualifier: router deployments replaying the
        # same workload (the drill's baseline and kill phases) mint distinct
        # traces in a merged stream
        self.trace_epoch = str(trace_epoch)
        self._lock = threading.Lock()
        # every table below is guarded by _lock
        self._links = {}         # replica_id -> Connection
        self._outstanding = {}   # replica_id -> set of rids
        self._requests = {}      # rid -> request dict (accepted + shed)
        self._owner = {}         # rid -> replica_id | None (queued)
        self._queue = deque()    # rids waiting for capacity
        self._results = {}       # rid -> token list
        self._shed = set()       # rids refused at admission
        self._redrives = {}      # rid -> redrive attempts
        self._t_submit = {}      # rid -> monotonic submit time
        self._t_done = {}        # rid -> monotonic done time
        self._waiters = {}       # replica_id -> {reply_type: (Event, box)}
        self._trace = {}         # rid -> {trace, attempt, t_dispatch}
        self._exemplars = set()  # rids already marked trace_exemplar

    # ---- replica attachment ----------------------------------------------

    def connect(self, replica_id, host, port, *, timeout_s=10.0):
        """Dial a replica and attach it as a dispatch target; queued requests
        start flowing to it at once."""
        sock = protocol.connect(host, port, timeout_s=timeout_s)
        conn = protocol.Connection(
            sock, lambda msg, _c: self._on_message(replica_id, msg), name=f"router-r{replica_id}",
            on_eof=lambda _c: self._on_disconnect(replica_id))
        with self._lock:
            self._links[replica_id] = conn
            self._outstanding.setdefault(replica_id, set())
        self._pump()
        return conn

    def replicas(self):
        with self._lock:
            return sorted(self._links)

    # ---- request path -----------------------------------------------------

    def submit(self, req):
        """Admit one request dict (``rid``/``prompt``/``max_new_tokens``,
        optional ``session``). Returns ``"dispatched"``, ``"queued"``,
        ``"shed"``, or ``"dup"`` (the deterministic rid is already known)."""
        rid = req["rid"]
        sends = []
        shed_ctx = None
        t_sub = time.monotonic()
        tid = tracing.trace_id(rid, self.trace_epoch)
        with self._lock:
            if rid in self._requests:
                return "dup"
            self._requests[rid] = req
            self._t_submit[rid] = t_sub
            self._trace[rid] = {"trace": tid, "attempt": 0, "t_dispatch": None}
            target = self._pick_target_locked(req)
            if target is not None:
                self._dispatch_locked(rid, target, sends)
                verdict = "dispatched"
            elif len(self._queue) < self.max_queue:
                self._queue.append(rid)
                self._owner[rid] = None
                verdict = "queued"
            else:
                self._shed.add(rid)
                shed_ctx = {"queued": len(self._queue),
                            "inflight": sum(len(s) for s in self._outstanding.values()),
                            "replicas": len(self._links)}
                verdict = "shed"
        telemetry.emit("trace_root", rid=rid, trace=tid, span=tracing.root_span_id(tid),
                       verdict=verdict, mono=round(t_sub, 6))
        if shed_ctx is not None:
            telemetry.emit("fleet_shed", rid=rid, **shed_ctx)
        self._send_all(sends)
        return verdict

    def _pick_target_locked(self, req):
        """Least-loaded live replica with spare admission capacity; session
        affinity picks a deterministic preferred replica first."""
        candidates = [r for r in sorted(self._links)
                      if len(self._outstanding.get(r, ())) < self.max_inflight]
        if not candidates:
            return None
        session = req.get("session")
        if self.affinity and session is not None:
            ordered = sorted(self._links)
            pref = ordered[hash(str(session)) % len(ordered)]
            if pref in candidates:
                return pref
        return min(candidates, key=lambda r: (len(self._outstanding[r]), r))

    def _dispatch_locked(self, rid, target, sends):
        req = self._requests[rid]
        self._owner[rid] = target
        self._outstanding[target].add(rid)
        msg = {"type": "submit", "rid": rid, "prompt": req["prompt"],
               "max_new_tokens": req["max_new_tokens"]}
        tr = self._trace.get(rid)
        if tr is not None:
            tr["attempt"] += 1
            tr["t_dispatch"] = time.monotonic()
            msg["trace"] = {"trace": tr["trace"],
                            "span": tracing.attempt_span_id(tr["trace"], tr["attempt"]),
                            "attempt": tr["attempt"]}
        sends.append((target, msg))

    def _pump_locked(self, sends):
        while self._queue:
            rid = self._queue[0]
            target = self._pick_target_locked(self._requests[rid])
            if target is None:
                return
            self._queue.popleft()
            self._dispatch_locked(rid, target, sends)

    def _pump(self):
        sends = []
        with self._lock:
            self._pump_locked(sends)
        self._send_all(sends)

    def _send_all(self, sends):
        for target, msg in sends:
            with self._lock:
                conn = self._links.get(target)
            if conn is None:
                self._on_disconnect(target)
                continue
            if msg.get("type") == "submit" and "trace" in msg:
                # socket-edge marker: one half of the skew anchor pair trace
                # assembly aligns process clocks with
                telemetry.emit("fleet_send", rid=msg["rid"], kind="submit",
                               attempt=msg["trace"]["attempt"], trace=msg["trace"]["trace"],
                               mono=round(time.monotonic(), 6))
            try:
                conn.send(msg)
            except OSError:
                self._on_disconnect(target)

    # ---- inbound ----------------------------------------------------------

    def _on_message(self, replica_id, msg):
        kind = msg.get("type")
        if kind == "done":
            self._on_done(replica_id, msg)
        elif kind in _REPLY_TYPES:
            with self._lock:
                waiter = self._waiters.get(replica_id, {}).pop(kind, None)
            if waiter is not None:
                event, box = waiter
                box["reply"] = msg
                event.set()

    def _on_done(self, replica_id, msg):
        rid = msg.get("rid")
        t_recv = time.monotonic()
        sends = []
        finished = None
        with self._lock:
            self._outstanding.get(replica_id, set()).discard(rid)
            if rid in self._results or rid not in self._requests:
                return  # a duplicate done after a redrive raced completion
            self._results[rid] = msg.get("tokens")
            self._t_done[rid] = t_recv
            self._owner.pop(rid, None)
            tr = self._trace.get(rid)
            if tr is not None and tr["attempt"]:
                finished = (dict(tr), self._t_submit[rid], self._redrives.get(rid, 0))
            self._pump_locked(sends)
        if finished is not None:
            tr, t_sub, redrives = finished
            tid = tr["trace"]
            telemetry.emit("fleet_recv", rid=rid, kind="done", attempt=tr["attempt"], trace=tid,
                           mono=round(t_recv, 6))
            # retroactive attempt and root spans close the trace: every
            # replica-side span parents under one of these attempt ids
            telemetry.record_span("fleet_attempt", tr["t_dispatch"], t_recv,
                                  span_id=tracing.attempt_span_id(tid, tr["attempt"]),
                                  parent=tracing.root_span_id(tid), trace=tid,
                                  attempt=tr["attempt"], rid=rid)
            telemetry.record_span("req_root", t_sub, t_recv, span_id=tracing.root_span_id(tid),
                                  trace=tid, rid=rid, attempts=tr["attempt"], redrives=redrives)
        self._send_all(sends)

    def _on_disconnect(self, replica_id):
        """Replica death: detach the link and redrive every orphaned request.
        Idempotent: EOF and a failed send may both land here."""
        with self._lock:
            conn = self._links.pop(replica_id, None)
            orphans = sorted(self._outstanding.pop(replica_id, set()))
            waiters = self._waiters.pop(replica_id, {})
        for event, box in waiters.values():
            box["reply"] = None
            event.set()
        if conn is not None:
            conn.close()
        for rid in orphans:
            self._redrive(rid, replica_id)

    def _redrive(self, rid, from_replica):
        t_now = time.monotonic()
        with self._lock:
            attempt = self._redrives.get(rid, 0) + 1
            self._redrives[rid] = attempt
            tr = dict(self._trace.get(rid) or {})
        if tr.get("attempt"):
            # close the failed attempt's span so both attempts of a redriven
            # request link under one root; the hole between this close and
            # the next attempt's fleet_send is what assembly puts in
            # `redrive_gap`
            tid = tr["trace"]
            telemetry.record_span("fleet_attempt", tr["t_dispatch"], t_now,
                                  span_id=tracing.attempt_span_id(tid, tr["attempt"]),
                                  parent=tracing.root_span_id(tid), trace=tid,
                                  attempt=tr["attempt"], rid=rid, ok=False, redriven=True)
        telemetry.emit("request_redriven", rid=rid, from_replica=from_replica, attempt=attempt,
                       trace=tr.get("trace"))
        # the redrive seam: an injected transient error retries with capped
        # backoff; a redriven request is never dropped
        io_retry(lambda: faults.check("router_redrive", rid=rid, replica=from_replica),
                 op="redrive", path=str(rid))
        sends = []
        with self._lock:
            self._owner[rid] = None
            self._queue.appendleft(rid)
            self._pump_locked(sends)
        self._send_all(sends)

    # ---- sync RPC (probe / swap / status) ---------------------------------

    def request(self, replica_id, msg, reply_type, *, timeout_s=120.0):
        """Send one control message and wait for its typed reply. One
        outstanding RPC per (replica, reply type). Raises on timeout or on
        the replica's death mid-RPC."""
        if reply_type not in _REPLY_TYPES:
            raise ValueError(f"unknown reply type {reply_type!r}")
        event = threading.Event()
        box = {}
        with self._lock:
            conn = self._links.get(replica_id)
            if conn is None:
                raise ConnectionError(f"fleet router: replica {replica_id} is not attached")
            self._waiters.setdefault(replica_id, {})[reply_type] = (event, box)
        conn.send(msg)
        if not event.wait(timeout_s):
            with self._lock:
                self._waiters.get(replica_id, {}).pop(reply_type, None)
            raise TimeoutError(
                f"fleet router: no {reply_type} from replica {replica_id} within {timeout_s}s")
        if box.get("reply") is None:
            raise ConnectionError(f"fleet router: replica {replica_id} died mid-RPC")
        return box["reply"]

    # ---- accounting / drain ----------------------------------------------

    def accounting(self):
        with self._lock:
            return {
                "submitted": len(self._requests),
                "done": len(self._results),
                "shed": len(self._shed),
                "queued": len(self._queue),
                "inflight": sum(len(s) for s in self._outstanding.values()),
                "redriven": sum(self._redrives.values()),
                "redriven_rids": len(self._redrives),
            }

    @property
    def results(self):
        with self._lock:
            return dict(self._results)

    def latencies(self):
        """Each finished request's e2e seconds (router submit to done),
        redrive detours included."""
        with self._lock:
            return [self._t_done[rid] - self._t_submit[rid] for rid in self._results]

    def emit_trace_exemplars(self):
        """Tail-based exemplar marking: one ``trace_exemplar`` per
        interesting rid: every redriven and shed request plus the p99-slowest
        completions. Idempotent per rid, so repeated drains never duplicate
        markers."""
        with self._lock:
            lats = {rid: self._t_done[rid] - self._t_submit[rid] for rid in self._results}
            marks = {}  # rid -> (reason, e2e_s | None)
            if lats:
                vals = sorted(lats.values())
                p99 = vals[min(len(vals) - 1, int(0.99 * len(vals)))]
                for rid, e2e in lats.items():
                    if e2e >= p99:
                        marks[rid] = ("p99_tail", e2e)
            for rid in self._shed:
                marks[rid] = ("shed", None)
            for rid in self._redrives:
                if rid in lats:
                    marks[rid] = ("redriven", lats[rid])
            todo = sorted(set(marks) - self._exemplars)
            self._exemplars.update(todo)
            traces = {rid: t["trace"] for rid, t in self._trace.items()}
        for rid in todo:
            reason, e2e = marks[rid]
            telemetry.emit("trace_exemplar", rid=rid, trace=traces.get(rid), reason=reason,
                           e2e_s=None if e2e is None else round(e2e, 6))

    def drain(self, timeout_s=120.0):
        """Block until every accepted (non-shed) request has a result; tail
        exemplars are marked once the stream is drained."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self._lock:
                missing = set(self._requests) - self._shed - set(self._results)
            if not missing:
                self.emit_trace_exemplars()
                return
            if time.monotonic() > deadline:
                acc = self.accounting()
                raise TimeoutError(
                    f"fleet router: {len(missing)} requests undrained after {timeout_s}s ({acc})")
            self._pump()
            time.sleep(0.005)

    def close(self, timeout=10.0):
        """Detach and close every link (bounded reader joins). Detached links
        no longer trigger redrive: call after drain."""
        with self._lock:
            links = list(self._links.values())
            self._links.clear()
        for conn in links:
            conn.close(timeout)
