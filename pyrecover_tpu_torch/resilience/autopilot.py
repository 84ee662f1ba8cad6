"""Goodput autopilot: telemetry-driven adaptive checkpoint cadence (the JAX
package's ``resilience/autopilot.py``: the same sidecar, estimators,
decisions and ``ckpt_policy`` records).

The source paper's signature idea — deadline-aware checkpointing — watches
ONE known kill time and saves just before it. Real interruptions are a
*rate*: preemption notices, watchdog hangs, SIGKILL-style deaths and
doctor-classified crashes arrive continuously, and the repo already
measures everything the optimal policy needs (the ``ckpt_blocking_s``
stream, per-step wall time, the fault/preemption event trail). This module
closes the loop:

  * **Failure model.** ``FailureHistory`` is a sidecar JSON persisted in
    the experiment directory (``failure_history.json``) recording every
    interruption over the whole resume chain. It is fed at ``_resume``
    time by ``reconstruct_history``, which walks the telemetry stream's
    prior run segments and classifies each death the way ``doctor`` does:
    a segment that ends without a ``run_summary`` is a hard kill
    (SIGKILL/power loss), ``status=error`` is a crash,
    ``preempt_stop``/``preempt_signal_escalation``/``stopped_early`` are
    preemptions, and ``hang_detected`` windows count as hang
    interruptions. A ``scanned_through_ts`` watermark makes
    reconstruction idempotent across resume cycles. The sidecar also
    carries the controller's persisted estimates (per-engine save cost,
    typical step time, last chosen interval) so a freshly resumed process
    starts from the previous attempt's knowledge instead of its priors.

  * **MTTI estimate.** Interruption gaps are measured in *productive
    steps* (steps the dead segment executed × the typical step time), not
    raw wall clock — restart/compile downtime consumes no work and must
    not inflate the mean time to interruption. The estimator is windowed
    (last ``window`` interruptions) so a mid-run failure-rate shift is
    tracked, and censored-tail-aware: the live segment's progress since
    its last interruption counts as an open gap. Zero observed failures
    degrade to a bounded prior (``mtti_prior_s``) — the interval then
    clamps to the ceiling; saves are never disabled.

  * **Young–Daly optimum.** ``young_daly_interval_s(cost, mtti) =
    sqrt(2·cost·mtti)`` minimizes the first-order lost-time model
    ``cost/T + T/(2·mtti)`` (checkpoint overhead + expected replay); the
    property tests in tests/test_autopilot.py pin this against a
    simulated Poisson interruption process, degenerate regimes included.

  * **Actuation.** ``CheckpointAutopilot.decide`` converts the optimum to
    a step interval via the observed per-step time, clamps it to
    ``[floor, ceiling]``, holds it inside a hysteresis band (one outlier
    save cannot thrash the cadence) and bounds the per-decision rate of
    change to ×2/÷2. Multi-host, the decision is computed on host 0 and
    broadcast (the interval gates a *collective* save — divergent
    per-host intervals would deadlock the pod), the ``_resume`` verdict
    discipline. When the measured save cost makes the current engine
    indefensible (seconds-long blocking saves while the zerostall engine
    exists), the decision carries an ``engine_recommendation`` — advisory
    only: a mid-run engine switch would fragment the resume registry walk
    (``list_checkpoints(engine=)``), so the switch belongs to the next
    launch, loudly suggested.

Every decision is emitted as a ``ckpt_policy`` telemetry event carrying
its inputs (cost, MTTI, analytic optimum, chosen interval, reason), so
``python -m pyrecover_tpu_torch.telemetry.summarize`` (and the JAX
package's ``tools/summarize_telemetry.py``) renders the decision trail and
the "static policy would have lost X s" counterfactual from the port's
stream.
"""

import json
import math
import os
import statistics
import time
from collections import deque
from pathlib import Path

from pyrecover_tpu_torch import telemetry

SIDECAR_NAME = "failure_history.json"
SIDECAR_VERSION = 1

# actuation constants: one decision may move the interval at most ×2/÷2
# (a single wild estimate cannot slam the cadence), and a clamped target
# within ±25% of the current interval is held (hysteresis — timing noise
# around a stable optimum must not produce a new interval every save)
RATE_LIMIT = 2.0
HYSTERESIS = 1.25
# advisory engine escalation: blocking saves this long while a zero-stall
# engine exists make the current engine indefensible (the zerostall engine
# blocks for a small fraction of that on the same state)
ENGINE_SWITCH_COST_S = 5.0

INTERRUPT_KINDS = ("hard_kill", "crash", "preemption", "hang")


# ---- Young–Daly math --------------------------------------------------------

def young_daly_interval_s(cost_s, mtti_s):
    """The Young–Daly optimal seconds between checkpoint saves:
    ``sqrt(2 · cost · MTTI)`` — the stationary point of the first-order
    lost-time model (see ``modelled_overhead_fraction``)."""
    return math.sqrt(2.0 * max(float(cost_s), 0.0) * max(float(mtti_s), 0.0))


def modelled_overhead_fraction(interval_s, cost_s, mtti_s):
    """First-order fraction of wall time lost at save interval ``T``:
    ``cost/T`` (checkpoint overhead) + ``T/(2·MTTI)`` (expected replay —
    a Poisson interruption lands uniformly inside the interval, losing
    T/2 on average). The Young–Daly interval minimizes this; the property
    tests verify both against a simulated interruption process."""
    interval_s = float(interval_s)
    if interval_s <= 0:
        return math.inf
    return float(cost_s) / interval_s + interval_s / (2.0 * float(mtti_s))


# ---- small estimators -------------------------------------------------------

class EwmaEstimator:
    """Exponentially-weighted mean of a duration stream (the per-save
    blocking cost: a smooth typical value, robust to one slow disk).

    ``initial`` is a PRIOR, not data: it serves decisions taken before
    any observation and is REPLACED (not blended) by the first real
    sample — a 10-second default must not haunt the estimate of a
    2-millisecond save for the next twenty observations."""

    def __init__(self, initial=None, alpha=0.3):
        self.alpha = float(alpha)
        self.value = float(initial) if initial is not None else None
        self.count = 0

    def observe(self, v):
        v = float(v)
        if self.count == 0 or self.value is None:
            self.value = v
        else:
            self.value += self.alpha * (v - self.value)
        self.count += 1
        return self.value


class MedianEstimator:
    """Running median over a bounded window of observations — the typical
    per-step time. A median (not a mean/max) because the first synced
    interval of every attempt carries jit compile: one 10-second outlier
    must not convert the MTTI's step→seconds mapping into nonsense."""

    def __init__(self, initial=None, window=64):
        self._recent = deque(maxlen=int(window))
        self._initial = float(initial) if initial is not None else None

    def observe(self, v):
        self._recent.append(float(v))
        return self.value

    @property
    def value(self):
        if not self._recent:
            return self._initial
        return statistics.median(self._recent)


# ---- the failure-history sidecar -------------------------------------------

class FailureHistory:
    """The persisted failure model: one JSON sidecar per experiment dir.

    Structure::

        {"version": 1,
         "scanned_through_ts": <watermark over the telemetry stream>,
         "interruptions": [
            {"ts": ..., "kind": "hard_kill|crash|preemption|hang",
             "step": <last completed step>, "steps_run": <segment progress>,
             "source": "telemetry"},
            ...],
         "estimates": {"save_cost_s": {"vanilla": ...}, "step_iter_s": ...,
                       "interval_steps": ...}}

    Writes are atomic (tmp + fsync + rename) and host-0-only at the call
    sites — the sidecar must survive a SIGKILL that lands mid-decision.
    """

    def __init__(self, exp_dir):
        self.path = Path(exp_dir) / SIDECAR_NAME
        self.interruptions = []
        self.scanned_through_ts = 0.0
        self.estimates = {}

    @classmethod
    def load(cls, exp_dir):
        """Read the sidecar (tolerant: a missing/torn file is an empty
        history — the model degrades to the prior, never crashes)."""
        h = cls(exp_dir)
        try:
            doc = json.loads(h.path.read_text())
        except (OSError, ValueError):
            return h
        if not isinstance(doc, dict):
            return h
        raw = doc.get("interruptions")
        if isinstance(raw, list):
            h.interruptions = [
                r for r in raw
                if isinstance(r, dict) and r.get("kind") in INTERRUPT_KINDS
            ]
        try:
            h.scanned_through_ts = float(doc.get("scanned_through_ts") or 0.0)
        except (TypeError, ValueError):
            h.scanned_through_ts = 0.0
        if isinstance(doc.get("estimates"), dict):
            h.estimates = doc["estimates"]
        return h

    def record(self, kind, *, ts, step=None, steps_run=None,
               source="telemetry"):
        if kind not in INTERRUPT_KINDS:
            raise ValueError(f"unknown interruption kind {kind!r}")
        self.interruptions.append({
            "ts": float(ts),
            "kind": kind,
            "step": int(step) if step is not None else None,
            "steps_run": int(steps_run) if steps_run is not None else None,
            "source": source,
        })
        return self

    def save(self):
        """Atomic publish: the sidecar is the controller's crash-surviving
        state — a torn write would poison every later MTTI estimate."""
        doc = {
            "version": SIDECAR_VERSION,
            "scanned_through_ts": self.scanned_through_ts,
            "interruptions": self.interruptions,
            "estimates": self.estimates,
        }
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_name(self.path.name + ".tmp")
        with open(tmp, "w") as f:
            f.write(json.dumps(doc, indent=1))
            f.flush()
            os.fsync(f.fileno())
        # faultcheck: disable-next=unseamed-durable-effect -- the sidecar
        # is controller bookkeeping outside the checkpoint data plane: a
        # lost write costs one interruption record, and the random_sigkill
        # autopilot drill already kills the controller around this publish
        os.replace(tmp, self.path)
        return self.path

    # -- the failure model ----------------------------------------------------
    def mtti_steps(self, *, live_steps=0, window=8):
        """Windowed mean steps between interruptions, censored-tail-aware:
        the live segment's ``live_steps`` since its last interruption is
        an open gap and counts in the numerator. Returns ``(steps, n)``
        with ``n`` the interruptions in the window (0 = no data: caller
        falls back to the prior)."""
        recent = [
            r for r in self.interruptions
            if r.get("steps_run") is not None
        ][-int(window):]
        if not recent:
            return None, 0
        total = sum(max(int(r["steps_run"]), 0) for r in recent)
        return (total + max(int(live_steps), 0)) / len(recent), len(recent)

    def counts_by_kind(self):
        out = {}
        for r in self.interruptions:
            out[r["kind"]] = out.get(r["kind"], 0) + 1
        return out


def _iter_segments(events):
    """Split a telemetry stream into ``run_start``-delimited segments
    (the shape of the JAX package's ``tools/summarize_telemetry.segments``)."""
    segs, cur = [], None
    for e in events:
        if e.get("event") == "run_start":
            if cur is not None:
                segs.append(cur)
            cur = [e]
        elif cur is not None:
            cur.append(e)
    if cur is not None:
        segs.append(cur)
    return segs


def _segment_profile(seg):
    """(last_ts, kind-or-None, last_step, steps_run, median_iter_s) for one
    prior segment — the doctor-style death classification condensed to
    what the failure model needs."""
    last_ts = max((float(e.get("ts") or 0.0) for e in seg), default=0.0)
    summary = next(
        (e for e in reversed(seg) if e.get("event") == "run_summary"), None
    )
    steps = [
        int(e["step"]) for e in seg
        if e.get("event") in ("train_sync", "step_time", "ckpt_saved")
        and isinstance(e.get("step"), int)
    ]
    last_step = max(steps, default=None)
    steps_run = (max(steps) - min(steps) + 1) if steps else 0
    iters = [
        float(e["iter_s"]) for e in seg
        if e.get("event") == "train_sync"
        and isinstance(e.get("iter_s"), (int, float))
    ]
    iter_s = statistics.median(iters) if iters else None

    preempted = any(
        e.get("event") in ("preempt_stop", "preempt_signal_escalation")
        for e in seg
    )
    if summary is None:
        kind = "preemption" if preempted else "hard_kill"
    elif summary.get("status") == "error":
        kind = "crash"
    elif summary.get("status") == "stopped_early" or preempted:
        kind = "preemption"
    else:
        kind = None  # finished clean: not an interruption
    return last_ts, kind, last_step, steps_run, iter_s


def reconstruct_history(events, history, *, source="telemetry"):
    """Fold the telemetry stream's PRIOR run segments into the sidecar.

    The final segment (the newest ``run_start`` — the live attempt that is
    calling this) is skipped; segments at or below the sidecar's
    ``scanned_through_ts`` watermark were folded by an earlier resume and
    are skipped too, so each death is counted exactly once no matter how
    many times the chain resumes. ``hang_detected`` windows inside a
    scanned segment are recorded as ``hang`` interruptions (progress
    stalled even though the process survived). Returns the number of new
    interruption records."""
    segs = _iter_segments(events)
    if segs:
        segs = segs[:-1]  # the caller's own live segment
    added = 0
    watermark = history.scanned_through_ts
    for seg in segs:
        last_ts, kind, last_step, steps_run, _iter = _segment_profile(seg)
        if last_ts <= watermark:
            continue
        for e in seg:
            if e.get("event") == "hang_detected":
                # the process survived but progress stalled: an incident
                # for the counts, NOT a gap sample (steps_run=None keeps
                # it out of the MTTI estimate — the segment's death, if
                # any, carries the gap exactly once)
                history.record(
                    "hang", ts=float(e.get("ts") or last_ts),
                    step=last_step, steps_run=None, source=source,
                )
                added += 1
        if kind is not None:
            history.record(
                kind, ts=last_ts, step=last_step, steps_run=steps_run,
                source=source,
            )
            added += 1
        history.scanned_through_ts = max(history.scanned_through_ts, last_ts)
    return added


# ---- the controller ---------------------------------------------------------

class CheckpointAutopilot:
    """Online checkpoint-cadence controller (``--checkpoint-frequency
    auto``). One instance per training process; every method is host-side
    and called from the train loop's existing sync points only."""

    def __init__(self, exp_dir, *, engine, static_interval, floor=1,
                 ceiling=500, mtti_prior_s=3600.0, window=8,
                 default_cost_s=10.0, default_iter_s=1.0):
        self.exp_dir = Path(exp_dir)
        self.engine = str(engine)
        self.floor = max(1, int(floor))
        self.ceiling = max(self.floor, int(ceiling))
        self.mtti_prior_s = float(mtti_prior_s)
        self.window = max(1, int(window))
        self.static_interval = int(static_interval)
        self.history = FailureHistory.load(exp_dir)
        est = self.history.estimates or {}
        saved_cost = (est.get("save_cost_s") or {}).get(self.engine)
        self._cost = EwmaEstimator(
            initial=saved_cost if saved_cost is not None else default_cost_s
        )
        if saved_cost is not None:
            # a previous attempt's measurement, not a config prior: the
            # next observation blends instead of replacing it
            self._cost.count = 1
        self._iter = MedianEstimator(
            initial=est.get("step_iter_s") or default_iter_s
        )
        prev = est.get("interval_steps")
        if not isinstance(prev, int) or prev < 1:
            prev = static_interval if static_interval > 0 else self.ceiling
        self.interval_steps = min(max(int(prev), self.floor), self.ceiling)
        self._start_step = 0
        self._last_step = 0
        self._engine_warned = False

    # -- observations ---------------------------------------------------------
    def observe_iter(self, iter_s, n=1, step=None):
        """Feed the synced interval-average step time (the same number
        PreemptionWatcher learns from)."""
        self._iter.observe(iter_s)
        if step is not None:
            self._last_step = max(self._last_step, int(step))

    def observe_save(self, blocking_s):
        """Feed one save's measured blocking cost (the ckpt_blocking_s
        stream — vanilla and zerostall see ~15× different values here)."""
        self._cost.observe(blocking_s)

    def record_interruption(self, kind, *, step=None, now=None):
        """Record a live interruption (host 0 persists it immediately —
        the process may be about to die)."""
        self.history.record(
            kind, ts=now if now is not None else time.time(), step=step,
            steps_run=max((step or 0) - self._start_step, 0), source="live",
        )
        self._persist()

    # -- the failure model ----------------------------------------------------
    def mtti_s(self):
        """Windowed MTTI in seconds: gap steps × typical step time, the
        bounded prior when no interruption has ever been observed.
        Returns ``(mtti_s, n_window)``."""
        iter_s = max(float(self._iter.value or 0.0), 1e-9)
        live = max(self._last_step - self._start_step, 0)
        steps, n = self.history.mtti_steps(
            live_steps=live, window=self.window
        )
        if n == 0:
            return self.mtti_prior_s, 0
        return max(steps * iter_s, 1e-9), n

    # -- bootstrap + decisions ------------------------------------------------
    def bootstrap(self, telemetry_path, *, step=0):
        """Called once after ``_resume``: fold the prior attempts' deaths
        into the sidecar (host 0), then take the initial decision. Every
        host calls this at the same point; the decision is broadcast."""
        from pyrecover_tpu_torch.utils.logging import process_index

        self._start_step = self._last_step = int(step)
        if process_index() == 0 and telemetry_path is not None:
            events = telemetry.read_events(telemetry_path)
            if events:
                added = reconstruct_history(events, self.history)
                if added:
                    self._persist()
        return self.decide(step, source="bootstrap")

    def decide(self, step, source="post_save"):
        """One policy decision: recompute the Young–Daly optimum from the
        live estimates, clamp/hold/rate-limit it, broadcast the chosen
        interval (it gates a collective save — every host must agree), and
        emit the ``ckpt_policy`` decision record. Returns the interval in
        steps. Saves are NEVER disabled: the result is always in
        ``[floor, ceiling]``."""
        from pyrecover_tpu_torch.parallel.mesh import broadcast_host0_scalar
        from pyrecover_tpu_torch.utils.logging import log_host0, process_index

        self._last_step = max(self._last_step, int(step))
        chosen = self.interval_steps
        record = None
        if process_index() == 0:
            cost_s = max(float(self._cost.value or 0.0), 0.0)
            iter_s = max(float(self._iter.value or 0.0), 1e-9)
            mtti_s, n_window = self.mtti_s()
            opt_s = young_daly_interval_s(cost_s, mtti_s)
            opt_steps = opt_s / iter_s
            target = min(max(int(round(opt_steps)), self.floor), self.ceiling)
            prev = self.interval_steps
            if n_window == 0:
                reason = "prior"
            elif target == self.floor and opt_steps <= self.floor:
                reason = "floor"
            elif target == self.ceiling and opt_steps >= self.ceiling:
                reason = "ceiling"
            else:
                reason = "adapted"
            chosen = target
            # hysteresis dampens INTERIOR targets only: a bound-clamped
            # target (prior/floor/ceiling) is the decision itself, and
            # holding one rate-limit step short of it forever would leave
            # the cadence parked at an arbitrary intermediate value
            if prev >= 1 and target != prev and reason == "adapted" and (
                max(target, prev) / min(target, prev) <= HYSTERESIS
            ):
                chosen, reason = prev, "hysteresis-hold"
            elif target != prev:
                lo = max(self.floor, int(math.ceil(prev / RATE_LIMIT)))
                hi = min(self.ceiling, int(prev * RATE_LIMIT))
                limited = min(max(target, lo), hi)
                if limited != target:
                    reason = "rate-limited"
                chosen = limited
            recommendation = None
            if (
                self.engine != "zerostall"
                and self._cost.count > 0
                and cost_s >= ENGINE_SWITCH_COST_S
            ):
                recommendation = "zerostall"
                if not self._engine_warned:
                    self._engine_warned = True
                    log_host0(
                        "checkpoint autopilot: the %s engine blocks %.1f s "
                        "per save; --checkpoint-engine zerostall would "
                        "overlap almost all of it (recommendation only — "
                        "switch at the next launch)", self.engine, cost_s,
                        level=30,  # WARNING
                    )
            record = {
                "step": int(step),
                "source": source,
                "engine": self.engine,
                "interval_steps": int(chosen),
                "prev_interval_steps": int(prev),
                "optimum_steps": round(opt_steps, 4),
                "optimum_s": round(opt_s, 4),
                "cost_s": round(cost_s, 6),
                "mtti_s": round(mtti_s, 4),
                "step_iter_s": round(iter_s, 6),
                "failures_observed": len(self.history.interruptions),
                "failures_window": n_window,
                "reason": reason,
                "floor": self.floor,
                "ceiling": self.ceiling,
                "static_interval": self.static_interval,
                "engine_recommendation": recommendation,
            }
        # the interval gates a collective (the save): host 0 decides, every
        # host adopts the broadcast value — the _resume verdict discipline
        chosen = int(broadcast_host0_scalar(chosen))
        self.interval_steps = chosen
        # live plane: the policy state the dashboard renders (host-side
        # dict writes; host 0 additionally carries the model's inputs)
        telemetry.metrics.gauge("autopilot_interval_steps").set(chosen)
        if process_index() == 0 and record is not None:
            telemetry.metrics.gauge("autopilot_mtti_s").set(
                record["mtti_s"]
            )
            telemetry.metrics.gauge("autopilot_cost_s").set(
                record["cost_s"]
            )
            telemetry.metrics.gauge("autopilot_failures_observed").set(
                record["failures_observed"]
            )
            telemetry.emit("ckpt_policy", **record)
            self.history.estimates = {
                "save_cost_s": {
                    **(self.history.estimates.get("save_cost_s") or {}),
                    self.engine: round(float(self._cost.value or 0.0), 6),
                },
                "step_iter_s": round(float(self._iter.value or 0.0), 6),
                "interval_steps": int(chosen),
                "updated_ts": time.time(),
            }
            self._persist()
        return chosen

    def _persist(self):
        try:
            self.history.save()
        except OSError as e:
            # the sidecar is advisory state: a full disk must degrade the
            # policy (stale estimates next resume), never kill the run
            telemetry.emit(
                "ckpt_policy_sidecar_error", error=f"{type(e).__name__}: {e}"
            )
