"""Replica supervisor: spawn, watch, restart with capped backoff, quarantine
crash-loopers (the JAX package's ``serving/fleet/supervisor.py``: the same
states, delays and events).

One :class:`ReplicaSupervisor` owns N replica *slots*. Each slot walks a
small state machine driven by a single monitor thread:

    SPAWNING --ready--> READY --death--> DEAD --> BACKOFF --> SPAWNING
        |                                  |
        +--death before ready (strike)-----+--strikes >= N--> QUARANTINED

* **Restart discipline** is ``retry.py``'s: capped exponential backoff
  (``min(base * 2^restarts, max)``), implemented as deadline checks on the
  monitor thread, never a sleep under the lock.
* **Crash-loop quarantine**: a death *before the slot ever became READY
  this incarnation* is a strike; READY resets strikes. After
  ``quarantine_after`` consecutive strikes the slot is parked in
  QUARANTINED and never respawned: a crash-looper burns bounded capacity.
* **Process mechanics are injected**: ``spawn(slot, incarnation)`` returns
  a Popen-like object (``poll()``, ``terminate()``, ``kill()``,
  ``returncode``) and ``ready_check(slot, incarnation, proc)`` returns the
  readiness info dict or None, so the state machine runs over fake
  processes in tests and over real ones in the drills.

Events: ``replica_spawned`` per (re)spawn, ``replica_dead`` per observed
death, ``replica_quarantined`` when a slot is parked. Callbacks
``on_ready(slot, info)`` / ``on_death(slot, rc, was_ready)`` run on the
monitor thread, outside the lock.
"""

import threading
import time

from pyrecover_tpu_torch import telemetry

SPAWNING = "spawning"
READY = "ready"
BACKOFF = "backoff"
QUARANTINED = "quarantined"
STOPPED = "stopped"


class ReplicaSupervisor:
    """Supervise N replica slots; see the module docstring."""

    def __init__(self, n_replicas, spawn, ready_check, *, on_ready=None, on_death=None,
                 backoff_base_s=0.05, backoff_max_s=2.0, quarantine_after=3,
                 poll_interval_s=0.02):
        self._spawn_fn = spawn
        self._ready_check = ready_check
        self._on_ready = on_ready
        self._on_death = on_death
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.quarantine_after = int(quarantine_after)
        self.poll_interval_s = float(poll_interval_s)
        self._lock = threading.Lock()
        # every per-slot record below is guarded by _lock
        self._slots = {
            slot: {"state": STOPPED, "proc": None, "incarnation": -1, "restarts": 0,
                   "strikes": 0, "spawns": 0, "resume_at": 0.0, "info": None, "rc": None}
            for slot in range(int(n_replicas))
        }
        self._stop = threading.Event()
        self._thread = None

    # ---- public view ------------------------------------------------------

    def state(self, slot):
        with self._lock:
            return self._slots[slot]["state"]

    def states(self):
        with self._lock:
            return {s: r["state"] for s, r in self._slots.items()}

    def info(self, slot):
        with self._lock:
            rec = self._slots[slot]
            return dict(rec["info"]) if rec["info"] else None

    def spawns(self, slot):
        with self._lock:
            return self._slots[slot]["spawns"]

    def last_rc(self, slot):
        with self._lock:
            return self._slots[slot]["rc"]

    # ---- lifecycle --------------------------------------------------------

    def start(self):
        """Spawn every slot and start the monitor thread."""
        for slot in self._slots:
            self._spawn_slot(slot, backoff_s=0.0)
        self._thread = threading.Thread(target=self._monitor, name="fleet-supervisor",
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout=30.0):
        """Stop the monitor (bounded join) and terminate every live replica
        process (terminate, bounded wait, then kill)."""
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                raise TimeoutError(f"fleet supervisor monitor did not exit within {timeout}s")
            self._thread = None
        with self._lock:
            procs = [rec["proc"] for rec in self._slots.values() if rec["proc"] is not None]
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + timeout
        for proc in procs:
            while proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.02)
            if proc.poll() is None:
                proc.kill()

    # ---- monitor ----------------------------------------------------------

    def _monitor(self):
        while not self._stop.is_set():
            for slot in self._slots:
                if self._stop.is_set():
                    break
                self._tick_slot(slot)
            self._stop.wait(self.poll_interval_s)

    def _tick_slot(self, slot):
        with self._lock:
            rec = self._slots[slot]
            state = rec["state"]
            proc = rec["proc"]
            inc = rec["incarnation"]
            resume_at = rec["resume_at"]
        if state == SPAWNING:
            info = self._ready_check(slot, inc, proc)
            if info is not None:
                with self._lock:
                    rec["state"] = READY
                    rec["info"] = dict(info)
                    rec["strikes"] = 0
                if self._on_ready is not None:
                    self._on_ready(slot, dict(info))
                return
            rc = proc.poll()
            if rc is not None:
                self._handle_death(slot, rc, was_ready=False)
        elif state == READY:
            rc = proc.poll()
            if rc is not None:
                self._handle_death(slot, rc, was_ready=True)
        elif state == BACKOFF:
            if time.monotonic() >= resume_at:
                with self._lock:
                    backoff_s = min(self.backoff_base_s * (2 ** max(rec["restarts"] - 1, 0)),
                                    self.backoff_max_s)
                self._spawn_slot(slot, backoff_s=backoff_s)

    def _handle_death(self, slot, rc, *, was_ready):
        with self._lock:
            rec = self._slots[slot]
            rec["rc"] = rc
            rec["info"] = None
            inc = rec["incarnation"]
            if not was_ready:
                rec["strikes"] += 1
            strikes = rec["strikes"]
        telemetry.emit("replica_dead", replica=slot, rc=rc, incarnation=inc,
                       was_ready=bool(was_ready))
        if self._on_death is not None:
            self._on_death(slot, rc, was_ready)
        if strikes >= self.quarantine_after:
            with self._lock:
                rec["state"] = QUARANTINED
            telemetry.emit("replica_quarantined", replica=slot, strikes=strikes, rc=rc)
            return
        with self._lock:
            delay = min(self.backoff_base_s * (2 ** rec["restarts"]), self.backoff_max_s)
            rec["restarts"] += 1
            rec["state"] = BACKOFF
            rec["resume_at"] = time.monotonic() + delay

    def _spawn_slot(self, slot, *, backoff_s):
        with self._lock:
            rec = self._slots[slot]
            inc = rec["incarnation"] + 1
        proc = self._spawn_fn(slot, inc)
        with self._lock:
            rec["proc"] = proc
            rec["incarnation"] = inc
            rec["state"] = SPAWNING
            rec["rc"] = None
            rec["spawns"] += 1
        telemetry.emit("replica_spawned", replica=slot, incarnation=inc,
                       pid=getattr(proc, "pid", -1), backoff_s=round(backoff_s, 4))
