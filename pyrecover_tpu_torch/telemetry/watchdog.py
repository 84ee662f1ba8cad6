"""Run-health watchdog: heartbeats in, hang forensics out — never a kill (the
JAX package's ``telemetry/watchdog.py``).

A wedged run is the darkest failure mode: no exception, no exit code, no
event — just a process burning its allocation doing nothing (a hung data
source, a stuck collective, a kernel that never returns). This watchdog
turns that silence into artifacts. Producers on the progress path call
``beat(source)`` (a dict store — nanoseconds):

    train_loop    train.py, once per completed step
    loader        data loader workers, once per materialized batch
    ckpt_writer   the checkpoint writer, per snapshotted part and written
                  chunk

A monitor thread checks the NEWEST heartbeat across all sources: when no
source has made progress for ``window_s``, it emits ``hang_detected``
(per-source silence ages included), writes a flight-recorder bundle —
all-thread stacks show exactly where every thread is wedged, open spans
name the phase — and re-arms only after progress resumes, so one stall
produces one bundle, not one per poll. It NEVER kills the run: a hang
that later resolves (a slow NFS stall) costs a false-alarm bundle, while
a watchdog-kill would have cost the run.

The global-silence rule (rather than per-source deadlines) is what makes
this safe to leave on: the progress sources are serially coupled — a
wedged loader starves the train loop, a wedged writer blocks the save
call — so a genuine hang silences everything, while a legitimately idle
source (no checkpoint in flight) never trips anything alone.

``train.py`` starts the monitor only after the first completed step of the
run: the first step carries the kernels' ``nvcc`` build and their first
launches, an arbitrarily long legitimate silence. Init-time deadlocks are
the accelerator probe's job (:mod:`pyrecover_tpu_torch.telemetry.detectors`),
not this watchdog's.

A hung kernel has no heartbeat of its own: the host enqueues work and runs
on until its next sync (the ``.item()`` of the step's loss at a logging
point), which then never returns. The silence is the train loop's, and the
bundle's stacks show the main thread inside that sync.
"""

import threading
import time

from pyrecover_tpu_torch.telemetry import bus, flight

_active = None  # the installed Watchdog, or None (the faults.py pattern)


def beat(source):
    """Record progress for ``source`` on the active watchdog; no-op when
    none is installed (a global read + a dict store — hot-path safe)."""
    wd = _active
    if wd is not None:
        wd._beats[source] = time.monotonic()


class Watchdog:
    """No-progress monitor. ``start()`` launches the daemon thread and
    registers the instance for module-level ``beat`` calls; ``stop()``
    retires both."""

    def __init__(self, window_s, *, interval_s=None, dump_bundle=True):
      
        self.window_s = float(window_s)
        # poll a few times per window so detection latency stays a
        # fraction of the window, but never spin faster than 2 Hz
        self.interval_s = (
            float(interval_s) if interval_s is not None
            else max(self.window_s / 4.0, 0.5)
        )
        self.dump_bundle = dump_bundle
        self._beats = {}  # source name -> monotonic stamp (GIL-atomic)
        self._stop_evt = threading.Event()
        self._thread = None
        self._armed = True
        self.hang_count = 0
        self.started = False

    def beat(self, source):
        self._beats[source] = time.monotonic()

    def start(self):
        global _active
        if self._thread is not None:
            return self
        self.started = True
        # starting counts as progress: the window measures from now, not
        # from a beat that may predate a long legitimate setup phase
        self._beats.setdefault("watchdog_start", time.monotonic())
        _active = self
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, name="pyrecover-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        global _active
        if _active is self:
            _active = None
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- monitor ------------------------------------------------------------
    def _run(self):
        while not self._stop_evt.wait(self.interval_s):
            self._check(time.monotonic())

    def _check(self, now):
        beats = dict(self._beats)
        if not beats:
            return
        newest = max(beats.values())
        silent_s = now - newest
        if silent_s < self.window_s:
            self._armed = True  # progress resumed; a new stall re-fires
            return
        if not self._armed:
            return  # this stall already produced its bundle
        self._armed = False
        self.hang_count += 1
        ages = {
            name: round(now - stamp, 3) for name, stamp in beats.items()
            if name != "watchdog_start"
        } or {name: round(now - stamp, 3) for name, stamp in beats.items()}
        bus.emit(
            "hang_detected",
            silent_s=round(silent_s, 3),
            window_s=self.window_s,
            sources=ages,
            hang_count=self.hang_count,
        )
        if self.dump_bundle:
            # the bundle carries all-thread stacks + open spans: WHERE the
            # run is wedged, not just THAT it is. The run keeps running —
            # if it recovers, the bundle documents a stall; if it never
            # does, the bundle is the whole postmortem.
            flight.dump(
                "hang_detected", silent_s=round(silent_s, 3),
                window_s=self.window_s, sources=ages,
            )
