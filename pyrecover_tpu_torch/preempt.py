"""Time-aware checkpointing and preemption handling (the JAX package's
``preempt.py``).

Watch the job deadline, learn the real iteration and checkpoint durations
online, and stop for one final checkpoint before the scheduler kills the
job. Deadline sources, in order: an explicit ``--job-end-time``, then the
``JOB_END_TIME`` / ``SLURM_JOB_END_TIME`` environment variables. A
preemption notice means "save now": SIGTERM or SIGUSR1, or the file named by
``$PYRECOVER_PREEMPT_FILE`` appearing. The safety buffer is
``5·iter + 2·ckpt``, with each duration a decaying high-quantile estimate;
a deadline check stops when less than ``check_interval·iter + ckpt +
buffer`` seconds remain. Host 0 decides and broadcasts the decision
(``parallel.mesh.broadcast_host0_scalar``, an identity in one process), so
every rank of a data-parallel group stops on the same step; a notice that
reaches a rank between check steps is coordinated at the next one. The
markers are written by host 0 alone. The JAX package's Cloud TPU
maintenance-event watcher (``maintenance.py``) is left out by design: it
polls the GCE metadata server, which GPU hosts do not have.

``write_requeue_marker`` drops ``REQUEUE`` (stopped early: relaunch with
``--resume-from-checkpoint latest``) or ``DONE`` in the experiment
directory; both packages read each other's markers.

Telemetry, as in the JAX package: ``preempt_estimate`` when a learned
duration grows, ``preempt_check`` at each deadline check, ``preempt_notice``
and ``preempt_stop`` at a stop, and ``preempt_signal_escalation`` (with a
flight-recorder bundle) when a second signal lands mid-save.
"""

import json
import logging
import os
import signal
import time
from collections import deque
from pathlib import Path

from pyrecover_tpu_torch import telemetry

log = logging.getLogger("pyrecover_tpu_torch")

PREEMPT_NOTICE_ENV = "PYRECOVER_PREEMPT_FILE"
REQUEUE_MARKER = "REQUEUE"
DONE_MARKER = "DONE"
ESCALATION_EXIT_CODE = 75  # EX_TEMPFAIL: retryable, the launcher requeues


class DecayingMaxEstimator:
    """Decaying high-quantile estimate of a duration stream, with the true
    max over a short recent window as a floor. ``peak = max(obs,
    peak·decay)`` per observation lets a one-off outlier (the first step's
    warm-up) relax, while anything seen in the last ``window`` observations
    stays covered. Before any observation the estimate is ``initial``."""

    def __init__(self, initial, decay=0.9, window=8):
        self._initial = float(initial)
        self._decay = float(decay)
        self._peak = float(initial)
        self._recent = deque(maxlen=int(window))

    def observe(self, seconds):
        seconds = float(seconds)
        self._peak = max(seconds, self._peak * self._decay)
        self._recent.append(seconds)
        return self.value

    @property
    def value(self):
        if not self._recent:
            return self._initial
        return max(self._peak, max(self._recent))


def get_job_end_time(explicit=None):
    """Deadline in unix seconds, or None."""
    if explicit is not None:
        return float(explicit)
    for var in ("JOB_END_TIME", "SLURM_JOB_END_TIME"):
        val = os.environ.get(var)
        if val:
            try:
                return float(val)
            except ValueError:
                pass
    return None


class PreemptionWatcher:
    """Deadline and notice watcher with online duration learning."""

    def __init__(self, *, enabled, default_iter_time=1.0, default_ckpt_time=10.0,
                 job_end_time=None, check_interval=1):
        self.enabled = enabled
        self.job_end_time = get_job_end_time(job_end_time)
        self._iter_estimate = DecayingMaxEstimator(default_iter_time)
        self._ckpt_estimate = DecayingMaxEstimator(default_ckpt_time)
        # the deadline check runs every k-th step; the threshold absorbs the
        # up-to-(k-1)-step delay
        self.check_interval = max(1, int(check_interval))
        notice = os.environ.get(PREEMPT_NOTICE_ENV)
        self.notice_file = Path(notice) if notice else None
        self._signal_seen = False
        self.signal_count = 0
        self._previous_handlers = None
        # (exp_dir, step) while a save is in flight: a second signal then
        # escalates at once
        self._escalation = None
        self._exit_fn = os._exit  # swappable for tests
        self._notice_logged = False
        if self.enabled:
            if self.job_end_time is not None:
                log.info("Time-aware checkpointing armed: %.0f s of walltime remain",
                         self.job_end_time - time.time())
            else:
                log.info("Time-aware checkpointing enabled with no deadline source; "
                         "watching preemption notices only")

    def observe_iter(self, seconds):
        prev = self._iter_estimate.value
        val = self._iter_estimate.observe(seconds)
        if val > prev and self.enabled:
            # only on increases, so the stream stays bounded
            telemetry.emit("preempt_estimate", kind="iter", seconds=round(val, 4),
                           safety_buffer_s=round(self.safety_buffer, 4))

    def observe_ckpt(self, seconds):
        prev = self._ckpt_estimate.value
        val = self._ckpt_estimate.observe(seconds)
        if val > prev and self.enabled:
            telemetry.emit("preempt_estimate", kind="ckpt", seconds=round(val, 4),
                           safety_buffer_s=round(self.safety_buffer, 4))

    @property
    def max_iter_time(self):
        return self._iter_estimate.value

    @property
    def max_ckpt_time(self):
        return self._ckpt_estimate.value

    @property
    def safety_buffer(self):
        return 5.0 * self.max_iter_time + 2.0 * self.max_ckpt_time

    # -- signals ---------------------------------------------------------------
    def install_signal_handler(self):
        """SIGTERM/SIGUSR1 count as a preemption notice. The first signal asks
        for the graceful final checkpoint; a second one while a save is armed
        (`arm_escalation`) writes the requeue marker and exits at once.
        Idempotent; `restore_signal_handlers` puts the previous ones back.
        A disabled watcher installs nothing, so SIGTERM keeps its default
        action (the JAX package's watcher catches it even when disabled, and
        the signal then stops nothing)."""
        if self._previous_handlers is not None or not self.enabled:
            return self

        # concur: disable-next=signal-unsafe-call -- the emit/dump path runs
        # only on the SECOND signal while a save is armed, and it is
        # terminal: os._exit(75) follows at once, so a deadlocked bus lock
        # costs nothing the scheduler's SIGKILL was not about to take; the
        # first signal only flips flags
        def handler(signum, frame):
            self.signal_count += 1
            self._signal_seen = True
            if self.signal_count >= 2 and self._escalation is not None:
                self._escalate(signum)

        self._previous_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGUSR1):
            self._previous_handlers[sig] = signal.signal(sig, handler)
        return self

    def restore_signal_handlers(self):
        for sig, previous in (self._previous_handlers or {}).items():
            signal.signal(sig, previous)
        self._previous_handlers = None

    def arm_escalation(self, exp_dir, step):
        """Mark a save in flight: a repeat signal now escalates. ``step`` is
        the last completed step, which the requeue marker publishes."""
        self._escalation = (Path(exp_dir), int(step))
        return self

    def disarm_escalation(self):
        self._escalation = None

    def _escalate(self, signum):  # obscheck: once
        """Second signal mid-save: publish the requeue marker and exit now,
        without interpreter teardown (the process is being killed either
        way)."""
        exp_dir, step = self._escalation
        telemetry.emit("preempt_signal_escalation", signal=int(signum),
                       count=self.signal_count, step=step)
        log.warning("second signal (%d) during a checkpoint save; writing the requeue "
                    "marker and exiting now", signum)
        try:
            write_requeue_marker(exp_dir, done=False, step=step)
            # os._exit skips every other teardown: this bundle is the
            # postmortem's one chance to show what was mid-save
            telemetry.flight.dump("preempt_escalation", signal=int(signum),
                                  signal_count=self.signal_count, escalation_step=step)
        finally:
            self._exit_fn(ESCALATION_EXIT_CODE)

    def _notice_present(self):
        if self._signal_seen:
            return True
        return self.notice_file is not None and self.notice_file.exists()

    # -- the periodic decision -------------------------------------------------
    def is_check_step(self, step):
        """True on the steps where ``should_stop`` checks the deadline."""
        return self.enabled and step % self.check_interval == 0

    def should_stop(self, step=None):
        """Called once per step with the global step. A signal or notice
        file stops on the step it lands in one process; across processes
        it waits for the next check step, where every rank issues the
        decision's broadcast. The deadline is checked only on check steps
        (every step when ``step`` is None). Host 0's decision is every
        rank's: True on all of them when it is time to take the final
        checkpoint and exit."""
        from pyrecover_tpu_torch.parallel.mesh import broadcast_host0_scalar, world_size

        if not self.enabled:
            return False
        if step is not None and not self.is_check_step(step):
            # distcheck: disable-next=rank-gated-collective -- with more
            # than one process every arm of this branch returns before the
            # broadcast (the world-size guard under it); only one process
            # falls through, where the broadcast is an identity
            if not self._notice_present():
                return False
            if world_size() > 1:
                if not self._notice_logged:
                    self._notice_logged = True
                    log.info("Preemption notice observed between check steps; coordinating "
                             "the stop at the next one (<= %d steps away)",
                             self.check_interval - 1)
                    telemetry.emit("preempt_notice", step=step, coordinated=False,
                                   max_delay_steps=self.check_interval - 1)
                return False
        reason = None
        if self._notice_present():
            reason = "preemption notice received"
            telemetry.emit("preempt_notice", step=step, coordinated=True)
        elif self.job_end_time is not None:
            time_left = self.job_end_time - time.time()
            threshold = (self.check_interval * self.max_iter_time + self.max_ckpt_time
                         + self.safety_buffer)
            telemetry.emit(
                "preempt_check", step=step, time_left_s=round(time_left, 2),
                threshold_s=round(threshold, 2),
                iter_estimate_s=round(self.max_iter_time, 4),
                ckpt_estimate_s=round(self.max_ckpt_time, 4),
            )
            if time_left < threshold:
                reason = (f"{time_left:.0f} s left < threshold {threshold:.0f} s "
                          f"(iter {self.max_iter_time:.2f} s, ckpt {self.max_ckpt_time:.2f} s)")
        decision = bool(broadcast_host0_scalar(reason is not None))
        if decision:
            reason = reason or "host 0 decided"
            log.info("Stopping for final checkpoint: %s", reason)
            # the final-save trigger
            telemetry.emit("preempt_stop", step=step, reason=reason)
        return decision


def write_requeue_marker(exp_dir, *, done=False, step=None):
    """Publish the restart decision: REQUEUE (stopped early at a deadline or
    notice; relaunch with ``--resume-from-checkpoint latest``) or DONE
    (training finished). ``step``, the last completed step, rides along.
    The two markers exclude each other. Host 0 writes; other ranks return."""
    from pyrecover_tpu_torch.utils.logging import process_index

    if process_index() != 0:
        return
    exp_dir = Path(exp_dir)
    exp_dir.mkdir(parents=True, exist_ok=True)
    marker = exp_dir / (DONE_MARKER if done else REQUEUE_MARKER)
    other = exp_dir / (REQUEUE_MARKER if done else DONE_MARKER)
    other.unlink(missing_ok=True)
    payload = {"ts": time.time(), "done": bool(done)}
    if step is not None:
        payload["step"] = int(step)
    marker.write_text(json.dumps(payload))


def read_requeue_marker(exp_dir):
    """Parse whichever marker (REQUEUE or DONE) exists: a dict
    (``{"ts", "done", "step"?}``) or None. Tolerates the legacy bare-float
    format and torn content: markers are advisory."""
    exp_dir = Path(exp_dir)
    for name, done in ((REQUEUE_MARKER, False), (DONE_MARKER, True)):
        p = exp_dir / name
        if not p.exists():
            continue
        try:
            text = p.read_text().strip()
        except OSError:
            return None
        try:
            payload = json.loads(text)
            if isinstance(payload, dict):
                payload.setdefault("done", done)
                return payload
        except ValueError:
            pass
        try:
            return {"ts": float(text), "done": done}  # legacy format
        except ValueError:
            return {"ts": None, "done": done}
    return None
