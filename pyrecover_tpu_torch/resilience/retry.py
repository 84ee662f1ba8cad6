"""Transient-I/O retry: capped exponential backoff + deterministic jitter
(the JAX package's ``resilience/retry.py``). Each retry is a
``ckpt_io_retry`` event (and a log warning); a call that succeeded after
retrying leaves one ``io_retry`` span and an ``io_retry_latency_s`` sample.

An NFS or fuse blip mid-save (EIO/EAGAIN on write, fsync or the atomic
publish rename) costs a retry, not the checkpoint. Permanent errors
(ENOSPC, EACCES, ENOENT, ...) are not retried: backoff cannot make disk
space, and masking them would only delay the failure past the point where
the operator can still act inside the preemption grace window.
"""

import errno
import logging
import os
import random
import time

from pyrecover_tpu_torch import telemetry

log = logging.getLogger("pyrecover_tpu_torch")

DEFAULT_ATTEMPTS = 5
ATTEMPTS_ENV = "PYRECOVER_IO_RETRIES"

# errnos worth sleeping on: the operation can genuinely succeed on retry
TRANSIENT_ERRNOS = frozenset({
    errno.EIO, errno.EAGAIN, errno.EINTR, errno.EBUSY, errno.ETIMEDOUT,
})

# deterministic jitter stream: one process replays the same schedule every
# run, processes differ by pid
_jitter = random.Random(0x5EED ^ os.getpid())


def is_transient(exc):
    """True when the OSError is worth retrying."""
    return isinstance(exc, OSError) and exc.errno in TRANSIENT_ERRNOS


def io_retry(fn, *, op, path="", attempts=None, base_delay_s=0.05,
             max_delay_s=2.0, sleep=time.sleep):
    """Run ``fn()``; on a transient OSError, back off and retry.

    Backoff doubles from ``base_delay_s`` capped at ``max_delay_s``, each
    delay scaled by a jitter factor in [0.5, 1.5). ``attempts`` is the
    TOTAL number of tries (default ``$PYRECOVER_IO_RETRIES`` or 5); the
    final failure re-raises the original error. Non-transient errors and
    non-OSErrors propagate immediately.
    """
    if attempts is None:
        attempts = int(os.environ.get(ATTEMPTS_ENV, DEFAULT_ATTEMPTS))
    attempts = max(1, attempts)
    t0 = None  # monotonic stamp of the first failure (retries only)
    for attempt in range(1, attempts + 1):
        try:
            result = fn()
        except OSError as e:
            if t0 is None:
                t0 = time.monotonic()
            if attempt >= attempts or not is_transient(e):
                raise
            delay = min(base_delay_s * (2.0 ** (attempt - 1)), max_delay_s)
            delay *= 0.5 + _jitter.random()
            telemetry.emit(
                "ckpt_io_retry", op=op, path=str(path), attempt=attempt,
                attempts=attempts, errno=e.errno,
                error=f"{type(e).__name__}: {e}", delay_s=round(delay, 4),
            )
            log.warning("%s %s: %s: %s; retry %d of %d in %.3f s", op, path,
                        type(e).__name__, e, attempt, attempts - 1, delay)
            sleep(delay)
        else:
            if t0 is not None:
                # one trace slice from the first failure to the success, and
                # a sample of the slow-filesystem signal
                telemetry.record_span(
                    "io_retry", t0, time.monotonic(), op=op, path=str(path),
                    attempts=attempt, metric="io_retry_latency_s",
                )
            return result
