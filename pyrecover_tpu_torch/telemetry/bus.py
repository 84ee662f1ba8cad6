"""The telemetry event bus: ``emit(event, **fields)`` + pluggable sinks (the
JAX package's ``telemetry/bus.py``).

One process-wide bus. Producers anywhere in the stack (train loop,
checkpoint writer, preemption watcher, data loader, serving engine) call
``emit``; the bus stamps the envelope (``ts`` unix seconds, ``event`` name,
``host`` process index) and fans the record out to every registered sink.
With no sinks registered ``emit`` is a two-instruction no-op, and no field a
producer passes is a device value: an emit never synchronises the card.

Sinks are duck-typed: anything with ``write(record: dict)`` (and an optional
``close()``). A sink that raises is disabled after one warning, so a broken
disk for the telemetry file never takes down the step that emitted the
event. Producers include background threads (checkpoint writer, loader
workers, watchdog), so fan-out runs under a lock.
"""

import threading
import time

from pyrecover_tpu_torch.utils.logging import process_index as _resolve_index

_lock = threading.RLock()
_sinks = []
_host = None  # cached process index; None = not yet resolved


def _process_index():
    # cached: emit() runs on every event. The rank of an initialised
    # torch.distributed group, else 0; reset_process_index() forgets it
    # once a process group comes up.
    global _host
    if _host is None:
        # concur: disable-next=unguarded-shared-state -- benign race: an
        # idempotent cache fill with an immutable int; racing writers all
        # store the same value, and the GIL makes the store atomic
        _host = _resolve_index()
    return _host


def reset_process_index():
    """Forget the cached host index so the next emit re-resolves it. Called
    once after ``torch.distributed.init_process_group``: the index resolved
    before it (always 0) is stale on the other ranks."""
    global _host
    _host = None


def enabled():
    """True when at least one sink is registered (producers may use this to
    skip building per-event field dicts in hot paths)."""
    return bool(_sinks)


def add_sink(sink):
    with _lock:
        _sinks.append(sink)
    return sink


def remove_sink(sink):
    """Detach ``sink`` (closing it if it has ``close``); missing is a no-op."""
    with _lock:
        try:
            _sinks.remove(sink)
        except ValueError:
            return
    close_fn = getattr(sink, "close", None)
    if close_fn is not None:
        close_fn()


def close():
    """Detach and close every sink (end of run, test teardown)."""
    with _lock:
        sinks, _sinks[:] = list(_sinks), []
    for s in sinks:
        close_fn = getattr(s, "close", None)
        if close_fn is not None:
            try:
                close_fn()
            except Exception:
                pass


def emit(event, /, **fields):
    """Emit one telemetry event. Returns the record dict (None when no sink
    is registered). The envelope keys (``ts``/``event``/``host``) win over
    same-named fields."""
    if not _sinks:
        return None
    rec = dict(fields)
    rec["ts"] = round(time.time(), 6)
    rec["event"] = str(event)
    rec["host"] = _process_index()
    with _lock:
        for sink in list(_sinks):
            try:
                sink.write(rec)
            except Exception as e:
                _sinks.remove(sink)
                from pyrecover_tpu_torch.utils.logging import log_host0

                log_host0(
                    "telemetry sink %s failed (%s: %s); disabling it",
                    type(sink).__name__, type(e).__name__, e,
                    level=30,  # WARNING
                )
    return rec
