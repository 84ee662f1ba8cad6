"""Hierarchical tracing spans on monotonic clocks, emitted through the bus
(the JAX package's ``telemetry/spans.py``).

``span("ckpt_save", engine="vanilla")`` opens a timed region::

    with spans.span("ckpt_save", engine="vanilla", step=12):
        ... serialize / write / commit ...

Each span emits a ``span_begin`` and ``span_end`` event pair through the
existing telemetry bus (so the JSONL shard each host writes carries its
own trace), stamped with BOTH clocks:

  * ``ts``   — wall seconds (bus envelope), comparable across hosts after
    ``traceview``'s anchor-based alignment;
  * ``mono`` — ``time.monotonic()`` seconds, immune to NTP steps, the
    clock durations are computed on.

Span identity: a process-unique integer id plus the emitting thread's
ident (``tid``). Nesting is tracked per-thread (a thread-local stack), so
the background checkpoint writer and the loader threads each build their own correctly-nested trace without
locking against the train loop. ``span_end`` records ``dur_s`` and — when
the body raised — ``ok=False`` with the exception type, so a trace shows
exactly which save attempt died.

Cost model: with no sink registered ``span()`` returns a shared no-op
context manager — two attribute loads and a truth test, no allocation, no
clock read — so instrumentation points are free on un-instrumented runs.
With sinks active a span costs two ``emit`` calls.

``record_span`` writes a RETROACTIVE span (one ``span`` event carrying
``mono``+``dur_s``): the train hot loop buffers per-step timestamps and
emits its step/data-wait/dispatch spans at the next sync point, so tracing
never adds file I/O between dispatches. A span reads host clocks only: it
never synchronises the device (device time is the profile's job,
``--profile``).

``metric="hist_name"`` on any span additionally folds the duration into
the named :mod:`pyrecover_tpu_torch.telemetry.metrics` histogram — one call
site wires both the trace slice and the percentile accounting.

Distributed traces: when a :mod:`pyrecover_tpu_torch.telemetry.tracing`
context is installed on the emitting thread (``with
tracing.installed(ctx):``), every span — including retroactive
``record_span`` ones, which the serving engine buffers and emits from
its pump thread — carries ``trace``/``attempt`` fields and, when it has
no local parent, parents itself under the wire-propagated attempt span.
"""

import threading
import time

from pyrecover_tpu_torch.telemetry import bus, tracing

_local = threading.local()
_id_lock = threading.Lock()
_next_id = 0


def _new_id():
    global _next_id
    with _id_lock:
        _next_id += 1
        return _next_id


def _stack():
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def current_span_id():
    """Id of the innermost open span on THIS thread, or None."""
    s = getattr(_local, "stack", None)
    return s[-1] if s else None


class Span:
    """An open span. Use via ``span(...)`` (context manager) or
    ``begin(...)``/``.end()`` for regions that don't nest lexically
    (the profiler window)."""

    __slots__ = ("name", "fields", "span_id", "parent_id", "t0", "metric",
                 "_open")

    def __init__(self, name, fields, metric=None):
        self.name = name
        self.fields = fields
        self.metric = metric
        self.span_id = _new_id()
        stack = _stack()
        self.parent_id = stack[-1] if stack else None
        ctx = tracing.current()
        if ctx is not None:
            if self.parent_id is None:
                self.parent_id = ctx.span
            fields.setdefault("trace", ctx.trace)
            fields.setdefault("attempt", ctx.attempt)
        stack.append(self.span_id)
        self._open = True
        self.t0 = time.monotonic()
        bus.emit(
            "span_begin", name=name, span=self.span_id,
            parent=self.parent_id, tid=threading.get_ident(),
            thread=threading.current_thread().name,
            mono=round(self.t0, 6), **fields,
        )

    def end(self, ok=True, error=None):
        """Close the span (idempotent)."""
        if not self._open:
            return
        self._open = False
        t1 = time.monotonic()
        stack = _stack()
        # tolerate out-of-order closes (a begin/end pair crossing a
        # callback boundary): pop down to and including this span
        if self.span_id in stack:
            del stack[stack.index(self.span_id):]
        dur = t1 - self.t0
        extra = {} if ok else {"ok": False, "error": error or ""}
        bus.emit(
            "span_end", name=self.name, span=self.span_id,
            parent=self.parent_id, tid=threading.get_ident(),
            mono=round(t1, 6), dur_s=round(dur, 6), **extra, **self.fields,
        )
        if self.metric is not None:
            from pyrecover_tpu_torch.telemetry import metrics

            metrics.histogram(self.metric).observe(dur)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.end()
        else:
            self.end(ok=False, error=f"{exc_type.__name__}: {exc}")
        return False


class _NullSpan:
    """Shared no-op span: what ``span()`` hands back when no sink is
    registered. Every method is a constant-time no-op."""

    __slots__ = ()
    span_id = None
    parent_id = None

    def end(self, ok=True, error=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL = _NullSpan()


def span(name, *, metric=None, **fields):
    """Open a span context manager (no-op without sinks)."""
    if not bus.enabled():
        return _NULL
    return Span(name, fields, metric=metric)


def begin(name, *, metric=None, **fields):
    """Open a span without a ``with`` block; close it with ``.end()``.
    For windows that outlive a lexical scope (profiler start/stop)."""
    if not bus.enabled():
        return _NULL
    return Span(name, fields, metric=metric)


# ---- bounded distributed waits ----------------------------------------------

# Every cross-process wait (a torch.distributed barrier, broadcast or
# all-reduce once data parallelism lands) runs inside a `collective_phase`:
# an open `collective_wait` span names the phase (so a hang bundle — and
# doctor — can say WHICH protocol step never completed) and a daemon timer
# makes an overrun loud. A blocking collective cannot be cancelled, so the
# timer cannot unstick the wait — it emits `distributed_wait_timeout` and
# dumps a flight bundle, turning a silent forever-hang into a named,
# evidenced one.
COLLECTIVE_TIMEOUT_ENV = "PYRECOVER_COLLECTIVE_TIMEOUT_S"
DEFAULT_COLLECTIVE_TIMEOUT_S = 600.0


def _collective_timeout_s(timeout_s):
    if timeout_s is not None:
        return float(timeout_s)
    import os

    raw = os.environ.get(COLLECTIVE_TIMEOUT_ENV)
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    return DEFAULT_COLLECTIVE_TIMEOUT_S


class _PhaseTimer:
    """Daemon timer armed for the span of one collective phase."""

    __slots__ = ("timer",)

    def __init__(self, phase, timeout_s, fields):
        def _expired():
            bus.emit(
                "distributed_wait_timeout", phase=phase,
                timeout_s=round(timeout_s, 3), **fields,
            )
            from pyrecover_tpu_torch.telemetry import flight

            flight.dump(
                "distributed_wait_timeout", phase=phase,
                timeout_s=round(timeout_s, 3),
            )

        self.timer = threading.Timer(timeout_s, _expired)
        self.timer.daemon = True
        self.timer.start()

    def cancel(self):
        self.timer.cancel()


class collective_phase:
    """Context manager bounding one distributed wait.

    ``with collective_phase("grad_allreduce"): ...`` opens a
    ``collective_wait`` span carrying ``phase=<name>`` and arms a timer
    (``timeout_s`` arg, else ``$PYRECOVER_COLLECTIVE_TIMEOUT_S``, else
    600 s). If the body outlives the bound, ``distributed_wait_timeout``
    is emitted and a flight bundle dumped — the wait itself cannot be
    cancelled, but the hang becomes named evidence instead of silence.
    ``timeout_s=0`` disables the timer (span only).
    """

    __slots__ = ("phase", "fields", "_timeout_s", "_span", "_timer")

    def __init__(self, phase, *, timeout_s=None, **fields):
        self.phase = str(phase)
        self.fields = fields
        self._timeout_s = _collective_timeout_s(timeout_s)
        self._span = None
        self._timer = None

    def __enter__(self):
        self._span = span(
            "collective_wait", metric="collective_wait_s",
            phase=self.phase, **self.fields,
        )
        self._span.__enter__()
        if self._timeout_s > 0:
            self._timer = _PhaseTimer(
                self.phase, self._timeout_s, self.fields
            )
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._timer is not None:
            self._timer.cancel()
        return self._span.__exit__(exc_type, exc, tb)


def record_span(name, begin_mono, end_mono, *, parent=None, metric=None,
                span_id=None, **fields):
    """Record an already-elapsed span from two ``time.monotonic()`` stamps
    (one ``span`` event, no begin/end pair). The hot-loop path: timestamps
    are captured per step, the event is written at the next sync point.

    Carries the thread's installed trace context (``trace``/``attempt``
    fields; the wire attempt span as parent when there is no local one),
    so buffered per-request spans join their distributed trace instead of
    orphaning. ``span_id`` overrides the process-local integer id with a
    trace-scoped one (the router's root/attempt spans).
    Returns the span id (or None without sinks)."""
    dur = max(end_mono - begin_mono, 0.0)
    if metric is not None:
        from pyrecover_tpu_torch.telemetry import metrics

        metrics.histogram(metric).observe(dur)
    if not bus.enabled():
        return None
    if span_id is None:
        span_id = _new_id()
    ctx = tracing.current()
    if ctx is not None:
        fields.setdefault("trace", ctx.trace)
        fields.setdefault("attempt", ctx.attempt)
    if parent is None:
        parent = current_span_id()
    if parent is None and ctx is not None:
        parent = ctx.span
    bus.emit(
        "span", name=name, span=span_id, parent=parent,
        tid=threading.get_ident(), mono=round(begin_mono, 6),
        dur_s=round(dur, 6), **fields,
    )
    return span_id
