"""Per-request distributed trace context (the JAX package's
``telemetry/tracing.py``, pure stdlib).

A request that crosses processes leaves spans in several telemetry shards;
this is the identity and propagation layer that lets them be stitched back
into one rooted tree per request (``traceassembly.py``, in either
package, reads either package's shards):

* **trace id** — deterministic from the content-derived request id:
  ``trace_id(rid)`` is a 16-hex blake2b digest, so every process derives the
  same id with no coordination.
* **root / attempt span ids** — ``<trace>:r`` for the request's root span
  and ``<trace>:a<N>`` for dispatch attempt ``N``, beside the process-local
  integer ids of :mod:`pyrecover_tpu_torch.telemetry.spans`.
* **thread-local installation** — ``with installed(ctx):`` makes every span
  opened on that thread carry ``trace``/``attempt`` fields and parent itself
  under the propagated attempt span when it has no local parent.
  ``installed(None)`` is a no-op, so request paths install unconditionally.
* **wire codec** — ``ctx.to_wire()`` / ``from_wire(d)`` move the context as a
  plain dict; an absent or unknown ``trace`` frame decodes to None.

The module emits nothing itself.
"""

import threading
from hashlib import blake2b

_local = threading.local()


def trace_id(rid, epoch=""):
    """Deterministic 16-hex trace id from the content-derived request
    id — every process (and offline assembly) derives the same id. The
    optional ``epoch`` qualifier (a deployment/phase label, still fully
    deterministic) keeps deliberate same-workload replays — the chaos
    drill's baseline vs kill phases — from colliding in a merged
    stream."""
    key = str(rid) if not epoch else f"{epoch}\x00{rid}"
    return blake2b(key.encode(), digest_size=8).hexdigest()


def root_span_id(tid):
    """The trace's root span id (owned by the router)."""
    return f"{tid}:r"


def attempt_span_id(tid, attempt):
    """The span id of dispatch attempt ``attempt`` (1-based; a redrive
    re-dispatches the SAME trace as attempt N+1 under the same root)."""
    return f"{tid}:a{int(attempt)}"


class TraceContext:
    """Immutable-by-convention (trace, parent span, attempt) triple."""

    __slots__ = ("trace", "span", "attempt")

    def __init__(self, trace, span, attempt=1):
        self.trace = str(trace)
        self.span = str(span)
        self.attempt = int(attempt)

    def child(self, span):
        """Same trace/attempt, reparented under ``span``."""
        return TraceContext(self.trace, span, self.attempt)

    def to_wire(self):
        return {"trace": self.trace, "span": self.span,
                "attempt": self.attempt}

    def __repr__(self):
        return (f"TraceContext(trace={self.trace!r}, span={self.span!r}, "
                f"attempt={self.attempt})")


def mint(rid, epoch=""):
    """Root context for a newly admitted request: parent = root span."""
    tid = trace_id(rid, epoch)
    return TraceContext(tid, root_span_id(tid), attempt=1)


def from_wire(d):
    """Decode a protocol ``trace`` dict; None (or garbage) -> None, so
    frames from peers that predate tracing still dispatch."""
    if not isinstance(d, dict):
        return None
    trace, span = d.get("trace"), d.get("span")
    if not trace or not span:
        return None
    try:
        attempt = int(d.get("attempt", 1))
    except (TypeError, ValueError):
        attempt = 1
    return TraceContext(trace, span, attempt)


def current():
    """The context installed on THIS thread, or None."""
    return getattr(_local, "ctx", None)


class installed:
    """Install ``ctx`` thread-locally for the body (None = no-op, so
    request-handling paths install unconditionally). Re-entrant: the
    prior context is restored on exit."""

    __slots__ = ("ctx", "_prev")

    def __init__(self, ctx):
        self.ctx = ctx
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_local, "ctx", None)
        if self.ctx is not None:
            _local.ctx = self.ctx
        return self.ctx

    def __exit__(self, exc_type, exc, tb):
        if self.ctx is not None:
            _local.ctx = self._prev
        return False
