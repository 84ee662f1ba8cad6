"""Process-local metrics: counters, gauges and log-bucketed histograms (the
JAX package's ``telemetry/metrics.py``). Producers update process-local
state (a dict bump under a lock: no device sync, no I/O); ``flush`` emits
the registry through the bus as ONE ``metrics_snapshot`` event carrying every
counter and gauge and, per histogram, count/sum/min/max and the estimated
p50/p95/p99. ``maybe_flush(interval_s)`` rate-limits it for the training
loop's sync points; with no sink a flush is a no-op and the registry keeps
accumulating (``snapshot()`` reads it directly).

Histograms bucket on a geometric grid (``base = 2**0.25``, 4 buckets per
octave, ~19% relative resolution), so a microsecond and a 300-second value
live in one fixed structure and a percentile's error is bounded by the
bucket width. Zero and negative values land in a dedicated zero bucket.
The grid is the JAX package's, so both packages give the same percentiles
for the same observations, and ``snapshot(raw_buckets=True)`` carries the
JSON-safe bucket counts (``bucket_key``) that merge bucket-wise across
processes.

Wired-in histograms: ``step_iter_s``, ``step_data_wait_s``,
``step_dispatch_s`` (train loop), ``loader_wait_s`` (loader),
``ckpt_vanilla_<phase>_s`` and ``ckpt_blocking_s`` (checkpoints),
``io_retry_latency_s`` (retry), ``ttft_s``/``tpot_s``/``e2e_s`` (serving).
"""

import math
import threading
import time

from pyrecover_tpu_torch.telemetry import bus

_BASE = 2.0 ** 0.25
_LOG_BASE = math.log(_BASE)

_lock = threading.Lock()
_counters = {}
_gauges = {}
_histograms = {}
_last_flush = [0.0]  # monotonic stamp of the last flush (boxed for mutation)


class Counter:
    """Monotonic event count."""

    __slots__ = ("name", "value")

    def __init__(self, name):
        self.name = name
        self.value = 0

    def inc(self, n=1):
        with _lock:
            self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "value")

    def __init__(self, name):
        self.name = name
        self.value = None

    def set(self, v):
        self.value = v


class Histogram:
    """Log-bucketed distribution with exact count/sum/min/max."""

    __slots__ = ("name", "count", "sum", "min", "max", "buckets")

    def __init__(self, name):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self.buckets = {}  # bucket index (None = zero bucket) -> count

    def observe(self, v, n=1):
        """Record ``v``, ``n`` times."""
        v = float(v)
        n = int(n)
        if n <= 0:
            return
        idx = None if v <= 0.0 else math.ceil(math.log(v) / _LOG_BASE - 1e-9)
        with _lock:
            self.count += n
            self.sum += v * n
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self.buckets[idx] = self.buckets.get(idx, 0) + n

    def percentile(self, q):
        """Estimated q-quantile (0 < q <= 1): the geometric midpoint of the
        bucket the rank falls in, clamped to the observed min/max."""
        with _lock:
            buckets = dict(self.buckets)
            count, vmin, vmax = self.count, self.min, self.max
        return percentile_from_buckets(buckets, count, vmin, vmax, q)

    def raw(self):
        """JSON-safe exact state: count/sum/min/max and the bucket counts
        keyed by `bucket_key`, the exposition/merge wire format."""
        with _lock:
            buckets = dict(self.buckets)
            d = {
                "count": self.count,
                "sum": round(self.sum, 9),
                "min": self.min,
                "max": self.max,
            }
        d["buckets"] = {bucket_key(idx): n for idx, n in buckets.items()}
        return d

    def as_dict(self):
        d = {
            "count": self.count,
            "sum": round(self.sum, 6),
            "min": round(self.min, 6) if self.min is not None else None,
            "max": round(self.max, 6) if self.max is not None else None,
        }
        for label, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
            p = self.percentile(q)
            d[label] = round(p, 6) if p is not None else None
        return d


def bucket_key(idx):
    """JSON-safe bucket label: ``"zero"`` for the zero bucket (idx None),
    else the decimal bucket index (may be negative)."""
    return "zero" if idx is None else str(idx)


def bucket_from_key(key):
    """Inverse of `bucket_key`."""
    return None if key == "zero" else int(key)


def bucket_bounds(idx):
    """``(lo, hi]`` value range of bucket ``idx`` (the zero bucket is
    ``(None, 0.0]``)."""
    if idx is None:
        return None, 0.0
    return _BASE ** (idx - 1), _BASE ** idx


def percentile_from_buckets(buckets, count, vmin, vmax, q):
    """Estimated q-quantile over a log-bucket count dict on THE grid (keyed
    by bucket index, None = zero bucket): the geometric midpoint of the
    bucket the rank falls in, clamped to the observed min/max when known."""
    if count <= 0:
        return None
    rank = q * count
    items = sorted(buckets.items(), key=lambda kv: (kv[0] is not None, kv[0] or 0))
    cum = 0
    for idx, n in items:
        cum += n
        if cum >= rank - 1e-9:
            if idx is None:
                return 0.0
            lo, hi = bucket_bounds(idx)
            est = math.sqrt(lo * hi)
            if vmin is not None:
                est = max(est, vmin)
            if vmax is not None:
                est = min(est, vmax)
            return est
    return vmax


def counter(name):
    """Get-or-create the named counter."""
    c = _counters.get(name)
    if c is None:
        with _lock:
            c = _counters.setdefault(name, Counter(name))
    return c


def gauge(name):
    g = _gauges.get(name)
    if g is None:
        with _lock:
            g = _gauges.setdefault(name, Gauge(name))
    return g


def histogram(name):
    h = _histograms.get(name)
    if h is None:
        with _lock:
            h = _histograms.setdefault(name, Histogram(name))
    return h


def snapshot(raw_buckets=False):
    """Point-in-time view of every registered metric (plain dicts).
    ``raw_buckets=True`` adds each histogram's exact JSON-safe bucket counts
    (the merge wire format); the default is the ``metrics_snapshot`` event's
    schema (percentile summaries only)."""
    with _lock:
        counters = {name: c.value for name, c in _counters.items()}
        gauges = {name: g.value for name, g in _gauges.items() if g.value is not None}
        hist_objs = list(_histograms.items())
    hists = {}
    for name, h in hist_objs:
        if not h.count:
            continue
        hists[name] = h.as_dict()
        if raw_buckets:
            hists[name]["buckets"] = h.raw()["buckets"]
    return {"counters": counters, "gauges": gauges, "hists": hists}


def flush(reason=""):
    """Emit the current snapshot as one ``metrics_snapshot`` event (no-op
    without sinks; the registry keeps accumulating either way)."""
    _last_flush[0] = time.monotonic()
    if not bus.enabled():
        return None
    snap = snapshot()
    if not (snap["counters"] or snap["gauges"] or snap["hists"]):
        return None
    return bus.emit("metrics_snapshot", reason=reason, **snap)


def maybe_flush(interval_s=30.0):
    """Flush at most once per ``interval_s``: the training loop's call site
    (sync points come every few steps; snapshots should not)."""
    if time.monotonic() - _last_flush[0] >= interval_s:
        return flush(reason="interval")
    return None


def reset():
    """Drop every registered metric (test isolation, a fresh run)."""
    with _lock:
        _counters.clear()
        _gauges.clear()
        _histograms.clear()
        _last_flush[0] = 0.0
