"""Live metrics exposition + SLO alerting, the per-process half of the live
telemetry plane (the JAX package's ``telemetry/exporter.py``: the same
endpoints, text, rules, env names and events).

The registry (``telemetry/metrics.py``) is readable while the process is
alive: a stdlib ``http.server`` on ONE daemon thread serves

    /metrics        Prometheus text exposition (v0.0.4): counters,
                    gauges, and the log-bucket histograms as cumulative
                    ``_bucket{le=...}`` series on the geometric grid
    /snapshot.json  the exact JSON wire format (raw bucket counts via
                    ``metrics.snapshot(raw_buckets=True)`` plus the
                    process identity ``pid``/``start_ts``/``seq`` the
                    fleet aggregator uses for restart detection) and the
                    current alert states

The serve thread reads only plain host-side dicts under the registry lock
and writes bytes to a socket: it never calls into ``torch.cuda``, never
synchronises the card and never reads a tensor. A device gauge is set by
the loop that owns the device (the trainer's memory gauges at its sync
points). ``start()`` binds (port 0 = ephemeral) and spawns the serve
thread; ``stop(timeout)`` shuts the server down and joins the thread,
bounded, raising ``TimeoutError`` naming the thread if it wedges.
``exporter_started`` / ``exporter_stopped`` events bracket the lifetime in
the normal telemetry stream; a parent that starts a child with
``PYRECOVER_METRICS_PORT=0`` learns the port from the child's
``exporter_started`` record.

SLO alerting rides the serve loop's ``service_actions`` hook (no second
thread): every ``eval_interval_s`` the rules are evaluated over
*interval deltas* of the registry (bucket-wise subtraction of the
cumulative histograms, exact on the shared grid), and every state
transition is emitted as a ``slo_alert`` event, so the doctor sees the
live plane's judgements in the post-hoc record too.

Rule syntax (``parse_alert_rules``, the ``$PYRECOVER_SLO_RULES`` env var):

    request_p99>0.5           windowed request e2e p99 above 0.5 s
    step_regress>1.5          windowed step-time p50 above 1.5x the
                              rolling (EWMA) baseline of prior windows
    backpressure_duty>0.25    backpressure counter incremented in >25%
                              of eval intervals inside the window
    rule@30                   optional per-rule window override (seconds)

Enable from the environment (the trainer and the drills honour it):
``PYRECOVER_METRICS_PORT`` (0 = ephemeral), ``PYRECOVER_METRICS_HOST``
(default 127.0.0.1), ``PYRECOVER_SLO_RULES`` (defaults below).
``python -m pyrecover_tpu_torch.telemetry.exporter --status FILE ...`` is
the demo target the fleet drill scrapes.
"""

import http.server
import json
import os
import threading
import time

from pyrecover_tpu_torch.telemetry import bus, metrics
from pyrecover_tpu_torch.telemetry.metrics import (
    bucket_bounds,
    bucket_from_key,
    percentile_from_buckets,
)

PORT_ENV = "PYRECOVER_METRICS_PORT"
HOST_ENV = "PYRECOVER_METRICS_HOST"
RULES_ENV = "PYRECOVER_SLO_RULES"

DEFAULT_RULES = "request_p99>2.0,step_regress>2.0,backpressure_duty>0.5"

# alert-kind -> the metric series it measures, unless the rule overrides
# it. Module-level so obscheck's consumer extraction sees the exporter's
# series dependencies declaratively.
DEFAULT_SERIES = {
    "request_p99": "e2e_s",
    "step_regress": "step_iter_s",
    "backpressure_duty": "serving_backpressure_total",
}

_PROM_PREFIX = "pyrecover_"


# ---- alert rules ------------------------------------------------------------


class AlertRule:
    """One configured SLO rule (immutable config; state lives in the
    exporter's evaluator)."""

    KINDS = ("request_p99", "step_regress", "backpressure_duty")

    __slots__ = ("name", "kind", "threshold", "window_s", "series")

    def __init__(self, kind, threshold, *, window_s=30.0,
                 series=None, name=None):
        if kind not in self.KINDS:
            raise ValueError(
                f"unknown alert rule kind {kind!r} (know {self.KINDS})"
            )
        self.kind = kind
        self.threshold = float(threshold)
        self.window_s = float(window_s)
        self.series = series or DEFAULT_SERIES[kind]
        self.name = name or kind

    def as_dict(self):
        return {
            "name": self.name, "kind": self.kind,
            "threshold": self.threshold, "window_s": self.window_s,
            "series": self.series,
        }


def parse_alert_rules(spec):
    """Parse the compact rule syntax: comma-separated ``kind>threshold``
    items, each optionally suffixed ``@window_seconds``. Empty spec ->
    no rules."""
    rules = []
    for item in (spec or "").split(","):
        item = item.strip()
        if not item:
            continue
        window_s = 30.0
        if "@" in item:
            item, win = item.rsplit("@", 1)
            window_s = float(win)
        if ">" not in item:
            raise ValueError(
                f"bad alert rule {item!r}: expected kind>threshold"
            )
        kind, thr = item.split(">", 1)
        rules.append(
            AlertRule(kind.strip(), float(thr), window_s=window_s)
        )
    return rules


def default_alert_rules():
    return parse_alert_rules(os.environ.get(RULES_ENV, DEFAULT_RULES))


class _DeltaTracker:
    """Interval deltas of one cumulative histogram: bucket-wise
    subtraction of successive raw snapshots (exact on the shared grid).
    A count that goes BACKWARDS (registry reset) re-baselines instead of
    producing a negative delta."""

    __slots__ = ("prev",)

    def __init__(self):
        self.prev = None

    def feed(self, raw):
        """``raw`` is the histogram's raw dict (or None when absent).
        Returns ``(delta_buckets, delta_count)`` with int bucket keys,
        or ``(None, 0)`` when there is nothing new this interval."""
        prev, self.prev = self.prev, raw
        if raw is None:
            return None, 0
        if prev is None or raw["count"] < prev["count"]:
            prev = {"count": 0, "buckets": {}}
        dcount = raw["count"] - prev["count"]
        if dcount <= 0:
            return None, 0
        delta = {}
        for key, n in raw["buckets"].items():
            d = n - prev["buckets"].get(key, 0)
            if d > 0:
                delta[bucket_from_key(key)] = d
        return delta, dcount


class _AlertEvaluator:
    """The rule engine: fed one raw snapshot per eval interval, keeps
    windowed state per rule, emits ``slo_alert`` on every fire/clear
    transition. Single consumer — only the exporter's serve thread (or a
    test driving ``evaluate``) calls into it."""

    def __init__(self, rules):
        self.rules = list(rules)
        self._hist_delta = {}    # series -> _DeltaTracker
        self._counter_prev = {}  # series -> last cumulative value
        self._baseline = {}      # rule name -> EWMA of windowed p50s
        self._baseline_n = {}    # rule name -> windows folded in
        self._duty = {}          # rule name -> [(ts, breached), ...]
        self._state = {}         # rule name -> {"state", "value", ...}

    def states(self):
        return {name: dict(st) for name, st in self._state.items()}

    def evaluate(self, snap, now=None):
        """One evaluation pass over a ``snapshot(raw_buckets=True)``."""
        now = time.time() if now is None else now
        fired = []
        for rule in self.rules:
            value = self._measure(rule, snap, now)
            st = self._state.setdefault(
                rule.name, {"state": "ok", "value": None, "fires": 0},
            )
            if value is None:
                continue  # nothing new this interval: hold state
            st["value"] = round(value, 6)
            breached = value > rule.threshold
            if breached and st["state"] != "fire":
                st["state"] = "fire"
                st["fires"] += 1
                fired.append((rule, "firing", value))
            elif not breached and st["state"] == "fire":
                st["state"] = "ok"
                fired.append((rule, "cleared", value))
        for rule, state, value in fired:
            if state == "firing":
                metrics.counter("slo_alerts_total").inc()
            bus.emit(
                "slo_alert", rule=rule.name, kind=rule.kind,
                state=state, value=round(value, 6),
                threshold=rule.threshold, window_s=rule.window_s,
                series=rule.series,
            )
        return fired

    def _measure(self, rule, snap, now):
        if rule.kind == "request_p99":
            delta, n = self._delta(rule.series, snap)
            if not n:
                return None
            return percentile_from_buckets(delta, n, None, None, 0.99)
        if rule.kind == "step_regress":
            delta, n = self._delta(rule.series, snap)
            if not n:
                return None
            p50 = percentile_from_buckets(delta, n, None, None, 0.50)
            base = self._baseline.get(rule.name)
            seen = self._baseline_n.get(rule.name, 0)
            # fold AFTER measuring: the current window never judges itself
            self._baseline[rule.name] = (
                p50 if base is None else 0.8 * base + 0.2 * p50
            )
            self._baseline_n[rule.name] = seen + 1
            if base is None or base <= 0 or seen < 3:
                return None  # no trustworthy baseline yet
            return p50 / base
        # backpressure_duty: fraction of eval intervals (inside the
        # window) in which the counter moved
        cur = snap["counters"].get(rule.series, 0)
        prev = self._counter_prev.get(rule.series)
        self._counter_prev[rule.series] = cur
        if prev is None or cur < prev:
            return None  # first sample / registry reset: re-baseline
        marks = self._duty.setdefault(rule.name, [])
        marks.append((now, cur > prev))
        while marks and marks[0][0] < now - rule.window_s:
            marks.pop(0)
        if not marks:
            return None
        return sum(1 for _, b in marks if b) / len(marks)

    def _delta(self, series, snap):
        tracker = self._hist_delta.setdefault(series, _DeltaTracker())
        return tracker.feed(snap["hists"].get(series))


# ---- Prometheus text rendering ----------------------------------------------


def _prom_name(name):
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return _PROM_PREFIX + s


def _prom_num(v):
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (int, float)):
        return repr(float(v)) if isinstance(v, float) else str(v)
    return "NaN"


def render_prometheus(snap):
    """Prometheus text exposition (v0.0.4) of a raw-bucket snapshot.
    Histograms render as cumulative ``_bucket{le=...}`` series whose
    bounds are the registry's geometric grid."""
    lines = []
    for name, v in sorted(snap["counters"].items()):
        m = _prom_name(name)
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {_prom_num(v)}")
    for name, v in sorted(snap["gauges"].items()):
        if not isinstance(v, (int, float)):
            continue
        m = _prom_name(name)
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {_prom_num(v)}")
    for name, h in sorted(snap["hists"].items()):
        m = _prom_name(name)
        lines.append(f"# TYPE {m} histogram")
        buckets = sorted(
            ((bucket_from_key(k), n) for k, n in h["buckets"].items()),
            key=lambda kv: (kv[0] is not None, kv[0] or 0),
        )
        cum = 0
        for idx, n in buckets:
            cum += n
            _, hi = bucket_bounds(idx)
            lines.append(f'{m}_bucket{{le="{_prom_num(hi)}"}} {cum}')
        lines.append(f'{m}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{m}_sum {_prom_num(h['sum'])}")
        lines.append(f"{m}_count {h['count']}")
    return "\n".join(lines) + "\n"


# ---- the exporter -----------------------------------------------------------


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_GET(self):
        exporter = self.server.exporter
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            body = render_prometheus(
                metrics.snapshot(raw_buckets=True)
            ).encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path in ("/", "/snapshot.json"):
            body = json.dumps(exporter.snapshot()).encode()
            ctype = "application/json"
        else:
            self.send_error(404)
            return
        metrics.counter("exporter_scrapes_total").inc()
        # one connection per scrape: the server is single-threaded, so a
        # keep-alive client parked on the socket would stall both other
        # scrapers and the alert evaluator
        self.close_connection = True
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):
        pass  # scrapes must not spam the host log


class _Server(http.server.HTTPServer):
    """Single-threaded on purpose: the handler and the alert evaluator
    (``service_actions``) both run on the one serve thread, so alert
    state needs no locking and a scrape always sees a coherent pass."""

    allow_reuse_address = True

    def __init__(self, addr, exporter):
        self.exporter = exporter
        super().__init__(addr, _Handler)

    def service_actions(self):
        self.exporter._tick()


class MetricsExporter:
    """Per-process live-metrics endpoint over ``metrics.snapshot()``.

    One daemon serve thread; ``stop(timeout)`` is a bounded join (CC05).
    ``port=0`` binds an ephemeral port — read ``.port`` after
    ``start()``."""

    def __init__(self, host=None, port=None, *, rules=None,
                 eval_interval_s=0.25):
        self.host = host if host is not None else os.environ.get(
            HOST_ENV, "127.0.0.1"
        )
        self.port = int(
            port if port is not None else os.environ.get(PORT_ENV, "0")
        )
        self.rules = (
            list(rules) if rules is not None else default_alert_rules()
        )
        self.eval_interval_s = float(eval_interval_s)
        self._evaluator = _AlertEvaluator(self.rules)
        self._server = None
        self._thread = None
        self._seq = 0
        self._start_ts = None
        self._last_eval = 0.0

    # -- lifecycle ------------------------------------------------------------

    def start(self):
        if self._thread is not None:
            raise RuntimeError("exporter already running")
        self._server = _Server((self.host, self.port), self)
        self.port = self._server.server_address[1]
        self._start_ts = time.time()
        self._thread = threading.Thread(
            target=self._serve, name="metrics-exporter", daemon=True,
        )
        self._thread.start()
        bus.emit(
            "exporter_started", host=self.host, port=self.port,
            url=self.url, rules=[r.as_dict() for r in self.rules],
        )
        return self

    def _serve(self):
        # poll_interval paces service_actions -> the alert evaluator
        self._server.serve_forever(poll_interval=0.05)

    @property
    def url(self):
        return f"http://{self.host}:{self.port}"

    def stop(self, timeout=10.0):
        """Shut down and JOIN the serve thread (bounded — a wedged
        socket surfaces as a TimeoutError naming the thread, the CC05
        discipline), then emit ``exporter_stopped``."""
        if self._thread is None:
            return
        self._server.shutdown()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(
                f"metrics-exporter thread did not stop within {timeout}s"
            )
        self._server.server_close()
        self._thread = None
        bus.emit(
            "exporter_stopped", host=self.host, port=self.port,
            scrapes=metrics.counter("exporter_scrapes_total").value,
            uptime_s=round(time.time() - (self._start_ts or 0.0), 3),
        )

    # -- scrape + alert surface -----------------------------------------------

    def snapshot(self):
        """The JSON wire format one scrape returns: the raw-bucket
        registry view plus the identity fields the aggregator's restart
        detection keys on."""
        self._seq += 1
        snap = metrics.snapshot(raw_buckets=True)
        snap.update(
            ts=time.time(), pid=os.getpid(), start_ts=self._start_ts,
            seq=self._seq, alerts=self._evaluator.states(),
        )
        return snap

    def _tick(self):
        now = time.monotonic()
        if now - self._last_eval < self.eval_interval_s:
            return
        self._last_eval = now
        self._evaluator.evaluate(metrics.snapshot(raw_buckets=True))

    def evaluate_now(self, now=None):
        """Force one alert evaluation (tests / non-serving callers)."""
        return self._evaluator.evaluate(
            metrics.snapshot(raw_buckets=True), now=now
        )

    def alert_states(self):
        return self._evaluator.states()


def maybe_start_from_env():
    """Start an exporter iff ``$PYRECOVER_METRICS_PORT`` is set (the
    train-loop hook). Returns the running exporter or None."""
    port = os.environ.get(PORT_ENV)
    if port is None or port == "":
        return None
    return MetricsExporter(port=int(port)).start()


# ---- demo child (the fleet drill's scrape target) ---------------------------


def _demo_main(argv=None):
    """Subprocess entry for the aggregator fleet drill: populate the
    registry with the values given on the command line, start an
    exporter on an ephemeral port, report it on the status line, then
    idle until killed."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--status", required=True,
                    help="JSONL status file (drill protocol)")
    ap.add_argument("--counter", action="append", default=[],
                    metavar="NAME=N")
    ap.add_argument("--gauge", action="append", default=[],
                    metavar="NAME=V")
    ap.add_argument("--hist", action="append", default=[],
                    metavar="NAME=V1:V2:...")
    ap.add_argument("--linger-s", type=float, default=120.0)
    args = ap.parse_args(argv)

    for item in args.counter:
        name, v = item.split("=", 1)
        metrics.counter(name).inc(int(v))
    for item in args.gauge:
        name, v = item.split("=", 1)
        metrics.gauge(name).set(float(v))
    for item in args.hist:
        name, vals = item.split("=", 1)
        for v in vals.split(":"):
            metrics.histogram(name).observe(float(v))

    exporter = MetricsExporter(port=0).start()
    # the drill's status line: the parent polls the file and decodes each
    # line, skipping torn ones
    with open(args.status, "a") as f:
        f.write(json.dumps(
            {"event": "serving", "port": exporter.port,
             "pid": os.getpid()}
        ) + "\n")
        f.flush()
    deadline = time.monotonic() + args.linger_s
    try:
        while time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        exporter.stop()


if __name__ == "__main__":
    _demo_main()
