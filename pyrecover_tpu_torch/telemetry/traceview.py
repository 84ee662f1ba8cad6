"""traceview: merge per-host telemetry shards into a Perfetto-loadable
Chrome trace and run cross-host analysis passes (the JAX package's
``telemetry/traceview.py``; either package's shards read the same).

Each host writes its own JSONL telemetry shard (``JsonlSink`` with
``host0_only=False``); this module is the read side that answers the
paper's wall-clock questions:

  * **Merge + clock alignment** — hosts stamp wall clocks that drift/step
    independently. Shards are aligned by anchoring on events every host
    records for the SAME logical moment (``train_sync``/``step_time`` at a
    step, ``ckpt_save_start``/``ckpt_commit`` for a path): the per-shard
    offset is the median of the reference-vs-shard timestamp deltas over
    shared anchors, so one bad sample can't skew the alignment.
  * **Chrome-trace export** — span_begin/span_end pairs (matched per shard
    by span id) and retroactive ``span`` events become complete ``"X"``
    slices; every other telemetry event becomes an instant marker. The
    JSON loads directly in Perfetto / chrome://tracing, one process lane
    per shard, one thread lane per producer thread.
  * **Straggler attribution** — per-host step-time percentiles from the
    synced ``train_sync`` intervals; the slowest host is named with its
    delta vs the median host, which is the first question asked when a
    pod's goodput sags.
  * **Spike detection** — per-host step-time series vs a rolling median:
    isolated steps that blew past ``spike_factor`` × the local baseline
    (GC pause, page-cache eviction, a neighbor stealing the NIC).
  * **Checkpoint-phase regression** — per-phase (write/fsync/commit/
    serialize/restore…) duration percentiles, diffable against a stored
    baseline JSON so "the fsync got 3× slower since last week" is a CI
    failure, not an anecdote.

CLI (``python -m pyrecover_tpu_torch.telemetry.traceview``, the counterpart
of the JAX package's ``tools/traceview.py``)::

    python -m pyrecover_tpu_torch.telemetry.traceview host0.jsonl host1.jsonl --out trace.json
    python -m pyrecover_tpu_torch.telemetry.traceview shards/*.jsonl --baseline ckpt_phases.json
    python -m pyrecover_tpu_torch.telemetry.traceview shards/*.jsonl \
        --write-baseline ckpt_phases.json

Exit codes: 0 = merged + analyzed, 1 = checkpoint-phase regression vs the
baseline, 2 = no readable events.
"""

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

from pyrecover_tpu_torch.telemetry.sinks import read_events

# events usable as cross-host alignment anchors: (event, key field)
_ANCHOR_KEYS = {
    "train_sync": "step",
    "step_time": "step",
    "ckpt_save_start": "path",
    "ckpt_commit": "path",
    "ckpt_restore_start": "path",
}

SPIKE_FACTOR = 2.0
SPIKE_MIN_ABS_S = 1e-3
SPIKE_WINDOW = 9
REGRESSION_TOLERANCE = 0.25  # +25% p50 before a phase counts as regressed
REGRESSION_MIN_ABS_S = 0.005


class Shard:
    """One telemetry JSONL file: its events, dominant host id, label."""

    def __init__(self, path, events):
        self.path = Path(path)
        self.label = self.path.name
        self.events = events
        hosts = defaultdict(int)
        for e in events:
            hosts[e.get("host", 0)] += 1
        self.host = max(hosts, key=hosts.get) if hosts else 0
        self.offset = 0.0  # wall-clock correction, filled by align_clocks


def load_shards(paths):
    """Read every shard (rotation-aware via ``read_events``); shards with
    zero parseable events are dropped with a note on stderr."""
    shards = []
    for p in paths:
        events = read_events(p)
        if not events:
            print(f"traceview: no events in {p}; skipping", file=sys.stderr)
            continue
        shards.append(Shard(p, events))
    return shards


def _anchors(shard):
    """First-occurrence wall timestamp per anchor key in one shard."""
    out = {}
    for e in shard.events:
        field = _ANCHOR_KEYS.get(e.get("event"))
        if field is None or field not in e:
            continue
        key = (e["event"], e[field])
        if key not in out and isinstance(e.get("ts"), (int, float)):
            out[key] = float(e["ts"])
    return out


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    if not n:
        return 0.0
    mid = n // 2
    return xs[mid] if n % 2 else 0.5 * (xs[mid - 1] + xs[mid])


def align_clocks(shards):
    """Fill each shard's ``offset`` so ``ts + offset`` is comparable across
    shards. The reference clock is the lowest host id's shard; every other
    shard's offset is the median delta over shared anchors (0.0 when the
    shards share no anchors — disjoint runs merge unaligned rather than
    failing). Returns {shard: offset} for reporting."""
    if not shards:
        return {}
    ref = min(shards, key=lambda s: (s.host, s.label))
    ref_anchors = _anchors(ref)
    offsets = {}
    for s in shards:
        if s is ref:
            s.offset = 0.0
        else:
            mine = _anchors(s)
            deltas = [
                ref_anchors[k] - mine[k] for k in mine if k in ref_anchors
            ]
            s.offset = _median(deltas) if deltas else 0.0
        offsets[s] = s.offset
    return offsets


# ---- span pairing -----------------------------------------------------------


def pair_spans(shard):
    """Spans of one shard: begin/end pairs matched by span id, plus
    retroactive complete ``span`` events. Returns a list of dicts with
    aligned wall ``ts`` (seconds), ``dur_s``, ``name``, ``tid``, ``args``.
    An unpaired begin (the process died mid-span) is closed at the shard's
    last timestamp and flagged ``truncated`` — a torn trace is still a
    trace."""
    spans, open_spans = [], {}
    last_ts = max(
        (e["ts"] for e in shard.events if isinstance(e.get("ts"), (int, float))),
        default=0.0,
    )
    # monotonic→wall mapping for this shard: span_begin/span_end events are
    # emitted in-line, so their (ts − mono) IS the offset; retroactive
    # ``span`` events are emitted LATER than they began, so their delta
    # only overestimates — the minimum across all of them is the truth
    mono_base = min(
        (
            float(e["ts"]) - float(e["mono"])
            for e in shard.events
            if isinstance(e.get("ts"), (int, float))
            and isinstance(e.get("mono"), (int, float))
        ),
        default=None,
    )

    def args_of(e):
        return {
            k: v for k, v in e.items()
            if k not in ("event", "ts", "host", "name", "span", "parent",
                         "tid", "thread", "mono", "dur_s")
        }

    for e in shard.events:
        ev = e.get("event")
        if ev == "span_begin":
            open_spans[e.get("span")] = e
        elif ev == "span_end":
            b = open_spans.pop(e.get("span"), None)
            if b is None:
                continue  # end without begin (rotated-away shard head)
            if isinstance(e.get("mono"), (int, float)) and isinstance(
                b.get("mono"), (int, float)
            ):
                dur = max(e["mono"] - b["mono"], 0.0)
            else:
                dur = max(e.get("ts", 0.0) - b.get("ts", 0.0), 0.0)
            args = args_of(b)
            args.update(args_of(e))
            spans.append({
                "name": b.get("name", "?"),
                "ts": float(b.get("ts", 0.0)) + shard.offset,
                "dur_s": dur,
                "tid": b.get("tid", 0),
                "thread": b.get("thread"),
                "span": b.get("span"),
                "parent": b.get("parent"),
                "ok": e.get("ok", True),
                "args": args,
            })
        elif ev == "span":
            # retroactive span: ts stamps the EMIT time (a later sync
            # point), mono stamps the true BEGIN — map it back to wall via
            # the shard's mono→wall base so buffered steps land at the
            # times they actually ran (not stacked on the sync point)
            dur = float(e.get("dur_s", 0.0))
            if mono_base is not None and isinstance(
                e.get("mono"), (int, float)
            ):
                begin_wall = mono_base + float(e["mono"])
            else:
                begin_wall = float(e.get("ts", 0.0)) - dur
            spans.append({
                "name": e.get("name", "?"),
                "ts": begin_wall + shard.offset,
                "dur_s": dur,
                "tid": e.get("tid", 0),
                "thread": e.get("thread"),
                "span": e.get("span"),
                "parent": e.get("parent"),
                "ok": True,
                "args": args_of(e),
            })
    for b in open_spans.values():
        spans.append({
            "name": b.get("name", "?"),
            "ts": float(b.get("ts", 0.0)) + shard.offset,
            "dur_s": max(last_ts - b.get("ts", last_ts), 0.0),
            "tid": b.get("tid", 0),
            "thread": b.get("thread"),
            "span": b.get("span"),
            "parent": b.get("parent"),
            "ok": False,
            "args": {**args_of(b), "truncated": True},
        })
    return spans


# ---- Chrome trace export ----------------------------------------------------


def to_chrome_trace(shards, *, instants=True):
    """Chrome-trace-event JSON dict (``{"traceEvents": [...]}``) from the
    aligned shards — loadable in Perfetto / chrome://tracing."""
    events = []
    t_base = min(
        (
            float(e["ts"]) + s.offset
            for s in shards for e in s.events
            if isinstance(e.get("ts"), (int, float))
        ),
        default=0.0,
    )

    def us(wall_s):
        return max(round((wall_s - t_base) * 1e6), 0)

    for pid, shard in enumerate(shards):
        events.append({
            "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": f"host {shard.host} · {shard.label}"},
        })
        threads = {}
        for sp in pair_spans(shard):
            tid = sp["tid"] or 0
            if sp["thread"] and tid not in threads:
                threads[tid] = sp["thread"]
            events.append({
                "ph": "X", "pid": pid, "tid": tid, "cat": "span",
                "name": sp["name"], "ts": us(sp["ts"]),
                "dur": max(round(sp["dur_s"] * 1e6), 1),
                "args": {**sp["args"], "ok": sp["ok"]},
            })
        if instants:
            for e in shard.events:
                ev = e.get("event")
                if ev in ("span_begin", "span_end", "span") or not isinstance(
                    e.get("ts"), (int, float)
                ):
                    continue
                args = {
                    k: v for k, v in e.items()
                    if k not in ("event", "ts", "host")
                }
                events.append({
                    "ph": "i", "pid": pid, "tid": 0, "s": "t", "cat": "event",
                    "name": ev, "ts": us(float(e["ts"]) + shard.offset),
                    "args": args,
                })
        for tid, name in threads.items():
            events.append({
                "ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                "args": {"name": name},
            })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "tool": "pyrecover_tpu_torch traceview",
            "shards": [s.label for s in shards],
            "clock_offsets_s": {
                s.label: round(s.offset, 6) for s in shards
            },
        },
    }


# ---- analysis passes --------------------------------------------------------


def _wpercentile(samples, q):
    """Weighted percentile over [(value, weight)] samples."""
    if not samples:
        return None
    samples = sorted(samples)
    total = sum(w for _, w in samples)
    rank = q * total
    cum = 0.0
    for v, w in samples:
        cum += w
        if cum >= rank - 1e-12:
            return v
    return samples[-1][0]


def _host_step_samples(shard):
    """Per-step time samples for one shard: (step, iter_s, weight).
    Prefers the synced ``train_sync`` interval averages (honest device
    time); falls back to per-step host stamps (data_wait + dispatch) for
    streams with no sync events."""
    out = [
        (e["step"], float(e["iter_s"]), int(e.get("steps", 1)) or 1)
        for e in shard.events
        if e.get("event") == "train_sync"
        and isinstance(e.get("iter_s"), (int, float))
    ]
    if out:
        return out
    return [
        (
            e["step"],
            float(e.get("data_wait_s", 0.0)) + float(e.get("dispatch_s", 0.0)),
            1,
        )
        for e in shard.events
        if e.get("event") == "step_time"
    ]


def analyze_steps(shards, *, spike_factor=SPIKE_FACTOR,
                  spike_window=SPIKE_WINDOW):
    """Per-host step-time stats, straggler attribution, spike detection."""
    hosts = []
    for shard in shards:
        samples = _host_step_samples(shard)
        if not samples:
            continue
        weighted = [(v, w) for _, v, w in samples]
        n_steps = sum(w for _, w in weighted)
        hosts.append({
            "host": shard.host,
            "shard": shard.label,
            "steps": n_steps,
            "iter_s_p50": _wpercentile(weighted, 0.50),
            "iter_s_p95": _wpercentile(weighted, 0.95),
            "iter_s_p99": _wpercentile(weighted, 0.99),
            "iter_s_mean": sum(v * w for v, w in weighted) / max(n_steps, 1),
            "series": [(s, v) for s, v, _ in samples],
        })
    straggler = None
    if len(hosts) >= 2:
        slow = max(hosts, key=lambda h: h["iter_s_p50"])
        # median over the OTHER hosts: the straggler must not dilute its
        # own reference point (at 2 hosts it would halve the reported gap)
        med = _median([
            h["iter_s_p50"] for h in hosts if h is not slow
        ])
        if med > 0:
            delta_pct = 100.0 * (slow["iter_s_p50"] - med) / med
        else:
            delta_pct = 0.0
        straggler = {
            "host": slow["host"],
            "shard": slow["shard"],
            "iter_s_p50": slow["iter_s_p50"],
            "median_iter_s_p50": med,
            "delta_pct": round(delta_pct, 1),
        }
    spikes = []
    for h in hosts:
        window = []
        for step, v in h["series"]:
            if len(window) >= 3:
                base = _median(window)
                if (
                    v > spike_factor * base
                    and v - base > SPIKE_MIN_ABS_S
                ):
                    spikes.append({
                        "host": h["host"], "step": step,
                        "iter_s": round(v, 6),
                        "rolling_median_s": round(base, 6),
                        "factor": round(v / base, 2) if base > 0 else None,
                    })
            window.append(v)
            if len(window) > spike_window:
                window.pop(0)
    for h in hosts:
        h.pop("series")
        for k in ("iter_s_p50", "iter_s_p95", "iter_s_p99", "iter_s_mean"):
            if h[k] is not None:
                h[k] = round(h[k], 6)
    return {"hosts": hosts, "straggler": straggler, "spikes": spikes}


def analyze_ckpt_phases(shards):
    """Duration percentiles per checkpoint lifecycle phase (span names
    starting ``ckpt_``), keyed ``<engine>:<name>``."""
    durs = defaultdict(list)
    for shard in shards:
        for sp in pair_spans(shard):
            if not sp["name"].startswith("ckpt_"):
                continue
            engine = sp["args"].get("engine", "?")
            durs[f"{engine}:{sp['name']}"].append(sp["dur_s"])
    out = {}
    for key, xs in sorted(durs.items()):
        weighted = [(v, 1) for v in xs]
        out[key] = {
            "count": len(xs),
            "p50_s": round(_wpercentile(weighted, 0.50), 6),
            "p95_s": round(_wpercentile(weighted, 0.95), 6),
            "max_s": round(max(xs), 6),
            "total_s": round(sum(xs), 6),
        }
    return out


def diff_ckpt_baseline(phases, baseline, *, tolerance=REGRESSION_TOLERANCE):
    """Regressions of current phase p50s vs a stored baseline
    (``{phase_key: p50_s}``). A phase regresses when its p50 exceeds the
    baseline by BOTH the relative tolerance and an absolute floor (noise
    on sub-millisecond phases must not gate CI)."""
    regressions = []
    for key, base_p50 in sorted(baseline.items()):
        cur = phases.get(key)
        if cur is None:
            continue
        if (
            cur["p50_s"] > base_p50 * (1.0 + tolerance)
            and cur["p50_s"] - base_p50 > REGRESSION_MIN_ABS_S
        ):
            regressions.append({
                "phase": key,
                "baseline_p50_s": round(base_p50, 6),
                "p50_s": cur["p50_s"],
                "factor": round(cur["p50_s"] / base_p50, 2)
                if base_p50 > 0 else None,
            })
    return regressions


def analyze(shards, *, baseline=None, spike_factor=SPIKE_FACTOR,
            tolerance=REGRESSION_TOLERANCE):
    steps = analyze_steps(shards, spike_factor=spike_factor)
    phases = analyze_ckpt_phases(shards)
    report = {
        "shards": [
            {"label": s.label, "host": s.host, "events": len(s.events),
             "clock_offset_s": round(s.offset, 6)}
            for s in shards
        ],
        "step_times": steps,
        "ckpt_phases": phases,
    }
    if baseline is not None:
        report["regressions"] = diff_ckpt_baseline(
            phases, baseline, tolerance=tolerance
        )
    return report


def render_report(report, out=None):
    w = (out or sys.stdout).write
    w("traceview: %d shard(s)\n" % len(report["shards"]))
    for s in report["shards"]:
        w(f"  host {s['host']}  {s['label']}  {s['events']} events"
          f"  clock offset {s['clock_offset_s']:+.3f}s\n")
    hosts = report["step_times"]["hosts"]
    if hosts:
        w("\n-- per-host step times -----------------------------------------\n")
        for h in sorted(hosts, key=lambda h: h["host"]):
            w(f"  host {h['host']:<3} {h['steps']:>5} steps | iter p50 "
              f"{h['iter_s_p50'] * 1e3:8.2f}ms  p95 "
              f"{h['iter_s_p95'] * 1e3:8.2f}ms  p99 "
              f"{h['iter_s_p99'] * 1e3:8.2f}ms\n")
        st = report["step_times"]["straggler"]
        if st is not None:
            w(f"  STRAGGLER: host {st['host']} ({st['shard']}) — p50 "
              f"{st['iter_s_p50'] * 1e3:.2f}ms, {st['delta_pct']:+.1f}% vs "
              f"median host p50 {st['median_iter_s_p50'] * 1e3:.2f}ms\n")
    spikes = report["step_times"]["spikes"]
    if spikes:
        w(f"\n-- step-time spikes ({len(spikes)}, vs rolling median) ---------\n")
        for sp in spikes[:20]:
            w(f"  host {sp['host']} step {sp['step']}: "
              f"{sp['iter_s'] * 1e3:.2f}ms = {sp['factor']}x the rolling "
              f"median {sp['rolling_median_s'] * 1e3:.2f}ms\n")
        if len(spikes) > 20:
            w(f"  ... {len(spikes) - 20} more (see --report-json)\n")
    if report["ckpt_phases"]:
        w("\n-- checkpoint phases -------------------------------------------\n")
        for key, ph in report["ckpt_phases"].items():
            w(f"  {key:<32} x{ph['count']:<4} p50 {ph['p50_s']:.4f}s  "
              f"p95 {ph['p95_s']:.4f}s  max {ph['max_s']:.4f}s\n")
    for r in report.get("regressions", []):
        w(f"\n  REGRESSION: {r['phase']} p50 {r['p50_s']:.4f}s is "
          f"{r['factor']}x the baseline {r['baseline_p50_s']:.4f}s\n")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="merge per-host telemetry shards into a Perfetto trace "
                    "+ straggler/spike/ckpt-phase analysis",
    )
    p.add_argument("shards", nargs="+", help="telemetry JSONL shard(s)")
    p.add_argument("--out", default=None,
                   help="write Chrome-trace-event JSON here (open in "
                        "https://ui.perfetto.dev or chrome://tracing)")
    p.add_argument("--report-json", default=None,
                   help="write the analysis report as JSON here")
    p.add_argument("--baseline", default=None,
                   help="checkpoint-phase baseline JSON ({phase: p50_s}); "
                        "regressions beyond --regression-tolerance exit 1")
    p.add_argument("--write-baseline", default=None,
                   help="write the current checkpoint-phase p50s as a "
                        "baseline JSON")
    p.add_argument("--spike-factor", type=float, default=SPIKE_FACTOR,
                   help="rolling-median multiple that flags a step-time "
                        "spike (default %(default)s)")
    p.add_argument("--regression-tolerance", type=float,
                   default=REGRESSION_TOLERANCE,
                   help="relative p50 growth tolerated before a phase "
                        "regression gates (default %(default)s)")
    p.add_argument("--no-instants", action="store_true",
                   help="export spans only (smaller trace JSON)")
    args = p.parse_args(argv)

    shards = load_shards(args.shards)
    if not shards:
        print("error: no telemetry events readable from any shard",
              file=sys.stderr)
        return 2
    align_clocks(shards)

    baseline = None
    if args.baseline:
        baseline = json.loads(Path(args.baseline).read_text())
    report = analyze(
        shards, baseline=baseline, spike_factor=args.spike_factor,
        tolerance=args.regression_tolerance,
    )

    if args.out:
        trace = to_chrome_trace(shards, instants=not args.no_instants)
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        # a trace artifact for Perfetto: a torn trace fails json.load and is
        # exported again
        out.write_text(json.dumps(trace))
        print(f"wrote {out} ({len(trace['traceEvents'])} trace events) — "
              "open in https://ui.perfetto.dev", file=sys.stderr)
    if args.write_baseline:
        base = {
            key: ph["p50_s"] for key, ph in report["ckpt_phases"].items()
        }
        # an operator-invoked baseline, committed only after review
        Path(args.write_baseline).write_text(json.dumps(base, indent=2))
        print(f"wrote baseline {args.write_baseline}", file=sys.stderr)
    if args.report_json:
        # a report artifact, written anew every run; a torn report fails its
        # reader loudly
        Path(args.report_json).write_text(json.dumps(report, indent=2))

    render_report(report)
    if report.get("regressions"):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
