"""traceassembly: stitch per-process telemetry shards into rooted
per-request trace trees with skew-corrected critical-path attribution (the
JAX package's ``telemetry/traceassembly.py``). The router's ``trace_root`` /
``trace_exemplar`` and the ``fleet_send`` / ``fleet_recv`` wire markers come
from the serving fleet (``serving/fleet/``, either package's: they write
the same format); without them one engine's stream assembles each traced
request's spans in one clock domain.

The serving fleet leaves one request's evidence in several files: the
router process records admission (``trace_root``), the wire markers on
its side of the socket (``fleet_send``/``fleet_recv``), and the
retroactive ``fleet_attempt``/``req_root`` spans; each replica
subprocess records its own socket-edge markers plus the engine's
``req_queue``/``req_prefill``/``req_decode`` (and ``swap_stall``)
spans. Those processes run on genuinely different clocks — a replica's
``time.monotonic()`` shares no epoch with the router's, and wall clocks
step under NTP. This module reassembles anyway:

* **Clock domains** — each shard file is one domain; a merged drill
  file (records tagged ``replica`` by ``drill._merge_shards``) splits
  into one parent domain plus one domain per replica tag. The parent
  domain is the one carrying ``trace_root`` events.
* **Symmetric skew alignment** — the wire markers double as anchor
  pairs keyed ``(trace, attempt, kind)``. A submit leg bounds the
  offset from below (``send`` happens before ``recv``:
  ``send − recv = offset − wire``), a done leg bounds it from above
  (``recv − send = offset + wire``); the per-domain offset is the mean
  of the two median bounds, which cancels wire latency NTP-style and —
  because it is computed on MONOTONIC stamps — is immune to wall-clock
  steps entirely. Fallback chain when a domain has no markers: the
  shared wall anchors :mod:`traceview` aligns training shards with
  (mapped onto the mono timeline via each domain's ``min(ts − mono)``
  base), then 0.0.
* **Tree assembly** — spans carrying a ``trace`` field group per trace
  id; trace-scoped string span ids (``<trace>:r``, ``<trace>:a<N>``)
  are global, process-local integer ids are scoped to their domain (two
  replicas both count from 1). A span attaches when its parent chain
  reaches the root; anything else is an **orphan** — counted, named,
  never dropped. A ``trace_root`` event with no ``req_root`` span
  (a shed request) still roots a tree.
* **Critical-path buckets** — per completed trace, on the aligned
  parent-mono timeline (``e2e`` is the router's own submit→done mono
  interval, exact by construction):

  - ``route``     admission → first wire send (router queue + dispatch)
  - ``redrive_gap`` dispatch of attempt k → dispatch of attempt k+1,
    summed over failed attempts: the whole kill-to-redispatch hole
  - ``wire``      socket transit, final attempt (submit leg + done leg,
    skew-corrected, clamped ≥ 0)
  - ``queue`` / ``prefill`` / ``decode`` engine spans of the final
    attempt (mono durations, exact); ``decode`` has the stall carved
    out so buckets do not double-count:
  - ``swap_stall`` hot-swap flip windows overlapping the request
  - ``residual``  ``e2e − Σ(above)`` — completer poll latency, engine
    admission gap, skew-estimation error, and clamping slack land
    here, NAMED, never silently dropped.

  The named tolerance: a complete trace (both replica-side markers
  present for its final attempt) must keep ``|residual| ≤
  max(RESIDUAL_TOLERANCE_FRAC · e2e, RESIDUAL_TOLERANCE_ABS_S)``.
* **Tail-based exemplar retention** — full trees are kept only for
  traces the router marked ``trace_exemplar`` (every redriven and shed
  request plus the p99-slowest); when no marks exist (a run that never
  drained) the p99 tail is recomputed here. Everything else is
  counts-only in the report.

CLI (``python -m pyrecover_tpu_torch.telemetry.traceassembly``, the
counterpart of the JAX package's ``tools/tracepath.py``)::

    python -m pyrecover_tpu_torch.telemetry.traceassembly shards/*.jsonl --top 5 \
        --json report.json
    python -m pyrecover_tpu_torch.telemetry.traceassembly merged.jsonl --expect-complete

Exit codes: 0 = assembled, 1 = ``--expect-complete`` violated (orphan
spans, nothing assembled, or a complete trace outside the residual
tolerance), 2 = no trace events in any shard.
"""

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

from pyrecover_tpu_torch.telemetry import traceview
from pyrecover_tpu_torch.telemetry.sinks import read_events

RESIDUAL_TOLERANCE_FRAC = 0.25
RESIDUAL_TOLERANCE_ABS_S = 0.20

BUCKETS = ("route", "redrive_gap", "wire", "queue", "prefill", "decode",
           "swap_stall", "residual")

_ENGINE_BUCKET = {
    "req_queue": "queue", "req_prefill": "prefill", "req_decode": "decode",
}
# marker side is a property of (event, kind) — the router only ever
# emits the submit-send / done-recv halves, the replica the other two
_PARENT_MARKS = {("fleet_send", "submit"): "send_submit",
                 ("fleet_recv", "done"): "recv_done"}
_REPLICA_MARKS = {("fleet_recv", "submit"): "recv_submit",
                  ("fleet_send", "done"): "send_done"}


class Domain:
    """One process clock domain: the events of one shard file, or one
    ``replica``-tagged slice of a merged drill file."""

    def __init__(self, label, events):
        self.label = label
        self.events = events
        self.offset = 0.0       # mono correction onto the parent clock
        self.offset_src = "parent"

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Domain({self.label!r}, {len(self.events)} events)"


def split_events(events, label="telemetry"):
    """Split one event stream into clock domains by the ``replica`` tag
    ``drill._merge_shards`` stamps onto replica-shard records. Untagged
    records form the parent domain; a stream with no tags is a single
    domain. (A stray tagged record that is neither span nor marker —
    a supervisor event naming a replica — costs nothing: domains only
    contribute through their spans and markers.)"""
    groups = defaultdict(list)
    for e in events:
        groups[e.get("replica")].append(e)
    domains = []
    for tag in sorted(groups, key=lambda t: (t is not None, str(t))):
        sub = f"{label}[r{tag}]" if tag is not None else label
        domains.append(Domain(sub, groups[tag]))
    return domains


def load_domains(paths):
    """Read every shard (rotation-aware), splitting merged files into
    their clock domains. Empty shards are dropped with a note."""
    domains = []
    for p in paths:
        events = read_events(p)
        if not events:
            print(f"tracepath: no events in {p}; skipping", file=sys.stderr)
            continue
        domains.extend(split_events(events, label=Path(p).name))
    return domains


# ---- skew alignment ---------------------------------------------------------


def _markers(domain):
    """Wire markers of one domain: {(trace, attempt, leg): mono}. The
    leg name encodes the side, so misclassification is impossible even
    when parent and replica records share a file."""
    out = {}
    for e in domain.events:
        key = (e.get("event"), e.get("kind"))
        leg = _PARENT_MARKS.get(key) or _REPLICA_MARKS.get(key)
        if leg is None or "trace" not in e:
            continue
        if not isinstance(e.get("mono"), (int, float)):
            continue
        out.setdefault((e["trace"], e.get("attempt", 1), leg),
                       float(e["mono"]))
    return out


def _mono_base(domain):
    """min(ts − mono) over the domain: the wall epoch of its monotonic
    clock (inline emits give the true value; buffered emits only ever
    overestimate, so the minimum is the honest one)."""
    return min(
        (
            float(e["ts"]) - float(e["mono"])
            for e in domain.events
            if isinstance(e.get("ts"), (int, float))
            and isinstance(e.get("mono"), (int, float))
        ),
        default=None,
    )


def pick_parent(domains):
    """The parent (reference-clock) domain: the one that recorded
    admission (``trace_root``); ties and trace-free merges fall back to
    parent-side markers, then the first domain."""
    def score(d):
        roots = sum(1 for e in d.events if e.get("event") == "trace_root")
        marks = sum(
            1 for e in d.events
            if (e.get("event"), e.get("kind")) in _PARENT_MARKS
        )
        return (roots, marks)

    if not domains:
        return None
    best = max(domains, key=score)
    return best if score(best) > (0, 0) else domains[0]


def align_domains(domains, parent):
    """Fill each domain's mono ``offset`` onto the parent clock from the
    symmetric marker legs; falls back to traceview's shared wall
    anchors, then 0.0. Returns {label: offset} for reporting."""
    parent_marks = {}
    for d in domains:
        for (tid, att, leg), mono in _markers(d).items():
            if leg in ("send_submit", "recv_done"):
                parent_marks.setdefault((tid, att, leg), mono)
    parent_anchors = traceview._anchors(parent)
    parent_base = _mono_base(parent)
    offsets = {}
    for d in domains:
        if d is parent:
            d.offset, d.offset_src = 0.0, "parent"
            offsets[d.label] = 0.0
            continue
        lo, hi = [], []
        for (tid, att, leg), mono in _markers(d).items():
            if leg == "recv_submit":
                send = parent_marks.get((tid, att, "send_submit"))
                if send is not None:
                    lo.append(send - mono)   # = offset − wire
            elif leg == "send_done":
                recv = parent_marks.get((tid, att, "recv_done"))
                if recv is not None:
                    hi.append(recv - mono)   # = offset + wire
        if lo and hi:
            d.offset = 0.5 * (traceview._median(lo) + traceview._median(hi))
            d.offset_src = "markers"
        elif lo or hi:
            d.offset = traceview._median(lo or hi)
            d.offset_src = "markers-oneway"
        else:
            mine = traceview._anchors(d)
            deltas = [
                parent_anchors[k] - mine[k]
                for k in mine if k in parent_anchors
            ]
            base = _mono_base(d)
            if deltas and base is not None and parent_base is not None:
                # wall offset → mono offset via each domain's wall epoch
                d.offset = base - parent_base + traceview._median(deltas)
                d.offset_src = "wall-anchors"
            else:
                d.offset = 0.0
                d.offset_src = "unaligned"
        offsets[d.label] = d.offset
    return offsets


# ---- span extraction + tree assembly ----------------------------------------


def _key(domain, sid):
    """Node key: trace-scoped string ids are global, process-local
    integer ids collide across domains and get the domain prefix."""
    if sid is None:
        return None
    return sid if isinstance(sid, str) else f"{domain.label}#{sid}"


def _extract_spans(domain):
    """Trace-carrying spans of one domain on the aligned timeline:
    retroactive ``span`` events plus ``span_begin``/``span_end`` pairs
    (an unpaired begin — the process died mid-span — closes at the
    domain's last mono stamp, flagged ``truncated``)."""
    spans, open_spans = [], {}
    last_mono = max(
        (e["mono"] for e in domain.events
         if isinstance(e.get("mono"), (int, float))),
        default=0.0,
    )

    def node(e, mono, dur, **extra):
        return {
            "name": e.get("name", "?"),
            "key": _key(domain, e.get("span")),
            "parent": _key(domain, e.get("parent")),
            "trace": e["trace"],
            "attempt": e.get("attempt", 1),
            "rid": e.get("rid"),
            "t0": float(mono) + domain.offset,
            "dur_s": float(dur),
            "ok": e.get("ok", True),
            "domain": domain.label,
            # attribution inputs the router stamps onto req_root
            "attempts": e.get("attempts"),
            "redrives": e.get("redrives"),
            **extra,
        }

    for e in domain.events:
        ev = e.get("event")
        if "trace" not in e:
            continue
        if ev == "span_begin":
            open_spans[e.get("span")] = e
        elif ev == "span_end":
            b = open_spans.pop(e.get("span"), None)
            if b is None:
                continue
            dur = max(float(e.get("mono", 0.0)) - float(b.get("mono", 0.0)),
                      0.0)
            spans.append(node(b, b.get("mono", 0.0), dur,
                              ok=e.get("ok", True)))
        elif ev == "span":
            spans.append(node(e, e.get("mono", 0.0), e.get("dur_s", 0.0)))
    for b in open_spans.values():
        mono = float(b.get("mono", last_mono))
        spans.append(node(b, mono, max(last_mono - mono, 0.0),
                          ok=False, truncated=True))
    return spans


def _clamp(x):
    return max(float(x), 0.0)


def _attribute(root, marks, trace_spans):
    """Critical-path buckets for one completed trace (see module
    docstring); every bucket in parent-mono seconds, residual named."""
    e2e = root["dur_s"]
    t0 = root["t0"]
    attempts = int(root.get("attempts", 1) or 1)
    b = dict.fromkeys(BUCKETS, 0.0)
    sends = {
        att: marks.get((att, "send_submit")) for att in range(1, attempts + 1)
    }
    if sends.get(1) is not None:
        b["route"] = _clamp(sends[1] - t0)
    for att in range(1, attempts):
        if sends.get(att) is not None and sends.get(att + 1) is not None:
            b["redrive_gap"] += _clamp(sends[att + 1] - sends[att])
    final = attempts
    recv_sub = marks.get((final, "recv_submit"))
    send_done = marks.get((final, "send_done"))
    recv_done = marks.get((final, "recv_done"))
    if sends.get(final) is not None and recv_sub is not None:
        b["wire"] += _clamp(recv_sub - sends[final])
    if send_done is not None and recv_done is not None:
        b["wire"] += _clamp(recv_done - send_done)
    for sp in trace_spans:
        if sp.get("attempt") != final:
            continue
        bucket = _ENGINE_BUCKET.get(sp["name"])
        if bucket is not None:
            b[bucket] += sp["dur_s"]
        elif sp["name"] == "swap_stall":
            b["swap_stall"] += sp["dur_s"]
    # the flip window sits INSIDE the decode span; carve it out so the
    # stall is attributed once, not twice
    b["decode"] = _clamp(b["decode"] - b["swap_stall"])
    accounted = sum(v for k, v in b.items() if k != "residual")
    b["residual"] = e2e - accounted
    complete = recv_sub is not None and send_done is not None
    tol = max(RESIDUAL_TOLERANCE_FRAC * e2e, RESIDUAL_TOLERANCE_ABS_S)
    return {
        "e2e_s": round(e2e, 6),
        "buckets": {k: round(v, 6) for k, v in b.items()},
        "dominant": max(BUCKETS, key=lambda k: b[k]),
        "attempts": attempts,
        "redrives": int(root.get("redrives", 0) or 0),
        "complete": complete,
        "residual_ok": abs(b["residual"]) <= tol,
        "residual_tolerance_s": round(tol, 6),
    }


def assemble(domains):
    """Assemble rooted per-request trace trees across the aligned
    domains; returns the full report dict (see ``render``)."""
    parent = pick_parent(domains)
    align_domains(domains, parent)

    all_spans = []
    marks = defaultdict(dict)     # trace -> {(attempt, leg): aligned mono}
    roots_ev = {}                 # trace -> trace_root event
    exemplar_ev = {}              # trace -> trace_exemplar event
    for d in domains:
        all_spans.extend(_extract_spans(d))
        for (tid, att, leg), mono in _markers(d).items():
            mapped = mono if leg in ("send_submit", "recv_done") \
                else mono + d.offset
            marks[tid].setdefault((att, leg), mapped)
        for e in d.events:
            if e.get("event") == "trace_root" and "trace" in e:
                roots_ev.setdefault(e["trace"], e)
            elif e.get("event") == "trace_exemplar" and e.get("trace"):
                exemplar_ev.setdefault(e["trace"], e)

    by_trace = defaultdict(list)
    for sp in all_spans:
        by_trace[sp["trace"]].append(sp)
    for tid in roots_ev:
        by_trace.setdefault(tid, [])

    per_trace, orphans = {}, []
    for tid, spans in sorted(by_trace.items()):
        root_key = f"{tid}:r"
        nodes = {}
        for sp in spans:
            nodes.setdefault(sp["key"], sp)
        root = nodes.get(root_key)
        if root is None and tid in roots_ev:
            ev = roots_ev[tid]
            root = {
                "name": "req_root", "key": root_key, "parent": None,
                "trace": tid, "rid": ev.get("rid"), "attempt": 0,
                "t0": float(ev.get("mono", 0.0)), "dur_s": 0.0,
                "ok": True, "domain": parent.label if parent else "?",
                "synthetic": True,
            }
            nodes[root_key] = root
        children = defaultdict(list)
        for key, sp in nodes.items():
            if key != root_key:
                children[sp["parent"]].append(key)
        reachable = set()
        frontier = [root_key] if root is not None else []
        while frontier:
            key = frontier.pop()
            if key in reachable:
                continue
            reachable.add(key)
            frontier.extend(children.get(key, ()))
        lost = [nodes[k] for k in sorted(set(nodes) - reachable,
                                         key=str)]
        orphans.extend(lost)

        entry = {
            "trace": tid,
            "rid": (root or {}).get("rid"),
            "spans": len(nodes),
            "rooted": root is not None,
            "orphan_spans": len(lost),
            "verdict": roots_ev.get(tid, {}).get("verdict"),
        }
        if root is not None and not root.get("synthetic"):
            entry.update(_attribute(root, marks.get(tid, {}),
                                    [nodes[k] for k in reachable]))
        per_trace[tid] = (entry, [nodes[k] for k in sorted(reachable,
                                                           key=str)])

    completed = {t: e for t, (e, _) in per_trace.items() if "e2e_s" in e}

    # tail-based retention: router marks win; a run that never drained
    # falls back to the p99 recomputed here
    exemplars = {
        tid: {"reason": ev.get("reason"), "rid": ev.get("rid"),
              "e2e_s": ev.get("e2e_s")}
        for tid, ev in exemplar_ev.items() if tid in per_trace
    }
    if not exemplars and completed:
        vals = sorted(e["e2e_s"] for e in completed.values())
        p99 = vals[min(len(vals) - 1, int(0.99 * len(vals)))]
        for tid, e in completed.items():
            if e["e2e_s"] >= p99:
                exemplars[tid] = {"reason": "p99_tail", "rid": e["rid"],
                                  "e2e_s": e["e2e_s"]}

    bucket_stats = {}
    for bucket in BUCKETS:
        samples = [(e["buckets"][bucket], 1) for e in completed.values()]
        if samples:
            bucket_stats[bucket] = {
                "p50_s": round(traceview._wpercentile(samples, 0.50), 6),
                "p99_s": round(traceview._wpercentile(samples, 0.99), 6),
                "total_s": round(sum(v for v, _ in samples), 6),
            }
    tail = [completed[t] for t in exemplars if t in completed]
    tail_totals = defaultdict(float)
    for e in tail:
        for bucket, v in e["buckets"].items():
            tail_totals[bucket] += v
    dominant_tail = (max(tail_totals, key=lambda k: tail_totals[k])
                     if tail_totals else None)

    violations = [
        {"trace": t, "rid": e["rid"], "residual_s": e["buckets"]["residual"],
         "tolerance_s": e["residual_tolerance_s"], "e2e_s": e["e2e_s"]}
        for t, e in sorted(completed.items())
        if e["complete"] and not e["residual_ok"]
    ]

    report = {
        "domains": [
            {"label": d.label, "events": len(d.events),
             "parent": d is parent,
             "clock_offset_s": round(d.offset, 6),
             "offset_source": d.offset_src}
            for d in domains
        ],
        "traces": {
            "assembled": len(per_trace),
            "rooted": sum(1 for e, _ in per_trace.values() if e["rooted"]),
            "completed": len(completed),
            "orphan_spans": len(orphans),
            "root_only": sum(
                1 for e, _ in per_trace.values()
                if e["rooted"] and "e2e_s" not in e),
        },
        "buckets": bucket_stats,
        "dominant_tail_bucket": dominant_tail,
        "residual_violations": violations,
        "per_trace": {t: e for t, (e, _) in sorted(per_trace.items())},
        "exemplars": {
            tid: {
                **info,
                "tree": [
                    {k: sp.get(k) for k in
                     ("name", "key", "parent", "t0", "dur_s", "ok",
                      "attempt", "domain")}
                    for sp in sorted(per_trace[tid][1],
                                     key=lambda s: (s["t0"], str(s["key"])))
                ],
            }
            for tid, info in sorted(exemplars.items())
        },
        "orphans": [
            {k: sp.get(k) for k in
             ("name", "key", "parent", "trace", "domain", "attempt")}
            for sp in orphans
        ],
    }
    return report


def assemble_events(events, label="telemetry"):
    """Assemble straight from one in-memory event list (the summarizer
    path over a merged drill file)."""
    return assemble(split_events(events, label=label))


def has_trace_events(events):
    return any(
        e.get("event") in ("trace_root", "fleet_send", "fleet_recv")
        or (e.get("event") in ("span", "span_begin") and "trace" in e)
        for e in events
    )


# ---- rendering --------------------------------------------------------------


def render(report, out=None, top=5):
    w = (out or sys.stdout).write
    t = report["traces"]
    w("tracepath: %d domain(s), %d trace(s) assembled "
      "(%d completed, %d root-only), %d orphan span(s)\n"
      % (len(report["domains"]), t["assembled"], t["completed"],
         t["root_only"], t["orphan_spans"]))
    for d in report["domains"]:
        role = "parent" if d["parent"] else d["offset_source"]
        w(f"  {d['label']:<40} {d['events']:>6} events  "
          f"offset {d['clock_offset_s']:+.6f}s  [{role}]\n")
    if report["buckets"]:
        w("\n-- critical-path attribution (per completed request) ----------\n")
        for bucket in BUCKETS:
            st = report["buckets"].get(bucket)
            if st is None:
                continue
            w(f"  {bucket:<12} p50 {st['p50_s'] * 1e3:9.2f}ms  "
              f"p99 {st['p99_s'] * 1e3:9.2f}ms  "
              f"total {st['total_s']:8.3f}s\n")
        if report["dominant_tail_bucket"]:
            w(f"  tail exemplars dominated by: "
              f"{report['dominant_tail_bucket']}\n")
    completed = [e for e in report["per_trace"].values() if "e2e_s" in e]
    slowest = sorted(completed, key=lambda e: -e["e2e_s"])[:top]
    if slowest:
        w(f"\n-- slowest {len(slowest)} request(s) --------------------------"
          "------------\n")
        for e in slowest:
            parts = "  ".join(
                f"{k} {e['buckets'][k] * 1e3:.1f}ms"
                for k in BUCKETS if abs(e["buckets"][k]) > 1e-9
            )
            w(f"  rid {e['rid']}  e2e {e['e2e_s'] * 1e3:9.2f}ms  "
              f"attempts {e['attempts']}  dominant {e['dominant']}\n"
              f"    {parts}\n")
    if report["exemplars"]:
        by_reason = defaultdict(int)
        for info in report["exemplars"].values():
            by_reason[info["reason"]] += 1
        kinds = ", ".join(
            f"{n} {r}" for r, n in sorted(by_reason.items()))
        w(f"\n  exemplar trees retained: {len(report['exemplars'])} "
          f"({kinds}); counts-only for the other "
          f"{t['assembled'] - len(report['exemplars'])}\n")
    for v in report["residual_violations"]:
        w(f"  RESIDUAL: rid {v['rid']} residual {v['residual_s']:+.4f}s "
          f"exceeds ±{v['tolerance_s']:.4f}s of e2e {v['e2e_s']:.4f}s\n")
    for o in report["orphans"][:10]:
        w(f"  ORPHAN: {o['name']} ({o['key']}) in {o['domain']} — parent "
          f"{o['parent']!r} unreachable from trace {o['trace']} root\n")
    if len(report["orphans"]) > 10:
        w(f"  ... {len(report['orphans']) - 10} more orphans (see --json)\n")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="reassemble cross-process request traces: skew-"
                    "corrected trees + critical-path attribution",
    )
    p.add_argument("shards", nargs="+", help="telemetry JSONL shard(s); "
                   "a merged drill file splits into clock domains")
    p.add_argument("--json", default=None,
                   help="write the full report as JSON here")
    p.add_argument("--top", type=int, default=5,
                   help="slowest traces to print (default %(default)s)")
    p.add_argument("--expect-complete", action="store_true",
                   help="exit 1 unless every span attached (zero "
                        "orphans), at least one trace assembled, and "
                        "every complete trace is inside the residual "
                        "tolerance — the CI gate")
    args = p.parse_args(argv)

    domains = load_domains(args.shards)
    if not domains or not any(has_trace_events(d.events) for d in domains):
        print("error: no trace events readable from any shard",
              file=sys.stderr)
        return 2
    report = assemble(domains)
    if args.json:
        out = Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        # a report artifact, written anew every run; a torn report fails
        # its reader loudly
        out.write_text(json.dumps(report, indent=2))
    render(report, top=args.top)
    if args.expect_complete:
        t = report["traces"]
        if (t["assembled"] == 0 or t["orphan_spans"] > 0
                or report["residual_violations"]):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
