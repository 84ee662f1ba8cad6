"""``doctor`` — classify why a run died (or silently degraded) from artifacts
(the JAX package's ``telemetry/doctor.py``: the same classes, phases, exit
codes and OOM pattern, so both packages' doctors give one verdict on either
package's artifacts).

    python -m pyrecover_tpu_torch.telemetry.doctor <exp_dir|bundle|jsonl> \
        [--expect CLASS] [--json REPORT.json]

Input: a postmortem bundle, an experiment directory (telemetry JSONL +
``.postmortem/`` + REQUEUE/DONE markers), or a bare telemetry JSONL.
Output: one classification —

    healthy           finished (or cleanly stopped) with no detector hits
    hang              the run-health watchdog saw a no-progress window
    crash             unhandled exception, fatal signal, or a stream that
                      ends without a run_summary (hard kill)
    preemption        deadline/notice stop or the SIGTERM-escalation exit
    oom               the crash is a memory exhaustion (exception text or
                      HBM peak at/over budget)
    mesh_mismatch     the restore was refused for topology reasons — a
                      TopologyMismatchError (--elastic-resume off) or every
                      candidate rejected by the elastic preflight (SC11/SC05)
    platform_fallback the run executed on CPU when an accelerator was
                      expected (probe fallback / $PYRECOVER_EXPECT_ACCELERATOR)
    recompile_storm   repeated train-step retraces silently ate throughput
    unknown           no readable evidence

— plus the PHASE the run was in, named from the spans still open at death
(bundle ``open_spans.json``, else unpaired ``span_begin`` events at the
end of the stream): ``loader_wait``, ``ckpt_write``, ``eval``, ``resume``…

Only the LAST run segment (after the newest ``run_start``) drives the
classification — an interrupt/resume chain carries earlier kills by
design; what matters is how the newest attempt ended. Earlier-segment
signals surface as findings, not the verdict.

Exit codes: 0 healthy · 1 a failure class was identified · 2 no evidence
· 3 ``--expect CLASS`` given and the classification differs (the CI-gate
mode). Pure stdlib + the telemetry read-back — no torch, runs anywhere.
A stream that carries request trace context is reassembled through
``traceassembly`` into the report's ``tracing`` evidence.
"""

import argparse
import json
import re
import sys
from pathlib import Path

from pyrecover_tpu_torch.telemetry import flight
from pyrecover_tpu_torch.telemetry.sinks import read_events

CLASSES = (
    "healthy", "hang", "crash", "preemption", "oom", "mesh_mismatch",
    "platform_fallback", "recompile_storm", "unknown",
)

# The doctor's observability contract, spelled once. Every event name the
# classifier keys on, mapped to the non-envelope fields it reads off that
# event (() = presence/count only). obscheck parses this exact table as
# declarative consumer reads, so an event renamed at its emit site — or a
# field dropped from its kwargs — fails the static gate (OB01/OB03)
# instead of silently degrading a postmortem verdict to `unknown`. The
# classifier routes its own counter lookups through ``_count`` below, so
# a name used in code but missing here fails loudly in tests too.
EVENT_DEPS = {
    "run_start": (),
    "run_summary": ("status", "step", "hbm_peak_pct"),
    "span_begin": ("span", "name", "phase"),
    "span_end": ("span",),
    "recompile": (),
    "implicit_transfer": (),
    "platform_fallback": ("reason",),
    "topology_mismatch": ("reason",),
    "elastic_preflight_failed": ("reason",),
    "elastic_resume": ("resharded_leaves", "target_topology"),
    "distributed_wait_timeout": ("phase", "timeout_s"),
    "hang_detected": ("silent_s",),
    "preempt_signal_escalation": (),
    "preempt_stop": ("reason",),
    "slo_alert": ("rule", "kind", "threshold", "state", "value"),
}

# span names whose open-at-death presence changes the verdict
SPAN_DEPS = ("collective_wait",)


def _count(counts, name):
    """Counter lookup gated on the declared contract: a classifier that
    keys on an event absent from EVENT_DEPS is a bug, not a zero."""
    if name not in EVENT_DEPS:
        raise KeyError(f"event {name!r} not declared in doctor.EVENT_DEPS")
    return counts.get(name, 0)


DEFAULT_RECOMPILE_STORM = 3

_OOM_RE = re.compile(
    r"RESOURCE_EXHAUSTED|out of memory|OutOfMemory|\bOOM\b|MemoryError"
    r"|[Aa]llocat\w* .{0,40}(failed|exhausted)",
)


# ---- evidence gathering -----------------------------------------------------

def _find_telemetry(root):
    """The base (un-rotated) telemetry JSONL under an experiment dir."""
    cands = sorted(root.glob("*telemetry*.jsonl")) or sorted(
        p for p in root.glob("*.jsonl") if not p.name.startswith(".")
    )
    return cands[0] if cands else None


def _read_marker(root):
    for name, done in (("DONE", True), ("REQUEUE", False)):
        p = root / name
        if p.exists():
            try:
                payload = json.loads(p.read_text())
                if isinstance(payload, dict):
                    payload.setdefault("done", done)
                    return payload
            except (OSError, ValueError):
                pass
            return {"done": done}
    return None


def _load_bundle(path):
    out = {"path": str(path), "manifest": {}, "open_spans": []}
    try:
        out["manifest"] = json.loads((path / flight.MANIFEST_NAME).read_text())
    except (OSError, ValueError):
        return None
    try:
        out["open_spans"] = json.loads((path / "open_spans.json").read_text())
    except (OSError, ValueError):
        pass
    return out


def gather(target):
    """Collect every readable artifact for ``target`` into one evidence
    dict (``None`` values where an artifact is absent)."""
    target = Path(target)
    ev = {
        "source": str(target),
        "telemetry_path": None,
        "events": [],
        "bundles": [],
        "fatal_stacks": False,
        "marker": None,
        "interrupt_history": None,
    }
    if target.is_file():  # a bare telemetry JSONL
        ev["telemetry_path"] = str(target)
        ev["events"] = read_events(target)
        root = target.parent
    else:
        root = target
        if (target / flight.MANIFEST_NAME).is_file():  # a single bundle
            root = target.parent.parent  # bundle -> .postmortem -> exp_dir
        elif target.name == flight.POSTMORTEM_DIRNAME:
            root = target.parent
        tele = _find_telemetry(root)
        if tele is not None:
            ev["telemetry_path"] = str(tele)
            ev["events"] = read_events(tele)
    bundles = [b for p in (target, root) for b in flight.list_bundles(p)]
    seen = set()
    ev["bundles"] = [
        b for b in bundles
        if not (str(b) in seen or seen.add(str(b)))
    ]
    fatal_root = root / flight.POSTMORTEM_DIRNAME
    try:
        stem = flight.FATAL_STACKS_NAME.rsplit(".", 1)[0]
        ev["fatal_stacks"] = any(
            p.is_file() and p.stat().st_size > 0
            for p in fatal_root.glob(stem + "*")
        )
    except OSError:
        pass
    if root.is_dir():
        ev["marker"] = _read_marker(root)
        # goodput-autopilot failure-history sidecar: the run's own record
        # of every interruption over the resume chain (kinds + steps) —
        # tolerant read, same policy as the markers
        sidecar = root / "failure_history.json"
        if sidecar.is_file():
            try:
                doc = json.loads(sidecar.read_text())
                if isinstance(doc, dict) and isinstance(
                    doc.get("interruptions"), list
                ):
                    ev["interrupt_history"] = doc
            except (OSError, ValueError):
                pass
    return ev


# ---- last-segment analysis --------------------------------------------------

def _last_segment(events):
    start = 0
    for i, e in enumerate(events):
        if e.get("event") == "run_start":
            start = i
    return events[start:]


def _open_span_records(events):
    """span_begin records never matched by a span_end, ordered
    outermost→innermost (span ids are process-monotonic)."""
    open_ = {}
    for e in events:
        name = e.get("event")
        if name == "span_begin":
            open_[e.get("span")] = e
        elif name == "span_end":
            open_.pop(e.get("span"), None)
    return sorted(open_.values(), key=lambda r: r.get("span") or 0)


def analyze(evidence, *, recompile_storm_threshold=DEFAULT_RECOMPILE_STORM):
    """Classify. Returns the report dict (see module docstring)."""
    events = evidence["events"]
    bundles = [
        b for b in (
            _load_bundle(Path(p)) for p in evidence["bundles"]
        ) if b is not None
    ]
    newest_bundle = bundles[-1] if bundles else None
    seg = _last_segment(events)
    counts = {}
    for e in seg:
        counts[e.get("event")] = counts.get(e.get("event"), 0) + 1
    summary = next(
        (e for e in reversed(seg) if e.get("event") == "run_summary"), None
    )
    findings = []

    def finding(kind, detail):
        findings.append({"kind": kind, "detail": detail})

    # -- phase: open spans at death ------------------------------------------
    open_records = []
    if newest_bundle and newest_bundle["open_spans"]:
        open_records = newest_bundle["open_spans"]
    elif summary is None and seg:
        open_records = _open_span_records(seg)
    phase_stack = [r.get("name", "?") for r in open_records]
    phase = phase_stack[-1] if phase_stack else None

    # -- evidence-derived findings -------------------------------------------
    exc_texts = []
    for b in bundles:
        man = b["manifest"]
        exc = man.get("exception") or {}
        if exc:
            exc_texts.append(
                f"{exc.get('type', '?')}: {exc.get('message', '')}"
            )
        finding("bundle", f"{man.get('reason', '?')} at {b['path']}")
    if summary is not None and summary.get("status") == "error":
        finding("run_summary", f"status=error at step {summary.get('step')}")
    n_recompiles = _count(counts, "recompile")
    if n_recompiles:
        finding("recompile", f"{n_recompiles} train-step retrace(s)")
    n_transfers = _count(counts, "implicit_transfer")
    if n_transfers:
        finding("implicit_transfer", f"{n_transfers} implicit transfer(s)")
    n_fallback = _count(counts, "platform_fallback")
    for e in seg:
        if e.get("event") == "platform_fallback":
            finding("platform_fallback", e.get("reason", ""))
    n_topology = _count(counts, "topology_mismatch") + _count(
        counts, "elastic_preflight_failed"
    )
    for e in seg:
        # obscheck: disable-next=consumer-field-drift -- the elastic-resume
        # events, the port's (train.py) and the JAX package's
        if e.get("event") in ("topology_mismatch", "elastic_preflight_failed"):
            finding(e["event"], e.get("reason", ""))
        # obscheck: disable-next=consumer-field-drift -- as above
        elif e.get("event") == "elastic_resume":
            finding(
                "elastic_resume",
                f"resharded {e.get('resharded_leaves')} leaves onto "
                f"{(e.get('target_topology') or {}).get('devices', '?')} "
                "devices",
            )
    # a hang (or death) whose open span is a collective/broadcast phase
    # means the run was WAITING ON ITS PEERS: some host never reached
    # the collective — the cross-host deadlock distcheck exists to
    # prevent. The collective_wait span's `phase` field (set by
    # telemetry.collective_phase) names the protocol step.
    coll_spans = [
        r for r in open_records if r.get("name") in SPAN_DEPS
    ]
    for r in coll_spans:
        finding(
            "collective_hang",
            f"open collective/broadcast phase '{r.get('phase', '?')}' — "
            "this host was waiting in a cross-host collective its peers "
            "never completed",
        )
    n_wait_timeouts = _count(counts, "distributed_wait_timeout")
    for e in seg:
        if e.get("event") == "distributed_wait_timeout":
            finding(
                "collective_hang",
                f"phase '{e.get('phase', '?')}' outlived its "
                f"{e.get('timeout_s', '?')}s bound "
                "(distributed_wait_timeout)",
            )
    n_hangs = _count(counts, "hang_detected")
    if n_hangs:
        silences = [
            e.get("silent_s") for e in seg
            if e.get("event") == "hang_detected"
        ]
        finding(
            "hang_detected",
            f"{n_hangs} no-progress window(s), max silence "
            f"{max(s for s in silences if s is not None):.1f}s",
        )
    earlier = len(events) - len(seg)
    if earlier:
        finding("earlier_segments", f"{earlier} event(s) from prior attempts")
    # failure-history sidecar (goodput autopilot): the resume chain's own
    # interruption ledger — how often this experiment actually dies, by kind
    interrupt_history = None
    hist_doc = evidence.get("interrupt_history")
    if hist_doc is not None:
        records = [
            r for r in hist_doc.get("interruptions", [])
            if isinstance(r, dict) and r.get("kind")
        ]
        by_kind = {}
        for r in records:
            by_kind[r["kind"]] = by_kind.get(r["kind"], 0) + 1
        interrupt_history = {
            "count": len(records),
            "by_kind": by_kind,
            "last_ts": max(
                (r.get("ts") for r in records
                 if isinstance(r.get("ts"), (int, float))), default=None,
            ),
            "interval_steps": (hist_doc.get("estimates") or {}).get(
                "interval_steps"
            ),
        }
        if records:
            finding(
                "interrupt_history",
                f"{len(records)} interruption(s) over the resume chain: "
                + ", ".join(f"{k}×{v}" for k, v in sorted(by_kind.items())),
            )
    # SLO alert trail (live metrics exporter): a death that follows
    # sustained burn-rate alerting is symptom-first evidence — the run
    # was already violating its latency/step-time/backpressure rules
    # before it died. Surface each rule's trail as evidence, and any
    # rule still FIRING at death as a finding next to the verdict.
    slo_events = [e for e in seg if e.get("event") == "slo_alert"]
    slo_alerts = None
    if slo_events:
        slo_rules = {}
        for e in slo_events:
            r = slo_rules.setdefault(e.get("rule", "?"), {
                "kind": e.get("kind"), "threshold": e.get("threshold"),
                "fires": 0, "clears": 0, "last_value": None,
                "firing_at_end": False,
            })
            if e.get("state") == "firing":
                r["fires"] += 1
                r["last_value"] = e.get("value")
                r["firing_at_end"] = True
            elif e.get("state") == "cleared":
                r["clears"] += 1
                r["firing_at_end"] = False
        slo_alerts = {
            "events": len(slo_events),
            "total_fires": sum(r["fires"] for r in slo_rules.values()),
            "rules": slo_rules,
        }
        died = summary is None or summary.get("status") == "error"
        for name, r in sorted(slo_rules.items()):
            if died and r["firing_at_end"]:
                finding(
                    "slo_alert",
                    f"rule '{name}' ({r['kind']}) was FIRING when the run "
                    f"died — last value {r['last_value']} vs threshold "
                    f"{r['threshold']} after {r['fires']} fire(s)",
                )
            elif r["fires"]:
                finding(
                    "slo_alert",
                    f"rule '{name}' ({r['kind']}) fired {r['fires']} "
                    f"time(s), cleared before the stream ended",
                )

    # cross-process request tracing: when the stream carries trace
    # context, reassemble it and name the dominant critical-path bucket
    # of the tail exemplars, plus the orphan count (a detached span is an
    # instrumentation defect, surfaced as a finding)
    trace_evidence = None
    from pyrecover_tpu_torch.telemetry import traceassembly

    if traceassembly.has_trace_events(events):
        trep = traceassembly.assemble_events(events)
        trace_evidence = {
            "assembled": trep["traces"]["assembled"],
            "completed": trep["traces"]["completed"],
            "orphan_spans": trep["traces"]["orphan_spans"],
            "dominant_tail_bucket": trep["dominant_tail_bucket"],
            "exemplars": len(trep["exemplars"]),
        }
        if trep["traces"]["orphan_spans"]:
            finding(
                "trace_orphans",
                f"{trep['traces']['orphan_spans']} span(s) detached from "
                "their request root — a trace-context installation hole",
            )

    # -- classification (most-specific first) --------------------------------
    bundle_reason = (
        (newest_bundle or {}).get("manifest", {}).get("reason", "")
    )
    oom_text = next(
        (t for t in exc_texts if _OOM_RE.search(t)), None
    )
    hbm_pct = (summary or {}).get("hbm_peak_pct")
    detail = ""
    if oom_text or (
        isinstance(hbm_pct, (int, float)) and hbm_pct >= 100.0
    ):
        cls = "oom"
        detail = oom_text or f"HBM peak at {hbm_pct}% of budget"
    elif n_hangs or bundle_reason == "hang_detected":
        cls = "hang"
        detail = (
            "watchdog saw a no-progress window"
            + (
                "; the run later resumed and "
                + str((summary or {}).get("status"))
                if summary is not None else "; no run_summary followed"
            )
        )
    elif (
        _count(counts, "preempt_signal_escalation")
        or bundle_reason == "preempt_escalation"
        or _count(counts, "preempt_stop")
        or (summary is not None and summary.get("status") == "stopped_early")
    ):
        cls = "preemption"
        if _count(counts, "preempt_signal_escalation") or (
            bundle_reason == "preempt_escalation"
        ):
            detail = "second signal mid-save: escalated to immediate exit"
        else:
            detail = next(
                (e.get("reason", "") for e in reversed(seg)
                 if e.get("event") == "preempt_stop"),
                "stopped early for a final checkpoint",
            )
    elif n_topology and (
        summary is None or summary.get("status") == "error"
    ):
        # the restore was refused for topology reasons and the run never
        # recovered: either the non-elastic path raised a typed
        # TopologyMismatchError, or every candidate failed the elastic
        # preflight (a successful later fallback would have produced a
        # non-error summary, which routes past this rule)
        cls = "mesh_mismatch"
        detail = next(
            (e.get("reason", "") for e in reversed(seg)
             # obscheck: disable-next=consumer-field-drift -- the
             # elastic-resume events, either package's
             if e.get("event") in ("topology_mismatch",
                                   "elastic_preflight_failed")),
            "",
        ) or "restore refused: checkpoint topology does not fit this mesh"
    elif (
        (summary is not None and summary.get("status") == "error")
        or bundle_reason in ("unhandled_exception", "thread_exception")
        or evidence["fatal_stacks"]
        or (summary is None and seg)
    ):
        cls = "crash"
        if exc_texts:
            detail = exc_texts[-1][:300]
        elif evidence["fatal_stacks"]:
            detail = "fatal signal (see .postmortem/fatal_signal_stacks.txt)"
        elif summary is None:
            detail = (
                "event stream ends without a run_summary — hard kill "
                "(SIGKILL/power loss) or the run is still in flight"
            )
    elif n_fallback:
        cls = "platform_fallback"
        detail = next(
            (e.get("reason", "") for e in seg
             if e.get("event") == "platform_fallback"), "",
        )
    elif n_recompiles >= recompile_storm_threshold:
        cls = "recompile_storm"
        detail = (
            f"{n_recompiles} retraces (threshold "
            f"{recompile_storm_threshold}) — shape/dtype drift is eating "
            "compile time"
        )
    elif summary is not None or (evidence["marker"] or {}).get("done"):
        cls = "healthy"
        detail = (
            f"status={summary.get('status')} at step {summary.get('step')}"
            if summary is not None else "DONE marker present"
        )
    else:
        cls = "unknown"
        detail = "no run_summary, no bundle, no marker — nothing to read"

    last_step = None
    if summary is not None:
        last_step = summary.get("step")
    elif newest_bundle:
        last_step = newest_bundle["manifest"].get("last_step")

    return {
        "classification": cls,
        "phase": phase,
        "phase_stack": phase_stack,
        "detail": detail,
        "last_step": last_step,
        "findings": findings,
        "evidence": {
            "source": evidence["source"],
            "telemetry_path": evidence["telemetry_path"],
            "n_events": len(events),
            "n_last_segment_events": len(seg),
            "n_bundles": len(bundles),
            "fatal_stacks": evidence["fatal_stacks"],
            "marker_done": (evidence["marker"] or {}).get("done"),
            "recompiles": n_recompiles,
            "implicit_transfers": n_transfers,
            "platform_fallbacks": n_fallback,
            "hangs": n_hangs,
            "collective_hangs": len(coll_spans) + n_wait_timeouts,
            "topology_rejections": n_topology,
            "interrupt_history": interrupt_history,
            "slo_alerts": slo_alerts,
            "tracing": trace_evidence,
            "last_status": (summary or {}).get("status"),
        },
    }


def diagnose(target, *, recompile_storm_threshold=DEFAULT_RECOMPILE_STORM):
    """gather + analyze in one call (the API chaos and tests use)."""
    return analyze(
        gather(target),
        recompile_storm_threshold=recompile_storm_threshold,
    )


def exit_code(report):
    if report["classification"] == "healthy":
        return 0
    if report["classification"] == "unknown":
        return 2
    return 1


# ---- rendering / CLI --------------------------------------------------------

def render(report, out=None):
    w = (out or sys.stdout).write
    cls = report["classification"]
    w(f"doctor: {cls.upper()}")
    if report["phase"]:
        w(f" in phase [{report['phase']}]")
    if report["last_step"] is not None:
        w(f" at step {report['last_step']}")
    w("\n")
    if report["detail"]:
        w(f"  {report['detail']}\n")
    if report["phase_stack"] and len(report["phase_stack"]) > 1:
        w(f"  open spans: {' > '.join(report['phase_stack'])}\n")
    e = report["evidence"]
    w(
        f"  evidence: {e['n_events']} events "
        f"({e['n_last_segment_events']} in the last segment), "
        f"{e['n_bundles']} bundle(s), "
        f"last status {e['last_status']}\n"
    )
    tr = e.get("tracing")
    if tr:
        w(
            f"  tracing: {tr['assembled']} request trace(s) "
            f"({tr['completed']} completed), {tr['orphan_spans']} orphan "
            f"span(s)"
        )
        if tr.get("dominant_tail_bucket"):
            w(
                f"; tail exemplars dominated by "
                f"{tr['dominant_tail_bucket']}"
            )
        w("\n")
    for f in report["findings"]:
        w(f"  - {f['kind']}: {f['detail']}\n")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="classify why a pyrecover run died (hang / crash / "
        "preemption / OOM / platform fallback / recompile storm) from its "
        "postmortem bundle or telemetry stream",
    )
    p.add_argument(
        "path",
        help="a postmortem bundle, a .postmortem dir, an experiment dir, "
        "or a telemetry JSONL",
    )
    p.add_argument("--json", dest="json_out", default=None,
                   help="also write the report as JSON here")
    p.add_argument("--recompile-storm-threshold", type=int,
                   default=DEFAULT_RECOMPILE_STORM)
    p.add_argument(
        "--expect", choices=CLASSES, default=None,
        help="CI-gate mode: exit 0 iff the classification matches, 3 "
        "otherwise",
    )
    args = p.parse_args(argv)

    report = diagnose(
        args.path,
        recompile_storm_threshold=args.recompile_storm_threshold,
    )
    render(report)
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        # CI report artifact, regenerated
        # every run; a torn report fails its consumer loudly and is simply
        # re-produced
        Path(args.json_out).write_text(json.dumps(report, indent=2))
    if args.expect is not None:
        if report["classification"] != args.expect:
            print(
                f"doctor: expected classification {args.expect!r}, got "
                f"{report['classification']!r}", file=sys.stderr,
            )
            return 3
        return 0
    return exit_code(report)


if __name__ == "__main__":
    sys.exit(main())
