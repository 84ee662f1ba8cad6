"""Fleet aggregation: scrape N live-metrics endpoints and merge them into
ONE fleet-level snapshot (the JAX package's ``telemetry/aggregate.py``).

The other half of the live telemetry plane (``telemetry/exporter.py``):
every process (trainers, serving engines) exposes ``/snapshot.json``; the
aggregator scrapes them over real TCP and merges with the semantics a fleet
view needs:

* **Histograms merge bucket-wise, exactly.** Every process buckets on
  the SAME geometric grid (``telemetry/metrics.py``), so the fleet
  histogram is the integer sum of bucket counts — no resampling, no
  approximation beyond the single-process bucket width — and fleet
  percentiles come from ``percentile_from_buckets`` over the sum.
* **Counters sum with per-target restart detection.** A counter is
  monotonic within one process lifetime; a scrape whose identity
  (``pid``/``start_ts``) changed — or whose counters went backwards —
  marks a RESTART: the previous lifetime's totals are folded into a
  per-target carried base and the new lifetime counts from zero on top
  of it. A restart therefore never produces a negative rate and never
  loses the dead lifetime's work.
* **Stale targets are flagged, never silently dropped.** A target that
  stops answering keeps contributing its last-known totals to the fleet
  sums and shows up in ``stale`` with its age and last error — a
  SIGKILLed replica is an event the operator must see, not a row that
  quietly vanishes.

Each ``poll()`` emits one ``metrics_scrape`` event (targets scraped, ok
/ stale counts, wall seconds) into the normal telemetry stream.

CLI (one fleet snapshot per line; ``telemetry/top.py`` renders the same
data):

    python -m pyrecover_tpu_torch.telemetry.aggregate HOST:PORT [HOST:PORT ...] \
        [--once] [--interval 2.0] [--stale-after 10.0]
    python -m pyrecover_tpu_torch.telemetry.aggregate --drill WORKDIR
"""

# obscheck: disable-file=metric-name-drift -- the fleet drill's demo
# series (requests_total / lat_s) are registered by its subprocess
# exporters from their --counter/--hist argv specs, invisible to static
# extraction; the aggregator core itself is series-name-agnostic

import json
import sys
import time
import urllib.request

from pyrecover_tpu_torch.telemetry import bus
from pyrecover_tpu_torch.telemetry.metrics import (
    bucket_from_key,
    bucket_key,
    percentile_from_buckets,
)


def normalize_target(target):
    """``host:port`` / ``:port`` / full URL -> the snapshot URL."""
    if target.startswith("http://") or target.startswith("https://"):
        url = target
    else:
        if target.startswith(":"):
            target = "127.0.0.1" + target
        url = "http://" + target
    return url.rstrip("/") + "/snapshot.json"


def scrape(target, timeout_s=2.0):
    """One scrape over real TCP: GET the target's ``/snapshot.json`` and
    return the parsed snapshot dict (raises on any transport/parse
    failure — the aggregator turns that into staleness, never a crash)."""
    with urllib.request.urlopen(
        normalize_target(target), timeout=timeout_s
    ) as resp:
        return json.loads(resp.read().decode())


def merge_raw_hists(parts):
    """Bucket-wise merge of raw histogram dicts (string-keyed buckets):
    integer bucket sums, summed count/sum, min-of-mins / max-of-maxes,
    and fleet percentiles recomputed over the merged buckets."""
    buckets = {}
    count = 0
    total = 0.0
    vmin = None
    vmax = None
    for h in parts:
        if not h:
            continue
        count += h.get("count", 0)
        total += h.get("sum", 0.0)
        for key, n in h.get("buckets", {}).items():
            idx = bucket_from_key(key)
            buckets[idx] = buckets.get(idx, 0) + n
        hmin, hmax = h.get("min"), h.get("max")
        if hmin is not None:
            vmin = hmin if vmin is None else min(vmin, hmin)
        if hmax is not None:
            vmax = hmax if vmax is None else max(vmax, hmax)
    if not count:
        return None
    out = {
        "count": count, "sum": round(total, 9), "min": vmin, "max": vmax,
    }
    for label, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
        p = percentile_from_buckets(buckets, count, vmin, vmax, q)
        out[label] = round(p, 6) if p is not None else None
    out["buckets"] = {bucket_key(idx): n for idx, n in buckets.items()}
    return out


def _add_hists(into, raw):
    """Fold one lifetime's raw hists into a carried base, bucket-wise."""
    for name, h in (raw or {}).items():
        merged = merge_raw_hists([into.get(name), h])
        if merged is not None:
            into[name] = merged


class _Target:
    """Per-endpoint scrape state: the last snapshot, liveness, and the
    carried totals of every PREVIOUS lifetime (restart accounting)."""

    def __init__(self, target):
        self.target = target
        self.url = normalize_target(target)
        self.last = None          # last good snapshot (current lifetime)
        self.last_ok_ts = None
        self.error = None
        self.restarts = 0
        self.carried_counters = {}
        self.carried_hists = {}

    def _is_restart(self, snap):
        prev = self.last
        if prev is None:
            return False
        if (snap.get("pid"), snap.get("start_ts")) != (
            prev.get("pid"), prev.get("start_ts")
        ):
            return True
        # identity-less exporters: a counter or histogram moving
        # backwards is the restart signal (values are monotonic within
        # one lifetime)
        for name, v in prev.get("counters", {}).items():
            if snap.get("counters", {}).get(name, 0) < v:
                return True
        for name, h in prev.get("hists", {}).items():
            cur = snap.get("hists", {}).get(name)
            if cur is not None and cur.get("count", 0) < h.get("count", 0):
                return True
        return False

    def feed(self, snap, now):
        if self._is_restart(snap):
            self.restarts += 1
            for name, v in self.last.get("counters", {}).items():
                self.carried_counters[name] = (
                    self.carried_counters.get(name, 0) + v
                )
            _add_hists(self.carried_hists, self.last.get("hists"))
        self.last = snap
        self.last_ok_ts = now
        self.error = None

    def fail(self, error):
        # concur: disable-next=unguarded-shared-state -- single-consumer
        # protocol: one caller drives FleetAggregator.poll() (class
        # docstring); the flagged cross-root alias is Popen.poll() on the
        # fleet supervisor's monitor thread, which never touches targets
        self.error = f"{type(error).__name__}: {error}"

    def counters(self):
        """Lifetime totals: carried (pre-restart) + current."""
        out = dict(self.carried_counters)
        for name, v in (self.last or {}).get("counters", {}).items():
            out[name] = out.get(name, 0) + v
        return out

    def hists(self):
        out = dict(self.carried_hists)
        cur = (self.last or {}).get("hists")
        if cur:
            merged = dict(out)
            for name, h in cur.items():
                m = merge_raw_hists([out.get(name), h])
                if m is not None:
                    merged[name] = m
            out = merged
        return out


class FleetAggregator:
    """Scrape a fixed target set and expose one merged fleet snapshot.
    Single consumer: one caller drives ``poll()`` (the CLI loop, top.py,
    or a drill) — there is no internal thread."""

    def __init__(self, targets, *, stale_after_s=10.0,
                 timeout_s=2.0):
        if not targets:
            raise ValueError("aggregator needs at least one target")
        self.targets = [_Target(t) for t in targets]
        self.stale_after_s = float(stale_after_s)
        self.timeout_s = float(timeout_s)
        self._polls = 0

    def poll(self, now=None):
        """Scrape every target once, update per-target state, emit one
        ``metrics_scrape`` event, and return the merged fleet snapshot."""
        t0 = time.monotonic()
        for tgt in self.targets:
            try:
                snap = scrape(tgt.target, timeout_s=self.timeout_s)
            except Exception as e:  # any transport failure = staleness
                tgt.fail(e)
                continue
            tgt.feed(snap, now if now is not None else time.time())
        # concur: disable-next=unguarded-shared-state -- single-consumer
        # protocol (class docstring); the cross-root alias is Popen.poll()
        # on the fleet supervisor's monitor thread, not this method
        self._polls += 1
        fleet = self.snapshot(now=now)
        bus.emit(
            "metrics_scrape", poll=self._polls,
            targets=len(self.targets), ok=fleet["n_ok"],
            stale=len(fleet["stale"]),
            seconds=round(time.monotonic() - t0, 6),
        )
        return fleet

    def snapshot(self, now=None):
        """The merged fleet view over the current per-target state."""
        now = time.time() if now is None else now
        targets = {}
        stale = []
        counters = {}
        gauges = {}
        hist_parts = {}
        n_ok = 0
        for tgt in self.targets:
            age = (
                None if tgt.last_ok_ts is None else now - tgt.last_ok_ts
            )
            is_stale = age is None or age > self.stale_after_s
            if not is_stale:
                n_ok += 1
            else:
                stale.append(tgt.target)
            targets[tgt.target] = {
                "url": tgt.url,
                "ok": not is_stale,
                "stale": is_stale,
                "age_s": round(age, 3) if age is not None else None,
                "error": tgt.error,
                "restarts": tgt.restarts,
                "pid": (tgt.last or {}).get("pid"),
                "seq": (tgt.last or {}).get("seq"),
            }
            # stale targets keep contributing their last-known totals —
            # flagged above, never silently dropped
            for name, v in tgt.counters().items():
                counters[name] = counters.get(name, 0) + v
            for name, h in tgt.hists().items():
                hist_parts.setdefault(name, []).append(h)
            for name, v in (tgt.last or {}).get("gauges", {}).items():
                if not isinstance(v, (int, float)):
                    continue
                g = gauges.setdefault(
                    name, {"sum": 0.0, "min": v, "max": v, "n": 0},
                )
                g["sum"] += v
                g["min"] = min(g["min"], v)
                g["max"] = max(g["max"], v)
                g["n"] += 1
        for g in gauges.values():
            g["mean"] = g["sum"] / max(g["n"], 1)
        hists = {
            name: merge_raw_hists(parts)
            for name, parts in hist_parts.items()
        }
        return {
            "ts": now,
            "n_targets": len(self.targets),
            "n_ok": n_ok,
            "stale": stale,
            "restarts": sum(t.restarts for t in self.targets),
            "targets": targets,
            "counters": counters,
            "gauges": gauges,
            "hists": {k: v for k, v in hists.items() if v is not None},
        }


# ---- the fleet drill --------------------------------------------------------


def _spawn_demo(workdir, idx, spec):
    """One genuinely separate exporter process (the drill protocol:
    child appends its port to a status JSONL; parent polls for it)."""
    import subprocess

    status = workdir / f"demo_{idx}.status.jsonl"
    # the drill's status file: the parent polls and re-parses it line by
    # line; a torn truncate is retried
    status.write_text("")
    argv = [
        sys.executable, "-m", "pyrecover_tpu_torch.telemetry.exporter",
        "--status", str(status),
    ] + spec
    proc = subprocess.Popen(
        argv, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT,
    )
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        for line in status.read_text().splitlines():
            rec = json.loads(line)
            # obscheck: disable-next=consumer-field-drift -- the
            # exporter's --status handshake file reuses the "event" key
            # for its own records; these are not bus events
            if rec.get("event") == "serving":
                return proc, rec["port"]
        if proc.poll() is not None:
            raise RuntimeError(
                f"fleet drill: demo exporter {idx} died rc={proc.returncode}"
            )
        time.sleep(0.02)
    proc.kill()
    raise TimeoutError(f"fleet drill: demo exporter {idx} never served")


def fleet_drill(workdir, *, stale_after_s=0.5):
    """The aggregator drill: two REAL subprocess exporters
    scraped over TCP, merged counts asserted equal to the sum of the
    parts and histogram merges asserted bucket-wise exact, then one
    child SIGKILLed and asserted to be *flagged stale* — still present
    in the fleet sums, never silently dropped. Returns the report dict;
    raises AssertionError on any violation."""
    import signal
    from pathlib import Path

    from pyrecover_tpu_torch.telemetry import metrics as _m

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    vals_a = [0.01, 0.05, 0.2, 1.5]
    vals_b = [0.03, 0.08, 0.8, 4.0, 4.0]
    spec_a = ["--counter", "requests_total=7",
              "--gauge", "tokens_per_sec=100",
              "--hist", "lat_s=" + ":".join(map(str, vals_a))]
    spec_b = ["--counter", "requests_total=5",
              "--gauge", "tokens_per_sec=50",
              "--hist", "lat_s=" + ":".join(map(str, vals_b))]
    proc_a, port_a = _spawn_demo(workdir, 0, spec_a)
    proc_b, port_b = _spawn_demo(workdir, 1, spec_b)
    try:
        agg = FleetAggregator(
            [f"127.0.0.1:{port_a}", f"127.0.0.1:{port_b}"],
            stale_after_s=stale_after_s, timeout_s=5.0,
        )
        fleet = agg.poll()
        if fleet["n_ok"] != 2 or fleet["stale"]:
            raise AssertionError(f"fleet drill: not all live: {fleet}")
        if fleet["counters"].get("requests_total") != 12:
            raise AssertionError(
                "fleet drill: counter sum "
                f"{fleet['counters'].get('requests_total')} != 7 + 5"
            )
        # bucket-wise exactness: the merged histogram must equal one
        # local histogram fed every value (the grid is shared)
        ref = _m.Histogram("_fleet_ref")
        for v in vals_a + vals_b:
            ref.observe(v)
        got = fleet["hists"]["lat_s"]
        want = ref.raw()
        if got["buckets"] != want["buckets"] or (
            got["count"] != want["count"]
        ):
            raise AssertionError(
                f"fleet drill: merge not bucket-wise exact: "
                f"{got['buckets']} != {want['buckets']}"
            )
        if got["p99"] != round(ref.percentile(0.99), 6):
            raise AssertionError(
                "fleet drill: fleet p99 drifted from the single-process "
                f"estimate: {got['p99']}"
            )
        if fleet["gauges"]["tokens_per_sec"]["sum"] != 150:
            raise AssertionError(
                f"fleet drill: gauge sum {fleet['gauges']}"
            )

        # SIGKILL one replica: the next poll past the staleness window
        # must FLAG it — and keep its last totals in the fleet sums
        proc_b.send_signal(signal.SIGKILL)
        proc_b.wait(timeout=30.0)
        time.sleep(stale_after_s + 0.1)
        fleet2 = agg.poll()
        tgt_b = fleet2["targets"][f"127.0.0.1:{port_b}"]
        if not tgt_b["stale"] or fleet2["n_ok"] != 1:
            raise AssertionError(
                f"fleet drill: SIGKILLed target not stale: {fleet2}"
            )
        if f"127.0.0.1:{port_b}" not in fleet2["stale"]:
            raise AssertionError(
                f"fleet drill: stale list dropped the dead target: "
                f"{fleet2['stale']}"
            )
        if fleet2["counters"].get("requests_total") != 12:
            raise AssertionError(
                "fleet drill: dead target's counters were dropped "
                f"({fleet2['counters']})"
            )
        if fleet2["hists"]["lat_s"]["count"] != len(vals_a + vals_b):
            raise AssertionError(
                "fleet drill: dead target's histogram was dropped"
            )
        return {
            "targets": 2,
            "merged_requests_total": fleet["counters"]["requests_total"],
            "merged_lat_count": got["count"],
            "lat_p99": got["p99"],
            "stale_after_kill": fleet2["stale"],
            "killed": f"127.0.0.1:{port_b}",
        }
    finally:
        for proc in (proc_a, proc_b):
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=30.0)
                except Exception:
                    proc.kill()


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="scrape live-metrics endpoints into one fleet "
        "snapshot (JSON per line)"
    )
    ap.add_argument("targets", nargs="*", metavar="HOST:PORT")
    ap.add_argument("--once", action="store_true")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--stale-after", type=float, default=10.0)
    ap.add_argument("--timeout", type=float, default=2.0)
    ap.add_argument(
        "--drill", metavar="WORKDIR", default=None,
        help="run the two-subprocess fleet drill under WORKDIR and print "
        "its report instead of scraping",
    )
    args = ap.parse_args(argv)

    if args.drill:
        print(json.dumps(fleet_drill(args.drill)), flush=True)
        return 0
    if not args.targets:
        ap.error("targets required (or --drill WORKDIR)")

    agg = FleetAggregator(
        args.targets, stale_after_s=args.stale_after,
        timeout_s=args.timeout,
    )
    while True:
        print(json.dumps(agg.poll()), flush=True)
        if args.once:
            return
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
