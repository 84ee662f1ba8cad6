"""pyrecover-top: htop for a training/serving fleet (the JAX package's
``tools/top.py``).

A terminal dashboard over the live telemetry plane: point it at one
process's exporter (``telemetry/exporter.py``) or at several; N targets
are merged through the fleet aggregator (``telemetry/aggregate.py``),
so the numbers on screen are bucket-wise-exact fleet merges.

    python -m pyrecover_tpu_torch.telemetry.top HOST:PORT [HOST:PORT ...]   # live view
    python -m pyrecover_tpu_torch.telemetry.top HOST:PORT --once            # one frame
    python -m pyrecover_tpu_torch.telemetry.top HOST:PORT --once --json     # fleet snapshot

Rendered rows (present when the corresponding subsystem runs): step
time p50/p95 + tokens/sec + MFU + loader wait (train), checkpoint
blocking vs shadow seconds (checkpoint engines), request ttft/e2e
p50/p95/p99 + KV occupancy + backpressure (serving), hot-swap and
autopilot state, firing SLO alerts, and per-target liveness — stale
targets are shown loudly, never dropped.
"""

import argparse
import json
import sys
import time

from pyrecover_tpu_torch.telemetry.aggregate import FleetAggregator


def _fmt(v, unit="", nd=3):
    if v is None:
        return "-"
    if isinstance(v, float):
        v = round(v, nd)
    return f"{v}{unit}"


def _hist_row(h):
    if not h:
        return "-"
    return (
        f"p50 {_fmt(h.get('p50'))}  p95 {_fmt(h.get('p95'))}  "
        f"p99 {_fmt(h.get('p99'))}  (n={h.get('count')})"
    )


def _gauge(fleet, name, how="sum"):
    g = fleet["gauges"].get(name)
    return None if g is None else g.get(how)


def render(fleet):
    """One text frame over a fleet snapshot (also the --once output)."""
    hists = fleet["hists"]
    counters = fleet["counters"]
    lines = []
    ts = time.strftime("%H:%M:%S", time.localtime(fleet["ts"]))
    lines.append(
        f"pyrecover-top  {ts}  targets {fleet['n_ok']}/"
        f"{fleet['n_targets']} live"
        + (f"  restarts {fleet['restarts']}" if fleet["restarts"] else "")
    )
    for target, info in fleet["targets"].items():
        mark = "STALE" if info["stale"] else "ok"
        extra = f" ({info['error']})" if info["error"] else ""
        lines.append(
            f"  [{mark:>5}] {target}  age {_fmt(info['age_s'], 's')}"
            f"{extra}"
        )

    def section(title):
        lines.append(f"-- {title} " + "-" * max(1, 58 - len(title)))

    if "step_iter_s" in hists or fleet["gauges"].get("train_tokens_per_sec"):
        section("train")
        lines.append(f"  step time      {_hist_row(hists.get('step_iter_s'))}")
        tok = _gauge(fleet, "train_tokens_per_sec")
        mfu = _gauge(fleet, "train_mfu_pct", "mean")
        step = _gauge(fleet, "train_step", "max")
        lines.append(
            f"  tokens/sec     {_fmt(tok, nd=1)}   MFU "
            f"{_fmt(mfu, '%', nd=2)}   step {_fmt(step, nd=0)}"
        )
        lines.append(
            f"  loader wait    {_hist_row(hists.get('loader_wait_s'))}"
        )
    ckpt = {
        name: h for name, h in hists.items()
        if name.startswith("ckpt_") and name.endswith("_s")
    }
    blocking = hists.get("ckpt_blocking_s")
    if ckpt or blocking:
        section("checkpoint")
        if blocking:
            lines.append(f"  blocking       {_hist_row(blocking)}")
        for name in sorted(ckpt):
            if name == "ckpt_blocking_s":
                continue
            lines.append(f"  {name:<14} {_hist_row(ckpt[name])}")
    if "e2e_s" in hists or "ttft_s" in hists:
        section("serving")
        lines.append(f"  ttft           {_hist_row(hists.get('ttft_s'))}")
        lines.append(f"  e2e            {_hist_row(hists.get('e2e_s'))}")
        lines.append(
            f"  tokens/sec     "
            f"{_fmt(_gauge(fleet, 'serving_tokens_per_sec'), nd=1)}   "
            f"active {_fmt(_gauge(fleet, 'serving_active_seqs'), nd=0)}   "
            f"queued {_fmt(_gauge(fleet, 'serving_queued'), nd=0)}"
        )
        lines.append(
            f"  KV occupancy   "
            f"{_fmt(_gauge(fleet, 'kv_pool_occupancy_pct', 'mean'), '%', 1)}"
            f" (peak "
            f"{_fmt(_gauge(fleet, 'kv_pool_peak_occupancy_pct', 'max'), '%', 1)})"
            f"   free blocks "
            f"{_fmt(_gauge(fleet, 'kv_pool_free_blocks'), nd=0)}"
            f"   backpressure "
            f"{counters.get('serving_backpressure_total', 0)}"
        )
    if "hotswap_loaded_step" in fleet["gauges"] or counters.get(
        "weights_swaps_total"
    ):
        section("hot-swap")
        lines.append(
            f"  loaded step    "
            f"{_fmt(_gauge(fleet, 'hotswap_loaded_step', 'max'), nd=0)}   "
            f"swaps {counters.get('weights_swaps_total', 0)}   rejected "
            f"{counters.get('hotswap_rejected_total', 0)}"
        )
    if "autopilot_interval_steps" in fleet["gauges"]:
        section("autopilot")
        lines.append(
            f"  ckpt interval  "
            f"{_fmt(_gauge(fleet, 'autopilot_interval_steps', 'max'), nd=0)}"
            f" steps   mtti "
            f"{_fmt(_gauge(fleet, 'autopilot_mtti_s', 'min'), 's', 1)}"
            f"   save cost "
            f"{_fmt(_gauge(fleet, 'autopilot_cost_s', 'max'), 's', 3)}"
        )
    if counters.get("slo_alerts_total"):
        section("alerts")
        lines.append(
            f"  slo_alert fires (fleet total)  "
            f"{counters['slo_alerts_total']}"
        )
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="terminal dashboard over live pyrecover metrics "
        "endpoints (one = live view, several = fleet-merged)"
    )
    ap.add_argument("targets", nargs="+", metavar="HOST:PORT")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh seconds (live view)")
    ap.add_argument("--stale-after", type=float, default=10.0)
    ap.add_argument("--timeout", type=float, default=2.0)
    ap.add_argument("--once", action="store_true",
                    help="print one frame and exit")
    ap.add_argument("--json", action="store_true",
                    help="with --once: print the fleet snapshot JSON")
    args = ap.parse_args(argv)

    agg = FleetAggregator(
        args.targets, stale_after_s=args.stale_after,
        timeout_s=args.timeout,
    )
    while True:
        fleet = agg.poll()
        if args.json:
            sys.stdout.write(json.dumps(fleet) + "\n")
        else:
            if not args.once:
                sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
            sys.stdout.write(render(fleet))
        sys.stdout.flush()
        if args.once:
            return 0
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
