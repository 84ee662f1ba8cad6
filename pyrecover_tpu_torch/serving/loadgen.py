"""Seeded load generator and the serving smoke, ported from the JAX
package's ``serving/loadgen.py``.

The workload generators are pure numpy on the JAX package's seeds and
draws, so one seed gives both packages the same requests. ``run_loadgen``
drives the engine the way traffic would: Poisson arrivals submitted from the
client thread while the engine's background loop schedules, then tokens/s
and ttft/tpot/e2e p50/p95/p99 from the metrics histograms. It is measured
against ``lockstep_baseline``, one ``generate_tokens`` call per request.
``serving_smoke`` saves a tiny checkpoint, restores it through the serving
path, serves a seeded workload and checks greedy equality with lockstep,
zero leaked KV blocks and a non-empty latency report; the metrics exporter
serves the registry over TCP for the whole run, scraped once mid-run and
once after the drain (``live_scrape_digest``).
"""

import hashlib
import time
from pathlib import Path

import numpy as np
import torch

from pyrecover_tpu_torch.serving.engine import ServingConfig, ServingEngine
from pyrecover_tpu_torch.telemetry import metrics


def request_id(seed, index):
    """Deterministic per-request id from ``(seed, index)``, stable across
    processes and runs (content-derived, never ``PYTHONHASHSEED``)."""
    h = hashlib.blake2b(f"{int(seed)}/{int(index)}".encode(), digest_size=6).hexdigest()
    return f"req-{int(seed)}-{int(index):04d}-{h}"


def split_workload(workload, targets, *, seed=0):
    """Split one arrival stream across ``targets`` streams by an independent
    seeded uniform draw per request (Poisson thinning): every request keeps
    its ``arrival_s`` and ``rid``, each stream is Poisson at
    ``rate / targets``, and their union is the input."""
    targets = int(targets)
    if targets < 1:
        raise ValueError(f"targets must be >= 1, got {targets}")
    rng = np.random.default_rng([int(seed), 0x5371])  # its own stream
    streams = [[] for _ in range(targets)]
    for req in workload:
        streams[int(rng.integers(0, targets))].append(req)
    return streams


def sample_workload(n_requests, *, vocab_size, max_model_len, seed=0, prompt_lens=(4, 48),
                    new_tokens=(1, 24), arrival_rate=50.0):
    """Seeded request mix: uniform ragged prompt lengths, output budgets and
    Poisson arrival offsets (exponential gaps at ``arrival_rate`` req/s)."""
    rng = np.random.default_rng(seed)
    reqs = []
    t = 0.0
    for i in range(int(n_requests)):
        p_len = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        n_new = int(rng.integers(new_tokens[0], new_tokens[1] + 1))
        if p_len + n_new > max_model_len:
            p_len = max_model_len - n_new
        t += float(rng.exponential(1.0 / arrival_rate))
        reqs.append({
            "rid": request_id(seed, i),
            "prompt": rng.integers(0, vocab_size, (p_len,)).tolist(),
            "max_new_tokens": n_new,
            "arrival_s": t,
        })
    return reqs


def open_loop_workload(duration_s, *, vocab_size, max_model_len, seed=0, prompt_lens=(4, 48),
                       new_tokens=(1, 24), arrival_rate=50.0, targets=1):
    """Poisson arrivals at ``arrival_rate`` req/s for ``duration_s`` seconds:
    the request count is what the seeded process yields, so a slow server
    cannot shrink its own offered load. ``targets > 1`` splits the stream
    with `split_workload`."""
    targets = int(targets)
    rng = np.random.default_rng(seed)
    reqs = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / arrival_rate))
        if t >= duration_s:
            return split_workload(reqs, targets, seed=seed) if targets > 1 else reqs
        p_len = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        n_new = int(rng.integers(new_tokens[0], new_tokens[1] + 1))
        if p_len + n_new > max_model_len:
            p_len = max_model_len - n_new
        reqs.append({
            "rid": request_id(seed, len(reqs)),
            "prompt": rng.integers(0, vocab_size, (p_len,)).tolist(),
            "max_new_tokens": n_new,
            "arrival_s": t,
        })


def _percentiles(hist):
    return {"p50": hist.percentile(0.50), "p95": hist.percentile(0.95),
            "p99": hist.percentile(0.99)}


def run_loadgen(engine, workload, *, timeout_s=600.0, mid_hook=None):
    """Submit ``workload`` at its arrival offsets from this (client) thread
    while ``engine``'s background loop serves; block until every request
    drains. Returns ``(results, report)``: each request's ids, and
    throughput and latency percentiles.

    ``mid_hook`` (optional) fires exactly once, mid-run: every request is
    submitted, at least half have finished, and the engine still serves the
    rest (the live scrape's observation point)."""
    t0 = time.monotonic()
    rids = []
    engine.start()
    try:
        for req in workload:
            delay = req["arrival_s"] - (time.monotonic() - t0)
            if delay > 0:
                time.sleep(delay)
            rids.append(engine.submit(req["prompt"], req["max_new_tokens"]))
        deadline = time.monotonic() + timeout_s
        while engine.pending:
            if mid_hook is not None and engine.pending <= len(workload) // 2:
                hook, mid_hook = mid_hook, None
                hook()
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"loadgen: {engine.pending} requests still pending after {timeout_s}s")
            time.sleep(0.002)
        if mid_hook is not None:  # drained before the drain loop saw it
            mid_hook()
    finally:
        engine.stop()
    wall_s = time.monotonic() - t0
    results = [engine.result(rid) for rid in rids]
    new_tokens = sum(req["max_new_tokens"] for req in workload)
    report = {
        "requests": len(workload),
        "wall_s": wall_s,
        "new_tokens": new_tokens,
        "tokens_per_sec": new_tokens / max(wall_s, 1e-9),
        "ttft_s": _percentiles(metrics.histogram("ttft_s")),
        "tpot_s": _percentiles(metrics.histogram("tpot_s")),
        "e2e_s": _percentiles(metrics.histogram("e2e_s")),
        "backpressure_events": metrics.counter("serving_backpressure_total").value,
    }
    return results, report


def lockstep_baseline(model, workload, *, max_len):
    """The serial pre-serving posture: one ``generate_tokens`` call per
    request (ragged prompts cannot batch in lockstep), timed end to end.
    Returns ``(results, report)`` in ``run_loadgen``'s shape."""
    from pyrecover_tpu_torch.models.decode import generate_tokens

    t0 = time.monotonic()
    results = [generate_tokens(model, req["prompt"], req["max_new_tokens"], max_len=max_len)
               for req in workload]
    wall_s = time.monotonic() - t0
    new_tokens = sum(req["max_new_tokens"] for req in workload)
    return results, {"requests": len(workload), "wall_s": wall_s, "new_tokens": new_tokens,
                     "tokens_per_sec": new_tokens / max(wall_s, 1e-9)}


def live_scrape_digest(snap):
    """One exporter scrape (``/snapshot.json``) compressed to the key series
    a live check reads: tokens/s, step-time p50, request p99, KV occupancy."""
    hists = snap.get("hists", {})
    gauges = snap.get("gauges", {})

    def pct(name, q):
        return (hists.get(name) or {}).get(q)

    return {
        "seq": snap.get("seq"),
        "tokens_per_sec": gauges.get("serving_tokens_per_sec"),
        "train_tokens_per_sec": gauges.get("train_tokens_per_sec"),
        "step_iter_p50": pct("step_iter_s", "p50"),
        "step_iter_count": (hists.get("step_iter_s") or {}).get("count"),
        "ttft_p50": pct("ttft_s", "p50"),
        "e2e_p99": pct("e2e_s", "p99"),
        "e2e_count": (hists.get("e2e_s") or {}).get("count"),
        "kv_occupancy_pct": gauges.get("kv_pool_occupancy_pct"),
        "kv_peak_occupancy_pct": gauges.get("kv_pool_peak_occupancy_pct"),
        "backpressure_total": snap.get("counters", {}).get("serving_backpressure_total", 0),
    }


def serving_smoke(workdir, *, n_requests=12, seed=0, kv_mode="native", device="cuda"):
    """Save a tiny checkpoint under ``workdir``, restore it through the
    serving path on ``device`` (the card unless ``cpu`` is asked for), serve
    a seeded workload under the load generator, and check greedy equality
    with lockstep for EVERY request (native KV), zero leaked KV blocks and a
    non-empty latency report. The registry is served over TCP throughout
    and scraped mid-run and after the drain (``report["live_scrape"]``).
    Returns the report; raises on a violation."""
    from pyrecover_tpu_torch.checkpoint.vanilla import save_ckpt_vanilla
    from pyrecover_tpu_torch.config import TrainConfig
    from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer
    from pyrecover_tpu_torch.optim import build_optimizer
    from pyrecover_tpu_torch.serving.restore import load_serving_params
    from pyrecover_tpu_torch.telemetry.aggregate import scrape
    from pyrecover_tpu_torch.telemetry.exporter import MetricsExporter
    from pyrecover_tpu_torch.train_state import state_leaves
    from pyrecover_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    metrics.reset()
    cfg = ModelConfig().tiny(max_seq_len=96, vocab_size=64, compute_dtype="float32",
                             param_dtype="float32")
    model = Transformer(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(seed))
    optimizer, _ = build_optimizer(TrainConfig(), model.parameters())
    ckpt = workdir / "ckpt_smoke.ckpt"
    save_ckpt_vanilla(ckpt, state_leaves(model, optimizer), verify=True)
    served, info = load_serving_params(ckpt, cfg, device=device)

    engine = ServingEngine(served, ServingConfig(
        block_size=8, max_seqs=4, prefill_chunk=16, prefill_token_budget=32, kv_mode=kv_mode,
    ))
    workload = sample_workload(
        n_requests, vocab_size=cfg.vocab_size, max_model_len=engine.max_model_len, seed=seed,
        prompt_lens=(3, 24), new_tokens=(1, 12), arrival_rate=200.0,
    )
    exporter = MetricsExporter(port=0).start()
    scrapes = {}
    target = f"127.0.0.1:{exporter.port}"
    try:
        results, report = run_loadgen(
            engine, workload,
            mid_hook=lambda: scrapes.__setitem__("mid", scrape(target, timeout_s=30.0)))
        scrapes["final"] = scrape(target, timeout_s=30.0)
    finally:
        exporter.stop()
    engine.pool.check_drained()  # zero leaked blocks, loudly

    expected, _ = lockstep_baseline(model, workload, max_len=cfg.max_seq_len)
    mismatched = [i for i, (got, want) in enumerate(zip(results, expected)) if got != want]
    if kv_mode == "native" and mismatched:
        raise AssertionError(
            f"paged serving diverged from lockstep decode on requests {mismatched} "
            f"(of {len(results)})"
        )
    if not report["tokens_per_sec"] or report["ttft_s"]["p50"] is None:
        raise AssertionError(f"empty latency report: {report}")
    report["restore"] = info
    report["greedy_matches"] = len(results) - len(mismatched)
    report["kv_mode"] = kv_mode
    report["live_scrape"] = {"url": f"http://{target}",
                             "mid": live_scrape_digest(scrapes["mid"]),
                             "final": live_scrape_digest(scrapes["final"])}
    return report
