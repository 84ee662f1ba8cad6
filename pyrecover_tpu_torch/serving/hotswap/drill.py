"""Hot-swap proof harness: the train-and-serve smoke and the kill-mid-swap
drill (the JAX package's ``serving/hotswap/drill.py``).

  * :func:`hotswap_smoke`: ONE process trains and serves at once. The
    calling thread trains (moves a subset of the params and commits zerostall
    checkpoints, whose collectives stay on the calling thread) while the load
    generator's client thread drives the engine open-loop for a fixed window
    and the watcher swaps weights live. Gated on at least one swap, token
    equality of a post-swap probe with a COLD restore of the final manifest,
    an incremental fetch that reused bytes, and p99 latency across the swap
    window within a generous bound of the same workload on a no-swap
    engine, run just before and just after the window (the mean of the
    two p99s). The metrics exporter serves the registry throughout; one scrape
    lands mid-run and one after the drain.
  * :func:`hotswap_chaos_drill`: a serving subprocess is SIGKILLed mid-fetch
    (the ``swap_fetch`` fault seam) while swapping toward a new manifest.
    The drill proves zero torn state: the pin lease survives the kill and
    shields the in-fetch manifest's chunks from GC, a restart serving the
    OLD manifest reproduces the pre-kill probe tokens bit for bit, a
    restarted watcher completes the interrupted swap, nothing is
    quarantined, and once the stale lease expires the chunk store holds
    exactly the live manifests' chunks.

Both run on the card unless ``device="cpu"`` is asked for: the smoke at
the tiny fp32 model, the chaos drill at the ``model_config`` given (the tiny
one by default); the parent and its server subprocesses build the same
config on the same device. The module is the
drill's server entry too::

    python -m pyrecover_tpu_torch.serving.hotswap.drill --serve EXP_DIR \\
        --status STATUS.jsonl [--manifest PATH] [--watch] [--device cpu] \\
        [--model-config JSON]
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.telemetry import metrics

# p99 gate across the swap window vs the no-swap baseline: generous (CPU
# timing is noisy at millisecond decode steps) but real: a swap that stalls
# the serve loop moves p99 by whole seconds and fails it
P99_FACTOR = 5.0
P99_SLACK_S = 0.5
# the seed of the drills' weights, probes and workload, and the smoke's
# open-loop arrival rate (req/s)
SEED = 0
ARRIVAL_RATE = 120.0


def drill_model_config():
    """The tiny fp32 serving-smoke model, the drills' default."""
    from pyrecover_tpu_torch.models.llama import ModelConfig

    return ModelConfig().tiny(max_seq_len=96, vocab_size=64, compute_dtype="float32",
                              param_dtype="float32")


def _serving_config():
    from pyrecover_tpu_torch.serving.engine import ServingConfig

    return ServingConfig(block_size=8, max_seqs=4, prefill_chunk=16, prefill_token_budget=32,
                         max_model_len=96)


def _train_state(cfg, seed, device):
    """A seeded model and its optimizer: the drill's training state."""
    from pyrecover_tpu_torch.config import TrainConfig
    from pyrecover_tpu_torch.models.llama import Transformer
    from pyrecover_tpu_torch.optim import build_optimizer

    model = Transformer(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(seed))
    optimizer, _ = build_optimizer(TrainConfig(), model.parameters())
    return model, optimizer


@torch.no_grad()
def perturb(model, i):
    """A deterministic 'training step': move ONLY the lm head and the final
    norm by 1e-3 * i, leaving the layer stack and the embeddings byte for
    byte; the unchanged leaves make the incremental fetch measurable."""
    for p in (model.output, model.final_norm):
        p.add_(1e-3 * i)


def save_zs(exp_dir, step, model, optimizer):
    """Commit the state as ``ckpt_<step>.zs.json`` and keep nothing pinned
    or in the emergency tier afterwards (a drill, not a trainer)."""
    from pyrecover_tpu_torch.checkpoint import zerostall
    from pyrecover_tpu_torch.train_state import state_leaves

    path = Path(exp_dir) / f"ckpt_{step}.zs.json"
    zerostall.save_ckpt_zerostall(path, state_leaves(model, optimizer, step=step),
                                  background=False, extra_meta={"step": int(step)})
    zerostall.emergency.drop(exp_dir)
    zerostall.release(exp_dir)
    return path


def probe_workload(cfg):
    """A fixed post-swap probe: six seeded prompts whose greedy outputs
    fingerprint the serving weights."""
    rng = np.random.default_rng(1000 + SEED)
    return [{"prompt": rng.integers(0, cfg.vocab_size, (int(rng.integers(4, 13)),)).tolist(),
             "max_new_tokens": int(rng.integers(4, 9))} for _ in range(6)]


def run_probe(engine, probe):
    """Serve the probe through the engine (with the background loop running
    or through the manual pump) and return the token lists in submission
    order."""
    if engine._loop_owner() is None:
        engine.reopen()  # a stopped engine refuses submit()
    rids = [engine.submit(req["prompt"], req["max_new_tokens"]) for req in probe]
    if engine._loop_owner() is None:
        engine.run_until_drained()
    else:
        deadline = time.monotonic() + 120.0
        while any(engine.result(r) is None for r in rids):
            if time.monotonic() > deadline:
                raise TimeoutError("probe requests did not drain")
            time.sleep(0.005)
    return [engine.result(r) for r in rids]


def _restore(path, cfg, device, host_bytes=None):
    from pyrecover_tpu_torch.serving.restore import load_serving_params

    return load_serving_params(path, cfg, device=device, host_bytes=host_bytes)[0]


# ---- train-and-serve smoke --------------------------------------------------


def hotswap_smoke(workdir, *, duration_s=3.0, n_saves=3, device="cuda"):
    """The train-and-serve check. Returns the report dict; raises
    AssertionError on any violated invariant."""
    from pyrecover_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    sink = telemetry.JsonlSink(workdir / "hotswap_telemetry.jsonl")
    telemetry.add_sink(sink)
    mem = telemetry.MemorySink()
    telemetry.add_sink(mem)
    metrics.reset()
    try:
        return _hotswap_smoke_body(workdir, mem, duration_s=duration_s, n_saves=n_saves,
                                   device=device)
    finally:
        metrics.flush(reason="hotswap_smoke")
        telemetry.remove_sink(mem)
        telemetry.remove_sink(sink)
        sink.close()


def _hotswap_smoke_body(workdir, mem, *, duration_s, n_saves, device):
    from pyrecover_tpu_torch.checkpoint.zerostall.chunkstore import read_manifest
    from pyrecover_tpu_torch.serving.engine import ServingEngine
    from pyrecover_tpu_torch.serving.hotswap.swap import HotSwapper
    from pyrecover_tpu_torch.serving.loadgen import (
        live_scrape_digest,
        open_loop_workload,
        run_loadgen,
    )
    from pyrecover_tpu_torch.telemetry.aggregate import scrape
    from pyrecover_tpu_torch.telemetry.exporter import MetricsExporter

    cfg = drill_model_config()
    exp = workdir / "exp"
    exp.mkdir(parents=True, exist_ok=True)
    model, optimizer = _train_state(cfg, SEED, device)
    first = save_zs(exp, 1, model, optimizer)
    host = {}
    engine = ServingEngine(_restore(first, cfg, device, host), _serving_config())
    # warm the engine outside the measured window (the no-swap baseline
    # below gets the same, so the p99 comparison is fair)
    engine.submit([1, 2, 3], 2)
    engine.run_until_drained()
    # the no-swap baseline: the same workload on an engine that never swaps,
    # run just before the swap window and again just after it, so load that
    # lands across the window (a neighbouring process's) lands on a
    # baseline run too; the gate takes the mean of the two p99s
    base = ServingEngine(_restore(first, cfg, device), _serving_config())
    base.submit([1, 2, 3], 2)
    base.run_until_drained()

    swapper = HotSwapper(engine, exp, cfg, loaded_path=first, loaded_host=host,
                         poll_interval_s=0.03)
    workload = open_loop_workload(duration_s, vocab_size=cfg.vocab_size,
                                  max_model_len=engine.max_model_len, seed=SEED,
                                  prompt_lens=(3, 20), new_tokens=(1, 10),
                                  arrival_rate=ARRIVAL_RATE)
    final_step = n_saves + 1

    # set once the trainer's last step is in the registry: the final scrape
    # waits for it (the drain can finish before a slow last save does)
    trained = threading.Event()

    def trainer():
        gap = duration_s / (n_saves + 1)
        try:
            for i in range(2, final_step + 1):
                time.sleep(gap)
                t_iter = time.monotonic()
                perturb(model, i)
                save_zs(exp, i, model, optimizer)
                # the trainer half's cadence, into the series the real train
                # loop feeds: the live scrape's step-time p50
                metrics.histogram("step_iter_s").observe(time.monotonic() - t_iter)
                metrics.gauge("train_step").set(i)
        finally:
            trained.set()

    # the live plane over the whole window: one scrape mid-run (at least
    # half the requests done, trainer and swapper live), one after the drain
    exporter = MetricsExporter(port=0).start()
    target = f"127.0.0.1:{exporter.port}"
    scrapes, served = {}, {}

    def client():
        try:
            served["report"] = run_loadgen(
                engine, workload,
                mid_hook=lambda: scrapes.__setitem__("mid", scrape(target, timeout_s=30.0)))[1]
            if not trained.wait(timeout=max(60.0, 10 * duration_s)):
                raise AssertionError("hotswap smoke: the trainer never finished its saves")
            scrapes["final"] = scrape(target, timeout_s=30.0)
        except Exception as e:  # re-raised on the main thread below
            served["error"] = e

    metrics.reset()
    _, before_report = run_loadgen(base, workload)
    # the trainer runs on this (the calling) thread, where its saves'
    # collectives belong; the load generator's client on its own
    metrics.reset()
    thread = threading.Thread(target=client, name="hotswap-client")
    swapper.start()
    thread.start()
    try:
        trainer()
    finally:
        thread.join(timeout=max(60.0, 10 * duration_s))
        exporter.stop()
        deadline = time.monotonic() + 30.0
        while swapper.loaded_step < final_step and time.monotonic() < deadline:
            time.sleep(0.02)
        swapper.stop()
    if thread.is_alive():
        raise AssertionError("hotswap smoke: load generator wedged")
    if "error" in served:
        raise served["error"]
    swap_report = served["report"]
    if swapper.loaded_step < final_step:
        raise AssertionError(
            f"hotswap smoke: watcher never reached the final manifest (loaded step "
            f"{swapper.loaded_step} < {final_step}; rejected: {swapper.rejected})")

    # probe AFTER the final swap (the manual pump applies a staged flip),
    # then token equality with a COLD restore
    probe = probe_workload(cfg)
    live_tokens = run_probe(engine, probe)
    engine.pool.check_drained()
    final_path = exp / f"ckpt_{final_step}.zs.json"
    cold = ServingEngine(_restore(final_path, cfg, device), _serving_config())
    cold_tokens = run_probe(cold, probe)
    mismatched = [i for i, (a, b) in enumerate(zip(live_tokens, cold_tokens)) if a != b]
    if mismatched:
        raise AssertionError(f"hotswap smoke: post-swap serving diverged from a cold restore of "
                             f"{final_path.name} on probes {mismatched}")

    # swap accounting from the telemetry trail: swaps landed, none was
    # rejected, and the incremental fetch moved less than the params
    events = mem.events
    done = [e for e in events if e["event"] == "weights_swap_done"]
    rejected = [e for e in events if e["event"] == "weights_swap_rejected"]
    fetches = [e for e in events if e["event"] == "swap_fetch_bytes" and e.get("incremental")]
    if not done:
        raise AssertionError("hotswap smoke: no weights_swap_done event")
    if rejected:
        raise AssertionError(f"hotswap smoke: unexpected swap rejections: {rejected}")
    params_bytes = sum(int(e["nbytes"]) for e in read_manifest(final_path)["leaves"]
                       if e["path"].startswith(".params"))
    fetched = sum(int(e["fetched_bytes"]) for e in fetches)
    reused = sum(int(e["reused_bytes"]) for e in fetches)
    if not fetches or reused <= 0:
        raise AssertionError(f"hotswap smoke: incremental fetch reused no bytes ({fetches})")
    if fetched >= len(fetches) * params_bytes:
        raise AssertionError(
            f"hotswap smoke: fetch moved {fetched} bytes over {len(fetches)} swap(s) of a "
            f"{params_bytes}-byte params set — nothing was incremental")

    # p99 across the swap window vs the SAME workload on the no-swap engine,
    # the mean of its runs' p99s before and after the window
    metrics.reset()
    _, after_report = run_loadgen(base, workload)
    p99 = swap_report["e2e_s"]["p99"]
    base_p99s = [before_report["e2e_s"]["p99"], after_report["e2e_s"]["p99"]]
    if p99 is None or None in base_p99s:
        raise AssertionError("hotswap smoke: empty latency report")
    base_p99 = sum(base_p99s) / len(base_p99s)
    gate = P99_FACTOR * base_p99 + P99_SLACK_S
    if p99 > gate:
        raise AssertionError(
            f"hotswap smoke: p99 across the swap window {p99:.4f}s exceeds the gate "
            f"{gate:.4f}s ({P99_FACTOR}x no-swap {base_p99:.4f}s + {P99_SLACK_S}s)")
    return {
        "requests": swap_report["requests"],
        "tokens_per_sec": swap_report["tokens_per_sec"],
        "swaps": len(done),
        "swap_s": [e["swap_s"] for e in done],
        "rejected": len(rejected),
        "final_step": final_step,
        "token_equal": True,
        "probe_requests": len(probe),
        "params_bytes": params_bytes,
        "fetched_bytes": fetched,
        "reused_bytes": reused,
        "p99_e2e_s": round(p99, 6),
        "noswap_p99_e2e_s": round(base_p99, 6),
        "noswap_p99_before_after_s": [round(x, 6) for x in base_p99s],
        "p99_gate_s": round(gate, 6),
        "duration_s": duration_s,
        "live_scrape": {"url": f"http://{target}",
                        "mid": live_scrape_digest(scrapes["mid"]),
                        "final": live_scrape_digest(scrapes["final"])},
    }


# ---- kill-mid-swap chaos drill ----------------------------------------------


def _server_cmd(exp, status, cfg, device, *, manifest=None, watch=False, exit_after_swap=False):
    cmd = [sys.executable, "-m", "pyrecover_tpu_torch.serving.hotswap.drill",
           "--serve", str(exp), "--status", str(status), "--device", device.type,
           "--model-config", json.dumps(dataclasses.asdict(cfg))]
    if manifest is not None:
        cmd += ["--manifest", str(manifest)]
    if watch:
        cmd.append("--watch")
    if exit_after_swap:
        cmd.append("--exit-after-swap")
    return cmd


def _spawn_server(exp, status, cfg, device, *, fault_plan=None, **kw):
    env = dict(os.environ)
    env.pop("PYRECOVER_METRICS_PORT", None)
    if fault_plan is not None:
        env["PYRECOVER_FAULT_PLAN"] = json.dumps(fault_plan)
    else:
        env.pop("PYRECOVER_FAULT_PLAN", None)
    return subprocess.Popen(_server_cmd(exp, status, cfg, device, **kw), env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)


def _scan_status(status_path, event):
    status_path = Path(status_path)
    if not status_path.exists():
        return None
    for line in status_path.read_text().splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # the torn tail of an append mid-write
        if rec.get("event") == event:
            return rec
    return None


def _wait_status(status_path, event, proc, *, timeout_s=120.0):
    """Tail the server's status JSONL for the first ``event`` record. Raises
    if the server dies without writing it, or on timeout."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        rec = _scan_status(status_path, event)
        if rec is not None:
            return rec
        if proc.poll() is not None:
            # one last read: the record may have landed just before exit
            rec = _scan_status(status_path, event)
            if rec is not None:
                return rec
            raise AssertionError(f"hotswap drill: server died (rc {proc.returncode}) before "
                                 f"reporting {event!r}")
        time.sleep(0.05)
    raise TimeoutError(f"hotswap drill: no {event!r} status within {timeout_s}s")


def _stop_server(proc, *, kill=True):
    if proc.poll() is None:
        proc.kill() if kill else proc.terminate()
    proc.wait(timeout=60)


def hotswap_chaos_drill(workdir, *, timeout_s=180.0, model_config=None, device="cuda"):
    """SIGKILL a serving process mid-swap; prove zero torn state (the module
    docstring's verdicts). Returns the report dict; raises AssertionError on
    any violation."""
    from pyrecover_tpu_torch.checkpoint.zerostall import pins
    from pyrecover_tpu_torch.checkpoint.zerostall.chunkstore import (
        chunks_root,
        collect_garbage,
        referenced_digests,
    )
    from pyrecover_tpu_torch.resilience.quarantine import list_quarantined
    from pyrecover_tpu_torch.serving.engine import ServingEngine
    from pyrecover_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    cfg = model_config or drill_model_config()
    workdir = Path(workdir)
    exp = workdir / "chaos_exp"
    exp.mkdir(parents=True, exist_ok=True)
    model, optimizer = _train_state(cfg, SEED, device)
    path1 = save_zs(exp, 1, model, optimizer)
    probe = probe_workload(cfg)
    # the parent's ground truth for manifest 1 (a cold restore)
    probe_a = run_probe(ServingEngine(_restore(path1, cfg, device), _serving_config()), probe)

    # 1) a server serves manifest 1 with its watcher armed and is killed
    # mid-fetch: the swap_fetch seam fires on the FIRST chunk the swap toward
    # manifest 2 reads (save_index 0: a serving process never saves)
    status1 = workdir / "status_kill.jsonl"
    plan = {"seed": SEED, "faults": [{"type": "kill9_during_save", "save_index": 0,
                                      "site": "swap_fetch"}]}
    proc = _spawn_server(exp, status1, cfg, device, watch=True, fault_plan=plan)
    try:
        ready = _wait_status(status1, "ready", proc, timeout_s=timeout_s)
        if ready["step"] != 1 or ready["probe"] != probe_a:
            raise AssertionError(f"hotswap drill: pre-kill server served {ready['step']} with "
                                 "drifted probe tokens")
        perturb(model, 2)
        path2 = save_zs(exp, 2, model, optimizer)
        rc = proc.wait(timeout=timeout_s)
    finally:
        _stop_server(proc)
    if rc != -9:
        raise AssertionError(f"hotswap drill: expected the swap_fetch SIGKILL (rc -9), got rc {rc}")

    # 2) torn-state forensics: the pin lease survived the kill, GC with the
    # pin held collects nothing a manifest needs, nothing was quarantined,
    # and the killed server's trail shows a begin without a done
    pinned = [p.name for p in pins.live_pins(exp)]
    if not any(path2.name in name for name in pinned):
        raise AssertionError(f"hotswap drill: no pin lease for {path2.name} after the mid-fetch "
                             f"kill (pins: {pinned})")
    collect_garbage(exp)
    refs = referenced_digests(exp)
    on_disk = {p.name for p in chunks_root(exp).rglob("*") if p.is_file()}
    missing = sorted(refs - on_disk)
    if missing:
        raise AssertionError(f"hotswap drill: {len(missing)} referenced chunk(s) gone after GC "
                             f"with a pin held (e.g. {missing[:3]})")
    quarantined = [p.name for p in list_quarantined(exp)]
    if quarantined:
        raise AssertionError(f"hotswap drill: kill mid-swap quarantined {quarantined}")
    server_events = telemetry.read_events(exp / "server_telemetry.jsonl")
    begins = [e for e in server_events
              if e["event"] == "weights_swap_begin" and e.get("to_step") == 2]
    dones = [e for e in server_events if e["event"] == "weights_swap_done" and e.get("step") == 2]
    kills = [e for e in server_events
             if e["event"] == "fault_injected" and e.get("site") == "swap_fetch"]
    if not begins or dones or not kills:
        raise AssertionError(f"hotswap drill: torn telemetry trail — begins={len(begins)} "
                             f"dones={len(dones)} kills={len(kills)}")

    # 3) a restart serving the OLD manifest: the same probe tokens, every
    # chunk digest-verified on read
    status2 = workdir / "status_old.jsonl"
    proc2 = _spawn_server(exp, status2, cfg, device, manifest=path1)
    try:
        ready2 = _wait_status(status2, "ready", proc2, timeout_s=timeout_s)
    finally:
        _stop_server(proc2, kill=False)
    if ready2["step"] != 1 or ready2["probe"] != probe_a:
        raise AssertionError("hotswap drill: restart on the old manifest did not reproduce the "
                             "pre-kill serving output")

    # 4) a restarted watcher completes the interrupted swap
    probe_b = run_probe(ServingEngine(_restore(path2, cfg, device), _serving_config()), probe)
    status3 = workdir / "status_resume.jsonl"
    proc3 = _spawn_server(exp, status3, cfg, device, manifest=path1, watch=True,
                          exit_after_swap=True)
    try:
        swapped = _wait_status(status3, "swapped", proc3, timeout_s=timeout_s)
        rc3 = proc3.wait(timeout=timeout_s)
    finally:
        _stop_server(proc3)
    if swapped["step"] != 2 or swapped["probe"] != probe_b:
        raise AssertionError("hotswap drill: the restarted watcher's swap does not match a cold "
                             "restore of the target manifest")
    if rc3 != 0:
        raise AssertionError(f"hotswap drill: resume server exited rc {rc3}")

    # 5) the dead fetcher's lease expires (TTL forced to zero) and a last GC
    # leaves exactly the live manifests' chunks: the kill leaked nothing
    pins.expire_stale_pins(exp, ttl_s=0.0)
    collect_garbage(exp)
    refs = referenced_digests(exp)
    on_disk = {p.name for p in chunks_root(exp).rglob("*") if p.is_file()}
    leaked, missing = sorted(on_disk - refs), sorted(refs - on_disk)
    if leaked or missing:
        raise AssertionError(f"hotswap drill: chunk ledger broken after lease expiry (leaked "
                             f"{leaked[:3]}, missing {missing[:3]})")
    return {
        "kill_rc": rc,
        "pin_after_kill": pinned,
        "old_manifest_probe_equal": True,
        "resumed_swap_step": int(swapped["step"]),
        "resumed_swap_probe_equal": True,
        "quarantined": quarantined,
        "chunks_on_disk": len(on_disk),
        "chunks_referenced": len(refs),
        "chunks_leaked": len(leaked),
        "swap_begins_before_kill": len(begins),
        "swap_fetch_kills": len(kills),
    }


# ---- the drill's server process ---------------------------------------------


def _append_status(path, record):
    # an append-only status stream; the parent's reader skips a torn tail
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
        f.flush()


def _serve_main(args):
    """The drill's serving process: load a manifest, report a probe
    fingerprint, optionally watch and swap. Status protocol (JSONL):
    ``{"event": "ready", "step", "probe"}`` once serving, then one
    ``{"event": "swapped", "step", "probe"}`` a completed swap."""
    from pyrecover_tpu_torch.checkpoint.registry import get_latest_checkpoint, parse_step
    from pyrecover_tpu_torch.models.llama import ModelConfig
    from pyrecover_tpu_torch.serving.engine import ServingEngine
    from pyrecover_tpu_torch.serving.hotswap.swap import HotSwapper
    from pyrecover_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = ModelConfig(**json.loads(args.model_config)) if args.model_config \
        else drill_model_config()
    exp = Path(args.serve)
    sink = telemetry.JsonlSink(exp / "server_telemetry.jsonl")
    telemetry.add_sink(sink)
    try:
        path = Path(args.manifest) if args.manifest else get_latest_checkpoint(exp)
        if path is None:
            print(f"no checkpoint in {exp}", file=sys.stderr)
            return 2
        host = {}
        engine = ServingEngine(_restore(path, cfg, device, host), _serving_config())
        probe = probe_workload(cfg)
        _append_status(args.status, {"event": "ready", "step": parse_step(path),
                                     "probe": run_probe(engine, probe)})
        if not args.watch:
            return 0
        swapper = HotSwapper(engine, exp, cfg, loaded_path=path, loaded_host=host,
                             poll_interval_s=args.poll)
        engine.start()
        swapper.start()
        try:
            reported = swapper.loaded_step
            deadline = time.monotonic() + args.serve_s
            while time.monotonic() < deadline:
                time.sleep(args.poll)
                step = swapper.loaded_step
                if step > reported:
                    # through the live engine: the staged swap applies at
                    # its next pass, and results reflect the new weights
                    _append_status(args.status, {"event": "swapped", "step": step,
                                                 "probe": run_probe(engine, probe)})
                    reported = step
                    if args.exit_after_swap:
                        return 0
        finally:
            swapper.stop()
            engine.stop()
        return 0
    finally:
        telemetry.remove_sink(sink)
        sink.close()


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--serve", required=True, help="experiment dir to serve from")
    ap.add_argument("--status", required=True, help="status JSONL the parent drill tails")
    ap.add_argument("--manifest", default=None,
                    help="serve this checkpoint (default: the registry's latest)")
    ap.add_argument("--watch", action="store_true", help="run the hot-swap watcher after ready")
    ap.add_argument("--exit-after-swap", action="store_true",
                    help="exit 0 after reporting the first completed swap")
    ap.add_argument("--poll", type=float, default=0.05)
    ap.add_argument("--serve-s", type=float, default=300.0,
                    help="watch-mode serving window before a clean exit")
    ap.add_argument("--device", default="cuda",
                    help="the device to serve on (the card unless cpu is asked for)")
    ap.add_argument("--model-config", default=None,
                    help="the ModelConfig's fields as JSON (default: the tiny fp32 model)")
    return _serve_main(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
