"""Serving-replica subprocess: one ``ServingEngine`` and ``HotSwapper``
behind a fleet socket (the JAX package's ``serving/fleet/replica.py``).

``python -m pyrecover_tpu_torch.serving.fleet.replica --exp DIR --status
FILE [--manifest PATH] [--device cpu] [--model-config JSON]`` loads the
latest (or the ``--manifest``) checkpoint onto the card (the CPU only when
``--device cpu`` is asked for; a replica asked for the card that finds none
raises), warms the engine, starts its background loop, opens a TCP listener
on an ephemeral port, and reports readiness to the status JSONL the
supervisor tails::

    {"event": "ready", "replica", "port", "metrics_port", "pid", "step",
     "restore_s", "warm_s"}

(``restore_s`` and ``warm_s``: the restore's and the warm-up request's
seconds). The replica then serves the fleet protocol (:mod:`protocol`):
``submit`` feeds the engine and a completer thread pushes ``done`` frames
back as results finish; ``probe`` serves the hot-swap drill's probe
(``hotswap.drill.probe_workload``, seeded by ``hotswap.drill.SEED``, 0; the
message's ``seed`` is read by the JAX package's replica only, and the
reply's ``seed`` says which probe ran) through the live engine and reports
tokens and per-request e2e latency; ``swap`` drives the hot-swapper's
``swap_to`` (the rollout controller owns *when*: no watcher runs);
``status`` snapshots queue depth, the loaded step and ``peak_mem_bytes``,
the caching allocator's peak on the card (``torch.cuda.max_memory_allocated``;
0 on the CPU); ``shutdown`` exits cleanly. ``--model-config`` takes the
``ModelConfig``'s fields as JSON (default: the drills' tiny fp32 model).

Chaos seam: after every request completes, but before its ``done`` is
reported, the replica fires ``faults.check("replica_kill", replica=...,
written=<completed count>)``. The ``kill9_during_save`` fault type announces
``fault_injected`` to the replica's telemetry shard and then SIGKILLs the
process, so a kill always orphans the triggering request: the chaos drill
kills a replica mid-flight with an auditable trail and a certain redrive.
Exit codes: 0 clean, 2 no checkpoint to serve (the crash-loop drill's fast
failure, before any work on the card).
"""

import argparse
import json
import os
import socket
import sys
import threading
import time
from pathlib import Path

from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.resilience import faults
from pyrecover_tpu_torch.serving.fleet.protocol import Connection
from pyrecover_tpu_torch.telemetry import tracing

_PROBE_TIMEOUT_S = 120.0
# the serving window before a clean exit (the JAX replica's --serve-s default)
SERVE_S = 600.0


class _ReplicaState:
    """Cross-thread state shared by the connection handler (reader thread)
    and the completer thread. Everything mutable lives behind ``lock``;
    ``stop`` is the process-wide shutdown latch."""

    def __init__(self, replica_id):
        self.replica_id = replica_id
        self.lock = threading.Lock()
        self.outstanding = {}  # engine rid -> fleet rid
        self.traces = {}       # engine rid -> wire TraceContext | None
        self.completed = 0
        self.stop = threading.Event()


def peak_mem_bytes(device):
    """The caching allocator's peak on ``device`` (0 on the CPU)."""
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def _probe_with_latency(engine, probe):
    """Serve the probe through the live engine: the token lists in
    submission order and each request's e2e seconds (submit to done)."""
    t0 = {}
    rids = []
    for req in probe:
        rid = engine.submit(req["prompt"], req["max_new_tokens"])
        t0[rid] = time.monotonic()
        rids.append(rid)
    e2e = {}
    deadline = time.monotonic() + _PROBE_TIMEOUT_S
    while len(e2e) < len(rids):
        for rid in rids:
            if rid not in e2e and engine.result(rid) is not None:
                e2e[rid] = time.monotonic() - t0[rid]
        if time.monotonic() > deadline:
            raise TimeoutError("fleet replica: probe did not drain")
        time.sleep(0.002)
    return [engine.result(r) for r in rids], [e2e[r] for r in rids]


def _handle(msg, conn, *, state, engine, swapper, cfg):
    """Dispatch one inbound fleet message (runs on the reader thread)."""
    from pyrecover_tpu_torch.serving.hotswap.drill import SEED, probe_workload

    kind = msg.get("type")
    if kind == "submit":
        # decode and install the wire trace context: the socket-edge
        # fleet_recv marker pairs with the router's fleet_send for skew
        # alignment, and the installed context makes the engine's buffered
        # req_* spans children of this dispatch attempt
        ctx = tracing.from_wire(msg.get("trace"))
        if ctx is not None:
            telemetry.emit("fleet_recv", rid=msg["rid"], kind="submit", attempt=ctx.attempt,
                           trace=ctx.trace, mono=round(time.monotonic(), 6))
        with tracing.installed(ctx):
            erid = engine.submit(msg["prompt"], msg["max_new_tokens"])
        with state.lock:
            state.outstanding[erid] = msg["rid"]
            state.traces[erid] = ctx
    elif kind == "probe":
        tokens, e2e = _probe_with_latency(engine, probe_workload(cfg))
        conn.send({"type": "probe_result", "tokens": tokens, "e2e_s": e2e, "seed": SEED})
    elif kind == "swap":
        path = Path(msg["manifest"])
        ok = swapper.swap_to(path)
        reason = "" if ok else swapper.rejected.get(path.name, "unknown")
        conn.send({"type": "swap_result", "ok": bool(ok), "step": swapper.loaded_step,
                   "reason": reason})
    elif kind == "status":
        with state.lock:
            completed = state.completed
        conn.send({"type": "status_result", "pending": engine.pending, "completed": completed,
                   "loaded_step": swapper.loaded_step, "rejected": len(swapper.rejected),
                   "peak_mem_bytes": peak_mem_bytes(engine.device)})
    elif kind == "shutdown":
        state.stop.set()


def _completer(state, engine, conn, conn_done):
    """Poll finished engine results and push ``done`` frames back to the
    router. The ``replica_kill`` seam fires after a result is computed but
    BEFORE it is reported, so a kill always leaves work the dead replica
    still owns: everything reported is done, the triggering request (and
    anything behind it) is the router's to redrive."""
    while not conn_done.is_set() and not state.stop.is_set():
        with state.lock:
            items = list(state.outstanding.items())
        for erid, rid in items:
            tokens = engine.result(erid)
            if tokens is None:
                continue
            with state.lock:
                state.completed += 1
                completed = state.completed
                ctx = state.traces.get(erid)
            faults.check("replica_kill", replica=state.replica_id, written=completed)
            # the marker AFTER the kill seam: a killed request leaves no
            # done-side send, so its wire legs stay unpaired
            msg = {"type": "done", "rid": rid, "tokens": tokens}
            if ctx is not None:
                telemetry.emit("fleet_send", rid=rid, kind="done", attempt=ctx.attempt,
                               trace=ctx.trace, mono=round(time.monotonic(), 6))
                msg["trace"] = ctx.to_wire()
            try:
                conn.send(msg)
            except OSError:
                return  # the router is gone; the connection loop winds down
            with state.lock:
                state.outstanding.pop(erid, None)
                state.traces.pop(erid, None)
        time.sleep(0.002)


def serve(args):
    from pyrecover_tpu_torch.checkpoint.registry import get_latest_checkpoint, parse_step

    exp = Path(args.exp)
    telem_path = (Path(args.telemetry) if args.telemetry
                  else exp / f"replica_{args.replica_id}_telemetry.jsonl")
    sink = telemetry.JsonlSink(telem_path)
    telemetry.add_sink(sink)
    try:
        path = Path(args.manifest) if args.manifest else get_latest_checkpoint(exp)
        if path is None:
            # fast failure before any work on the card: the crash-loop
            # drill's repeatable rc-2 mode
            print(f"fleet replica: no checkpoint in {exp}", file=sys.stderr)
            return 2
        return _serve_checkpoint(args, exp, path, parse_step(path))
    finally:
        telemetry.remove_sink(sink)
        sink.close()


def _serve_checkpoint(args, exp, path, step):
    from pyrecover_tpu_torch.models.llama import ModelConfig
    from pyrecover_tpu_torch.serving.engine import ServingEngine
    from pyrecover_tpu_torch.serving.hotswap.drill import (
        _append_status,
        _restore,
        _serving_config,
        drill_model_config,
    )
    from pyrecover_tpu_torch.serving.hotswap.swap import HotSwapper
    from pyrecover_tpu_torch.telemetry.exporter import MetricsExporter
    from pyrecover_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = (ModelConfig(**json.loads(args.model_config)) if args.model_config
           else drill_model_config())
    host = {}
    t0 = time.monotonic()
    engine = ServingEngine(_restore(path, cfg, device, host), _serving_config())
    t_restored = time.monotonic()
    # warm the engine outside any measured window
    engine.submit([1, 2, 3], 2)
    engine.run_until_drained()
    t_warm = time.monotonic()
    engine.start()
    # the rollout controller drives swaps over the wire; no watcher
    swapper = HotSwapper(engine, exp, cfg, loaded_path=path, loaded_host=host)
    exporter = MetricsExporter(port=0).start()
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(4)
    lsock.settimeout(0.2)
    state = _ReplicaState(args.replica_id)
    _append_status(args.status, {
        "event": "ready", "replica": args.replica_id, "port": lsock.getsockname()[1],
        "metrics_port": exporter.port, "pid": os.getpid(), "step": step,
        "restore_s": round(t_restored - t0, 3), "warm_s": round(t_warm - t_restored, 3)})
    deadline = time.monotonic() + SERVE_S
    try:
        while not state.stop.is_set() and time.monotonic() < deadline:
            try:
                csock, _ = lsock.accept()
            except socket.timeout:
                continue
            conn_done = threading.Event()

            def handler(msg, conn):
                _handle(msg, conn, state=state, engine=engine, swapper=swapper, cfg=cfg)

            conn = Connection(csock, handler, name=f"replica{args.replica_id}",
                              on_eof=lambda _c: conn_done.set())
            pump = threading.Thread(target=_completer, args=(state, engine, conn, conn_done),
                                    name=f"fleet-completer-{args.replica_id}", daemon=True)
            pump.start()
            while not conn_done.is_set() and not state.stop.is_set():
                if time.monotonic() > deadline:
                    break
                conn_done.wait(0.2)
            conn_done.set()
            pump.join(10.0)
            if pump.is_alive():
                raise TimeoutError("fleet replica: completer did not exit")
            conn.close()
    finally:
        lsock.close()
        engine.stop()
        exporter.stop()
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--exp", required=True, help="experiment dir to serve checkpoints from")
    ap.add_argument("--status", required=True,
                    help="status JSONL the supervisor tails for readiness")
    ap.add_argument("--manifest", default=None,
                    help="serve this checkpoint (default: the registry's latest)")
    ap.add_argument("--replica-id", type=int, default=0)
    ap.add_argument("--telemetry", default=None, help="per-replica telemetry shard (JSONL)")
    ap.add_argument("--device", default="cuda",
                    help="the device to serve on (the card unless cpu is asked for)")
    ap.add_argument("--model-config", default=None,
                    help="the ModelConfig's fields as JSON (default: the tiny fp32 model)")
    return serve(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
