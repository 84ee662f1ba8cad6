"""The port's serving fleet (``pyrecover_tpu_torch/serving/fleet/``) held to
the JAX package's: every case of ``tests/test_fleet.py`` against the port
(the supervisor over fake replica processes, router admission with no
replica attached, the loadgen split, deterministic request ids, the
submit-after-stop error, the event catalog), then the two packages side by
side in one process: both supervisors driven by the same scripted deaths on
a fake clock walk the same states, backoff delays and events; both routers
over the same fake replicas (TCP listeners this test answers for) make the
same dispatch, queue, redrive and shed decisions with the same accounting
and events; a JAX ``Connection`` and a port ``Connection`` exchange frames
across one socketpair; and the port's link, unlike the reference's, stays up
when idle past its dial timeout. The replica-process drills are in
``test_torch_fleet_drill.py`` and ``test_torch_fleet_canary.py``."""

import json
import socket
import threading
import time
from pathlib import Path

import pytest
import torch

from pyrecover_tpu import telemetry as jax_telemetry
from pyrecover_tpu.resilience import faults as jax_faults
from pyrecover_tpu.serving.fleet import protocol as jax_protocol
from pyrecover_tpu.serving.fleet import router as jax_router_mod
from pyrecover_tpu.serving.fleet import supervisor as jax_supervisor_mod
from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.resilience import faults
from pyrecover_tpu_torch.serving.fleet import protocol
from pyrecover_tpu_torch.serving.fleet import router as router_mod
from pyrecover_tpu_torch.serving.fleet import supervisor as supervisor_mod
from pyrecover_tpu_torch.serving.fleet.supervisor import (
    BACKOFF,
    QUARANTINED,
    READY,
    SPAWNING,
    ReplicaSupervisor,
)

REPO = Path(__file__).resolve().parent.parent
PORT_HEADER = "| port event | fields | emitted by |"
FLEET_EVENTS = ("replica_spawned", "replica_dead", "replica_quarantined", "request_redriven",
                "fleet_shed", "canary_verdict", "trace_root", "trace_exemplar", "fleet_send",
                "fleet_recv")


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.delenv(faults.PLAN_ENV, raising=False)
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()
    torch.set_num_threads(threads)


@pytest.fixture()
def mem_sink():
    mem = telemetry.MemorySink()
    telemetry.add_sink(mem)
    yield mem
    telemetry.remove_sink(mem)


@pytest.fixture()
def both_sinks():
    """A memory sink on each package's bus: ``(port, jax)``."""
    port, ref = telemetry.MemorySink(), jax_telemetry.MemorySink()
    telemetry.add_sink(port)
    jax_telemetry.add_sink(ref)
    yield port, ref
    telemetry.remove_sink(port)
    jax_telemetry.remove_sink(ref)


def _events(mem, name):
    return [e for e in mem.events if e["event"] == name]


# ---- fake replica processes ---------------------------------------------------


class _FakeProc:
    """Popen-shaped stand-in the supervisor's injected mechanics drive."""

    def __init__(self, pid):
        self.pid = pid
        self.returncode = None

    def poll(self):
        return self.returncode

    def die(self, rc):
        self.returncode = rc

    def terminate(self):
        if self.returncode is None:
            self.returncode = -15

    def kill(self):
        if self.returncode is None:
            self.returncode = -9


class _Harness:
    """Injected spawn/ready_check over fake processes; incarnations in
    ``self.ready`` pass the readiness probe, ``die_at_spawn`` ones are born
    dead (the crash-loop shape)."""

    def __init__(self, *, die_at_spawn=False, rc=2):
        self.lock = threading.Lock()
        self.procs = {}  # (slot, incarnation) -> _FakeProc
        self.ready = set()
        self.die_at_spawn = die_at_spawn
        self.rc = rc

    def spawn(self, slot, incarnation):
        proc = _FakeProc(pid=1000 * (slot + 1) + incarnation)
        if self.die_at_spawn:
            proc.die(self.rc)
        with self.lock:
            self.procs[(slot, incarnation)] = proc
        return proc

    def ready_check(self, slot, incarnation, proc):
        with self.lock:
            if (slot, incarnation) in self.ready:
                return {"slot": slot, "incarnation": incarnation, "port": 1}
        return None

    def mark_ready(self, slot, incarnation):
        with self.lock:
            self.ready.add((slot, incarnation))

    def proc(self, slot, incarnation):
        with self.lock:
            return self.procs[(slot, incarnation)]


def _wait(pred, timeout_s=10.0, msg="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.005)
    raise TimeoutError(f"fleet test: {msg} not reached in {timeout_s}s")


# ---- the supervisor state machine (tests/test_fleet.py's cases) ---------------


def test_supervisor_spawn_ready_death_respawn(mem_sink):
    """SPAWNING -> READY -> death -> BACKOFF -> respawn -> READY, with the
    ready and death callbacks and both events observed."""
    h = _Harness()
    readies, deaths = [], []
    sup = ReplicaSupervisor(
        1, h.spawn, h.ready_check,
        on_ready=lambda s, info: readies.append((s, info["incarnation"])),
        on_death=lambda s, rc, was_ready: deaths.append((s, rc, was_ready)),
        backoff_base_s=0.01, backoff_max_s=0.05, poll_interval_s=0.005)
    sup.start()
    try:
        assert sup.state(0) in (SPAWNING, READY)
        h.mark_ready(0, 0)
        _wait(lambda: sup.state(0) == READY, msg="first READY")
        assert readies == [(0, 0)]
        assert sup.info(0)["incarnation"] == 0
        h.proc(0, 0).die(-9)
        h.mark_ready(0, 1)  # let the respawn come up
        _wait(lambda: sup.state(0) == READY and sup.spawns(0) == 2, msg="respawned READY")
        assert deaths == [(0, -9, True)]
        assert sup.last_rc(0) is None  # cleared by the respawn
        assert readies == [(0, 0), (0, 1)]
    finally:
        sup.stop()
    dead = _events(mem_sink, "replica_dead")
    assert [(e["replica"], e["rc"], e["was_ready"]) for e in dead] == [(0, -9, True)]
    spawned = _events(mem_sink, "replica_spawned")
    assert [e["incarnation"] for e in spawned if e["replica"] == 0] == [0, 1]
    assert h.proc(0, 1).returncode is not None  # stop() terminated the respawn


def test_supervisor_backoff_is_capped_exponential(mem_sink):
    """Each respawn's announced backoff walks min(base * 2^k, max)."""
    h = _Harness(die_at_spawn=True, rc=1)
    sup = ReplicaSupervisor(1, h.spawn, h.ready_check, backoff_base_s=0.01,
                            backoff_max_s=0.04, quarantine_after=10, poll_interval_s=0.002)
    sup.start()
    try:
        _wait(lambda: sup.spawns(0) >= 5, msg="5 spawns")
    finally:
        sup.stop()
    backoffs = [e["backoff_s"] for e in _events(mem_sink, "replica_spawned")][:5]
    assert backoffs == [0.0, 0.01, 0.02, 0.04, 0.04]


def test_supervisor_quarantines_crash_looper(mem_sink):
    """Deaths before READY are strikes; after exactly quarantine_after
    spawns the slot parks in QUARANTINED and is never respawned."""
    h = _Harness(die_at_spawn=True, rc=2)
    sup = ReplicaSupervisor(1, h.spawn, h.ready_check, backoff_base_s=0.005,
                            backoff_max_s=0.02, quarantine_after=3, poll_interval_s=0.002)
    sup.start()
    try:
        _wait(lambda: sup.state(0) == QUARANTINED, msg="quarantine")
        assert sup.spawns(0) == 3
        assert sup.last_rc(0) == 2
        time.sleep(0.1)  # a parked slot stays parked
        assert sup.spawns(0) == 3
        assert sup.state(0) == QUARANTINED
    finally:
        sup.stop()
    q = _events(mem_sink, "replica_quarantined")
    assert len(q) == 1 and q[0]["strikes"] == 3 and q[0]["rc"] == 2
    assert len(_events(mem_sink, "replica_dead")) == 3


def test_supervisor_ready_resets_strikes(mem_sink):
    """Two pre-ready strikes, then READY (strikes reset), then a post-ready
    death: no quarantine."""
    h = _Harness()
    sup = ReplicaSupervisor(1, h.spawn, h.ready_check, backoff_base_s=0.005,
                            backoff_max_s=0.02, quarantine_after=3, poll_interval_s=0.002)
    sup.start()
    try:
        for inc in (0, 1):  # two strikes
            _wait(lambda i=inc: (0, i) in h.procs, msg=f"spawn {inc}")
            h.proc(0, inc).die(1)
            _wait(lambda i=inc: sup.spawns(0) == i + 2 or sup.state(0) == QUARANTINED,
                  msg=f"respawn {inc + 1}")
        assert sup.state(0) != QUARANTINED
        h.mark_ready(0, 2)
        _wait(lambda: sup.state(0) == READY, msg="READY on the third try")
        h.proc(0, 2).die(-9)  # a post-ready death is not a strike
        _wait(lambda: sup.spawns(0) == 4, msg="respawn after the ready death")
        assert sup.state(0) in (SPAWNING, BACKOFF)
    finally:
        sup.stop()
    assert not _events(mem_sink, "replica_quarantined")
    assert [e["was_ready"] for e in _events(mem_sink, "replica_dead")] == [False, False, True]


def test_supervisor_stop_terminates_live_replicas():
    """stop() joins the monitor (bounded) and terminates every live fake
    process."""
    h = _Harness()
    sup = ReplicaSupervisor(2, h.spawn, h.ready_check, poll_interval_s=0.005)
    sup.start()
    h.mark_ready(0, 0)
    h.mark_ready(1, 0)
    _wait(lambda: all(s == READY for s in sup.states().values()), msg="both READY")
    sup.stop(timeout=10.0)
    assert h.proc(0, 0).returncode == -15
    assert h.proc(1, 0).returncode == -15
    assert sup._thread is None


# ---- router admission, loadgen, engine, catalog (tests/test_fleet.py) -----------


def test_router_admission_queue_then_shed_then_dup(mem_sink):
    router = router_mod.FleetRouter(max_inflight=8, max_queue=1)
    req = {"rid": "r-0", "prompt": [1, 2], "max_new_tokens": 2}
    assert router.submit(req) == "queued"  # no replicas: it waits
    assert router.submit(dict(req)) == "dup"  # deterministic rid dedup
    assert router.submit({"rid": "r-1", "prompt": [3], "max_new_tokens": 1}) == "shed"
    shed = _events(mem_sink, "fleet_shed")
    assert [e["rid"] for e in shed] == ["r-1"]
    assert shed[0]["replicas"] == 0 and shed[0]["queued"] == 1
    assert router.accounting() == {"submitted": 2, "done": 0, "shed": 1, "queued": 1,
                                   "inflight": 0, "redriven": 0, "redriven_rids": 0}
    router.close()


def test_split_workload_is_an_exact_partition_of_the_poisson_process():
    from pyrecover_tpu_torch.serving.loadgen import open_loop_workload

    kw = dict(vocab_size=64, max_model_len=96, seed=7, arrival_rate=200.0)
    single = open_loop_workload(1.0, **kw)
    streams = open_loop_workload(1.0, targets=3, **kw)
    assert len(streams) == 3
    assert sum(len(s) for s in streams) == len(single)
    assert sorted((r for s in streams for r in s), key=lambda r: r["arrival_s"]) == single
    rids = [r["rid"] for s in streams for r in s]
    assert len(set(rids)) == len(rids)
    assert open_loop_workload(1.0, targets=3, **kw) == streams


def test_request_ids_are_deterministic_and_distinct():
    from pyrecover_tpu.serving.loadgen import request_id as jax_request_id
    from pyrecover_tpu_torch.serving.loadgen import request_id

    assert request_id(3, 11) == request_id(3, 11) == jax_request_id(3, 11)
    assert request_id(3, 11) != request_id(3, 12)
    assert request_id(3, 11) != request_id(4, 11)
    assert isinstance(request_id(0, 0), str)


def test_submit_after_stop_raises_typed_error():
    """A stopped engine refuses new work with EngineStoppedError (the
    router's redrive signal); reopen() re-arms manual pumping."""
    from pyrecover_tpu_torch.serving.engine import EngineStoppedError, ServingEngine
    from pyrecover_tpu_torch.serving.hotswap import drill

    model, _ = drill._train_state(drill.drill_model_config(), 0, torch.device("cpu"))
    engine = ServingEngine(model, drill._serving_config())
    engine.start()
    engine.stop()
    with pytest.raises(EngineStoppedError):
        engine.submit([1, 2, 3], 2)
    engine.reopen()
    rid = engine.submit([1, 2, 3], 2)
    engine.run_until_drained()
    assert engine.result(rid) is not None


def test_fleet_events_are_cataloged():
    """Every fleet event has an emit site in the port and an entry in the
    port's telemetry docstring and in the README's port event table; the
    router's spans have their sites."""
    from pyrecover_tpu.analysis import obscheck

    lines = (REPO / "README.md").read_text(encoding="utf-8").splitlines()
    start = lines.index(PORT_HEADER)
    table = ["| event | fields | emitted by |"]
    for line in lines[start + 1:]:
        if not line.startswith("|"):
            break
        table.append(line)
    m = obscheck.build_model([str(REPO / "pyrecover_tpu_torch")],
                             obscheck.ObsConfig(readme_text="\n".join(table) + "\n"))
    for name in FLEET_EVENTS:
        assert name in m.sites_by_event, f"{name}: no emit site in the port"
        assert name in m.doc_catalog, f"{name}: not in the port's telemetry docstring"
        assert name in m.readme_catalog, f"{name}: not in the README's port event table"
    for name in ("req_root", "fleet_attempt", "swap_stall"):
        assert name in m.span_names, f"{name}: no span site in the port"


def test_version_is_the_jax_packages():
    import pyrecover_tpu
    import pyrecover_tpu_torch

    assert pyrecover_tpu_torch.__version__ == pyrecover_tpu.__version__


# ---- the two supervisors on one script ---------------------------------------


class _Clock:
    """A fake ``time`` module: ``monotonic`` reads ``now``, ``sleep``
    advances it."""

    def __init__(self):
        self.now = 100.0

    def monotonic(self):
        return self.now

    def sleep(self, s):
        self.now += s


def _scripted_supervisor(pkg_mod, clock):
    """Drive one package's supervisor through a fixed script of readiness
    and deaths on the fake clock, ticking by hand (no monitor thread).
    Returns the trail: ``(step, states, backoff delays, spawns)`` after each
    action."""
    h = _Harness()
    sup = pkg_mod.ReplicaSupervisor(2, h.spawn, h.ready_check, backoff_base_s=0.05,
                                    backoff_max_s=0.15, quarantine_after=3)
    trail = []

    def tick(label):
        for slot in (0, 1):
            sup._tick_slot(slot)
        with sup._lock:
            delays = {s: round(r["resume_at"] - clock.now, 6) if r["state"] == BACKOFF
                      else None for s, r in sup._slots.items()}
        trail.append((label, sup.states(), delays, {s: sup.spawns(s) for s in (0, 1)}))

    for slot in (0, 1):
        sup._spawn_slot(slot, backoff_s=0.0)
    tick("start")
    h.mark_ready(0, 0)
    tick("r0 ready")
    for inc in (0, 1, 2):  # slot 1 crash-loops: three strikes
        h.proc(1, inc).die(2)
        tick(f"r1.{inc} dies")
        if inc < 2:
            clock.sleep(0.2)
            tick(f"r1 backoff over {inc}")
    h.proc(0, 0).die(-9)  # a ready replica dies
    tick("r0 killed")
    clock.sleep(0.01)
    tick("r0 early")  # its backoff has not run out
    clock.sleep(0.1)
    h.mark_ready(0, 1)
    tick("r0 respawned")
    tick("r0 ready again")
    return trail


def test_both_supervisors_walk_the_same_script(both_sinks, monkeypatch):
    port_sink, jax_sink = both_sinks
    trails = {}
    for name, mod in (("port", supervisor_mod), ("jax", jax_supervisor_mod)):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        trails[name] = _scripted_supervisor(mod, clock)
    assert trails["port"] == trails["jax"]
    final = trails["port"][-1]
    assert final[1] == {0: READY, 1: QUARANTINED} and final[3] == {0: 2, 1: 3}

    def trail(sink):
        keep = ("replica_spawned", "replica_dead", "replica_quarantined")
        return [{k: v for k, v in e.items() if k not in ("ts", "host")}
                for e in sink.events if e["event"] in keep]

    assert trail(port_sink) == trail(jax_sink)
    assert [e["backoff_s"] for e in trail(port_sink) if e["event"] == "replica_spawned"] == [
        0.0, 0.0, 0.05, 0.1, 0.05]


# ---- the two routers over the same fake replicas ------------------------------


class _FakeReplica:
    """A TCP listener that accepts one router link, records every frame it
    receives and lets the test answer (``send``) or die (``drop``: an
    EOF)."""

    def __init__(self):
        self._lsock = socket.socket()
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(1)
        self.port = self._lsock.getsockname()[1]
        self.frames = []
        self._cond = threading.Condition()
        self._sock = None
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        self._sock, _ = self._lsock.accept()
        rfile = self._sock.makefile("rb")
        try:
            for line in rfile:
                with self._cond:
                    self.frames.append(json.loads(line))
                    self._cond.notify_all()
        except (OSError, ValueError):
            pass

    def wait_frames(self, n, timeout_s=10.0):
        with self._cond:
            assert self._cond.wait_for(lambda: len(self.frames) >= n, timeout_s), self.frames
            return list(self.frames)

    def send(self, msg):
        self._sock.sendall((json.dumps(msg) + "\n").encode())

    def drop(self):
        self._sock.shutdown(socket.SHUT_RDWR)
        self._sock.close()
        self._lsock.close()
        self._thread.join(10.0)


def _route_script(router_cls, pkg_faults):
    """The same admission / completion / death script through one package's
    router. Returns each fake replica's received submits, the accounting,
    the results and the routing verdicts."""
    pkg_faults.install({"faults": [{"type": "transient_io_error", "op": "redrive",
                                    "fail_count": 1}]})
    router = router_cls(max_inflight=2, max_queue=3, trace_epoch="t")
    fakes = [_FakeReplica(), _FakeReplica()]
    try:
        for i, fake in enumerate(fakes):
            router.connect(i, "127.0.0.1", fake.port)
        reqs = [{"rid": f"r{i}", "prompt": [i + 1, 2], "max_new_tokens": 3} for i in range(8)]
        verdicts = [router.submit(r) for r in reqs]  # 4 dispatched, 3 queued, 1 shed
        fakes[0].wait_frames(2)
        fakes[1].wait_frames(2)

        def done(fake, rid, frames_after):
            fake.send({"type": "done", "rid": rid, "tokens": [int(rid[1:]), 9, 9]})
            fake.wait_frames(frames_after)

        done(fakes[0], "r0", 3)      # r4 follows to replica 0
        fakes[1].drop()              # r1, r3 orphaned: redriven to the queue's head
        _wait(lambda: router.accounting()["redriven"] == 2, msg="redrive")
        done(fakes[0], "r2", 4)
        done(fakes[0], "r4", 5)
        done(fakes[0], "r3", 6)
        done(fakes[0], "r1", 7)
        done(fakes[0], "r5", 7)
        fakes[0].send({"type": "done", "rid": "r6", "tokens": [6, 9, 9]})
        fakes[0].send({"type": "done", "rid": "r6", "tokens": [6, 9, 9]})  # a duplicate
        router.drain(10.0)
        status = {"type": "status_result", "pending": 0, "completed": 7, "loaded_step": 1,
                  "rejected": 0}
        # answered once the request's frame arrived (its waiter is set by then)
        threading.Thread(target=lambda: (fakes[0].wait_frames(8), fakes[0].send(status)),
                         daemon=True).start()
        reply = router.request(0, {"type": "status"}, "status_result", timeout_s=10.0)
        submits = [[(f["rid"], f["trace"]["attempt"]) for f in fake.frames
                    if f["type"] == "submit"] for fake in fakes]
        return {"verdicts": verdicts, "submits": submits, "accounting": router.accounting(),
                "results": router.results, "reply": reply,
                "latencies": len(router.latencies())}
    finally:
        router.close()
        pkg_faults.clear()


def test_both_routers_make_the_same_decisions(both_sinks, monkeypatch):
    monkeypatch.setenv("PYRECOVER_IO_RETRIES", "3")
    port_sink, jax_sink = both_sinks
    port = _route_script(router_mod.FleetRouter, faults)
    ref = _route_script(jax_router_mod.FleetRouter, jax_faults)
    assert port == ref
    assert port["verdicts"] == ["dispatched"] * 4 + ["queued"] * 3 + ["shed"]
    assert port["submits"] == [[("r0", 1), ("r2", 1), ("r4", 1), ("r3", 2), ("r1", 2),
                                ("r5", 1), ("r6", 1)], [("r1", 1), ("r3", 1)]]
    assert port["accounting"] == {"submitted": 8, "done": 7, "shed": 1, "queued": 0,
                                  "inflight": 0, "redriven": 2, "redriven_rids": 2}

    drop = {"ts", "host", "mono", "dur_s", "e2e_s", "delay_s", "tid", "thread"}
    names = set(FLEET_EVENTS) | {"fault_injected", "ckpt_io_retry", "span"}

    def trail(sink):
        out = []
        for e in sink.events:
            if e["event"] not in names or (e["event"] == "span" and e.get("name") == "io_retry"):
                continue
            out.append({k: v for k, v in e.items() if k not in drop})
        # the reader threads' order differs from run to run only where the
        # test does not wait: order by (event, rid, attempt)
        return sorted(out, key=lambda e: json.dumps(e, sort_keys=True))

    assert trail(port_sink) == trail(jax_sink)
    redriven = [e for e in port_sink.events if e["event"] == "request_redriven"]
    assert [(e["rid"], e["from_replica"], e["attempt"]) for e in redriven] == [
        ("r1", 1, 1), ("r3", 1, 1)]
    assert [e["reason"] for e in port_sink.events if e["event"] == "trace_exemplar"].count(
        "redriven") == 2


def test_session_affinity_picks_alike_in_one_process():
    """``hash(str(session)) % n`` in both routers: the same preferred
    replica for every session in this process (the hash varies with
    PYTHONHASHSEED across processes, in both packages)."""
    picks = {}
    for name, cls in (("port", router_mod.FleetRouter), ("jax", jax_router_mod.FleetRouter)):
        router = cls(max_inflight=4, affinity=True)
        router._links = {0: None, 1: None, 2: None}
        router._outstanding = {0: set(), 1: set(), 2: set()}
        picks[name] = [router._pick_target_locked({"session": f"s{i}"}) for i in range(12)]
        router._outstanding[picks[name][0]] = {"a", "b", "c", "d"}  # the preferred is full
        picks[name].append(router._pick_target_locked({"session": "s0"}))
    assert picks["port"] == picks["jax"]
    assert picks["port"][-1] != picks["port"][0]


# ---- the wire ------------------------------------------------------------------


def test_jax_and_port_connections_exchange_frames():
    a, b = socket.socketpair()
    got = {"port": [], "jax": []}
    eofs = {"port": 0, "jax": 0}
    port = protocol.Connection(a, lambda m, c: got["port"].append(m), name="port",
                               on_eof=lambda c: eofs.__setitem__("port", eofs["port"] + 1))
    ref = jax_protocol.Connection(b, lambda m, c: got["jax"].append(m), name="jax",
                                  on_eof=lambda c: eofs.__setitem__("jax", eofs["jax"] + 1))
    frames = [{"type": "submit", "rid": "r", "prompt": [1, 2], "max_new_tokens": 3,
               "trace": {"trace": "ab" * 8, "span": "ab:a1", "attempt": 1}},
              {"type": "status"}, {"type": "probe", "seed": 0}]
    for f in frames:
        port.send(f)
    b.sendall(b"not json\n[1, 2]\n\n")  # torn or non-dict lines are skipped
    for f in frames[::-1]:
        ref.send(f)
    _wait(lambda: len(got["jax"]) == 3 and len(got["port"]) == 3, msg="frames")
    assert got["jax"] == frames and got["port"] == frames[::-1]
    ref.close()  # a local close is not a peer death for the closer...
    _wait(lambda: eofs["port"] == 1, msg="EOF")
    port.close()
    time.sleep(0.05)
    assert eofs == {"port": 1, "jax": 0}  # ...and the peer sees it exactly once


def test_an_idle_link_outlives_its_dial_timeout():
    """The port dials with a timeout and then blocks; the JAX package's
    ``connect`` keeps the timeout on the socket, so its reader takes an idle
    peer for a dead one."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(2)
    port_no = srv.getsockname()[1]
    eofs = {}
    links = []
    for name, mod in (("port", protocol), ("jax", jax_protocol)):
        sock = mod.connect("127.0.0.1", port_no, timeout_s=0.2)
        peer, _ = srv.accept()
        links.append((mod.Connection(sock, lambda m, c: None, name=name,
                                     on_eof=lambda c, n=name: eofs.setdefault(n, True)), peer))
    time.sleep(0.6)
    assert eofs == {"jax": True}
    for conn, peer in links:
        conn.close()
        peer.close()
    srv.close()
