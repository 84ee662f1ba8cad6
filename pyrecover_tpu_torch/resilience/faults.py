"""Deterministic fault injection: seeded plans delivered through explicit
seams (the JAX package's ``resilience/faults.py``: the same plan format, and
the same seed gives the same schedule in both packages).

Recovery code that is never exercised by a real failure silently rots
(PAPERS.md: fault-tolerant ML multiprocessor work; TorchTitan treats
recoverability as continuously verified). This module makes failure an
*input*: a declarative fault plan names what breaks, where, and when —
and the same seed reproduces the same failure schedule bit-for-bit.

Plan format (JSON — inline in ``$PYRECOVER_FAULT_PLAN`` or a file path)::

    {"seed": 0, "faults": [
        {"type": "sigterm_at_step", "step": 4},
        {"type": "kill9_during_save", "save_index": 1, "after_bytes": 0},
        {"type": "random_sigkill", "rate_per_step": 0.3, "seed": 7,
         "grace_steps": 13, "start_step": 0, "end_step": 32},
        {"type": "corrupt_ckpt_bytes", "save_index": 2,
         "offset": null, "count": 64},
        {"type": "transient_io_error", "op": "write", "fail_count": 2},
        {"type": "loader_stall", "seconds": 5.0, "batch": 3}
    ]}

Injection sites are declared in :data:`FAULT_SITES` below — the single
source of truth for which seams exist, who owns them, and which drill
fires them. ``faults.check`` (with a plan active) and plan installation
both validate against it, so a typo'd site string raises
:class:`FaultPlanError` naming the known sites instead of silently never
firing; ``tools/faultcheck.py`` reads the same registry statically to
prove every durable effect sits behind a registered, drilled seam. The
registry holds only the sites whose seams exist in the port; the JAX
package's maintenance site (and ``metadata_flap``) is left out by design,
as its watcher is (``preempt.py``).

With no plan active, ``check`` is rebound to a no-op — seams cost one
attribute lookup and an empty call. The first ``check`` after import
resolves ``$PYRECOVER_FAULT_PLAN`` exactly once (so subprocess trainers
pick their plan up with zero wiring), then rebinds.
"""

import errno
import json
import os
import random
import signal
import threading
import time

from pyrecover_tpu_torch import telemetry

PLAN_ENV = "PYRECOVER_FAULT_PLAN"

# The declarative seam registry: every ``check(site, **ctx)`` site in
# production code, its owning module, what KIND of effect the seam
# guards, and the drill that fires it. This is a *contract surface*:
# ``faults.check`` and ``FaultEngine`` validate live site strings
# against it (an unknown site raises loudly instead of silently never
# firing), faultcheck's FT03/FT04 rules cross-check it statically
# against the seam call sites and the chaos-drill plan corpus, and the
# test suite pins both directions. ``kind: "counter"`` marks a
# bookkeeping seam (it only advances the save index — nothing kills or
# raises there), which FT04 exempts from drill coverage.
FAULT_SITES = {
    "train_step": {
        "module": "train.py", "kind": "step",
        "drill": "sigterm_at_step / random_sigkill; ctx: step",
    },
    "ckpt_save_begin": {
        "module": "checkpoint/vanilla.py, checkpoint/sharded.py, checkpoint/zerostall/snapshot.py",
        "kind": "counter",
        "drill": "bumps the save index save-indexed faults key on; "
                 "ctx: engine, path",
    },
    "ckpt_write": {
        "module": "checkpoint/vanilla.py, checkpoint/native_io.py, checkpoint/sharded.py",
        "kind": "write",
        "drill": "kill9_during_save (chip_smoke drill 2, the CPU kill9 "
                 "test) + transient_io_error op=write; ctx: path, written",
    },
    "ckpt_fsync": {
        "module": "checkpoint/vanilla.py, checkpoint/sharded.py", "kind": "fsync",
        "drill": "transient_io_error op=fsync; ctx: path",
    },
    "ckpt_rename": {
        "module": "checkpoint/vanilla.py, checkpoint/sharded.py", "kind": "publish",
        "drill": "transient_io_error op=rename; ctx: path",
    },
    "ckpt_commit": {
        "module": "checkpoint/vanilla.py, checkpoint/sharded.py, checkpoint/zerostall/snapshot.py",
        "kind": "commit",
        "drill": "corrupt_ckpt_bytes (chip_smoke drill 3); ctx: engine, "
                 "path",
    },
    "ckpt_read": {
        "module": "checkpoint/vanilla.py, checkpoint/native_io.py, checkpoint/sharded.py, "
                  "checkpoint/zerostall/chunkstore.py",
        "kind": "read",
        "drill": "transient_io_error op=read (chip_smoke drill 4); "
                 "ctx: path",
    },
    "ckpt_snapshot": {
        "module": "checkpoint/zerostall/snapshot.py", "kind": "snapshot",
        "drill": "kill9_during_save site=ckpt_snapshot (the zerostall CPU tests); "
                 "ctx: engine, path, leaves",
    },
    "ckpt_chunk_write": {
        "module": "checkpoint/zerostall/chunkstore.py", "kind": "write",
        "drill": "kill9_during_save site=ckpt_chunk_write (chip_smoke's zerostall drill) "
                 "+ transient_io_error op=chunk_write; ctx: path, written",
    },
    "ckpt_manifest_commit": {
        "module": "checkpoint/zerostall/chunkstore.py", "kind": "publish",
        "drill": "kill9_during_save site=ckpt_manifest_commit + transient_io_error "
                 "op=manifest_commit; ctx: path",
    },
    "ckpt_gc_unlink": {
        "module": "checkpoint/zerostall/chunkstore.py, checkpoint/zerostall/pins.py",
        "kind": "unlink",
        "drill": "transient_io_error op=gc_unlink (a sweep cut short leaves every manifest "
                 "restorable); ctx: path",
    },
    "ckpt_prune": {
        "module": "checkpoint/registry.py", "kind": "unlink",
        "drill": "transient_io_error op=prune (retention must leave the "
                 "survivors intact); ctx: path, step",
    },
    "swap_fetch": {
        "module": "serving/hotswap/fetch.py", "kind": "fetch",
        "drill": "hotswap chaos drill kill9_during_save site=swap_fetch "
                 "save_index=0 (a serving replica never saves); "
                 "ctx: path, written",
    },
    "replica_kill": {
        "module": "serving/fleet/replica.py", "kind": "kill",
        "drill": "fleet chaos drill kill9_during_save site=replica_kill save_index=0, "
                 "after_bytes = completed-request count (a replica never saves; `written` "
                 "counts requests served); ctx: replica, written",
    },
    "router_redrive": {
        "module": "serving/fleet/router.py", "kind": "redrive",
        "drill": "fleet chaos drill transient_io_error op=redrive (a redrive that EIOs must "
                 "retry, never drop the request); ctx: rid, replica",
    },
    "loader_batch": {
        "module": "data/loader.py", "kind": "stall",
        "drill": "loader_stall (chip_smoke drill 5, the hang drill); "
                 "ctx: batch",
    },
}


class FaultPlanError(ValueError):
    """The fault plan is malformed (unknown type / bad field). Raised at
    install time, never from a seam — a typo'd plan must fail the run
    loudly, not silently inject nothing."""


def _injected_os_error(what):
    return OSError(errno.EIO, f"injected fault: {what}")


class _Fault:
    """One armed fault. Subclasses declare ``sites`` and implement
    ``should_fire(engine, site, ctx) -> bool`` (counter mutations only —
    runs under the engine lock) and ``execute(engine, site, ctx)`` (the
    action: sleep/kill/raise — runs OUTSIDE the lock so a stalling fault
    can't wedge seams on other threads)."""

    sites = ()
    type_name = ""

    def __init__(self, spec):
        self.spec = dict(spec)
        self.hits = 0
        self.fired = 0

    def maybe_fire(self, engine, site, ctx):  # concur: guarded-by=FaultEngine._lock
        with engine._lock:
            self.hits += 1
            if not self.should_fire(engine, site, ctx):
                return
            self.fired += 1
        self.execute(engine, site, ctx)

    def _announce(self, site, **detail):
        telemetry.emit(
            "fault_injected", type=self.type_name, site=site, **detail
        )

    def should_fire(self, engine, site, ctx):  # pragma: no cover - abstract
        raise NotImplementedError

    def execute(self, engine, site, ctx):  # pragma: no cover - abstract
        raise NotImplementedError


class _SigtermAtStep(_Fault):
    """Deliver SIGTERM to this process as step N begins — the graceful
    preemption drill. The trainer's handler turns it into a final
    checkpoint + REQUEUE exit."""

    sites = ("train_step",)
    type_name = "sigterm_at_step"

    def __init__(self, spec):
        super().__init__(spec)
        self.step = int(spec["step"])

    def should_fire(self, engine, site, ctx):
        return not self.fired and ctx.get("step") == self.step

    def execute(self, engine, site, ctx):
        self._announce(site, step=self.step)
        os.kill(os.getpid(), signal.SIGTERM)


class _Kill9DuringSave(_Fault):
    """SIGKILL mid-checkpoint-write: the save that must never corrupt
    ``latest``. ``save_index`` picks which save of the run (1-based),
    ``after_bytes`` how deep into the stream the kill lands. ``site``
    optionally pins WHICH stage dies: the vanilla stream write
    (``ckpt_write``) or a zerostall stage (``ckpt_snapshot`` after the
    copies are queued, ``ckpt_chunk_write`` in the chunk store,
    ``ckpt_manifest_commit`` between the durable manifest and its
    rename), a hot-swap's chunk fetch (``swap_fetch``, at ``save_index``
    0: a serving process never saves), or a fleet replica's serve loop
    (``replica_kill``, ``save_index`` 0 again; ``after_bytes`` counts
    completed requests there)."""

    sites = ("ckpt_write", "ckpt_snapshot", "ckpt_chunk_write", "ckpt_manifest_commit",
             "swap_fetch", "replica_kill")
    type_name = "kill9_during_save"

    def __init__(self, spec):
        super().__init__(spec)
        self.save_index = int(spec.get("save_index", 1))
        self.after_bytes = int(spec.get("after_bytes", 0))
        self.site = spec.get("site")
        if self.site is not None and self.site not in self.sites:
            raise FaultPlanError(
                f"kill9_during_save: unknown site {self.site!r}; "
                f"known: {list(self.sites)}"
            )

    def should_fire(self, engine, site, ctx):
        return (
            not self.fired
            and (self.site is None or site == self.site)
            and engine.save_index == self.save_index
            and ctx.get("written", 0) >= self.after_bytes
        )

    def execute(self, engine, site, ctx):
        self._announce(site, save_index=self.save_index,
                       written=ctx.get("written", 0))
        os.kill(os.getpid(), signal.SIGKILL)


class _RandomSigkill(_Fault):
    """Seeded hazard-rate hard kill: each eligible train step dies with
    probability ``rate_per_step`` — interruptions as a *rate*, not one
    scheduled deadline. This is the fault that drives the goodput
    autopilot's convergence drill (the adapted checkpoint interval must
    track the Young–Daly optimum for the seeded MTTI).

    Determinism: the RNG is seeded with ``(seed, first eligible step)``,
    so a given resume point replays the identical kill schedule — the
    whole chaos drill reproduces from its seed. ``start_step`` /
    ``end_step`` bound the hazard window in GLOBAL steps (two specs with
    disjoint windows encode a mid-run rate shift); ``grace_steps`` is a
    hazard-free count of eligible steps after each process start.
    Liveness depends on it: a kill landing before the resumed process
    reaches its first new checkpoint would replay the identical schedule
    forever, so set ``grace_steps`` strictly above the autopilot's
    interval ceiling (every cycle then commits at least one save before
    it can die, and the resume point advances monotonically)."""

    sites = ("train_step",)
    type_name = "random_sigkill"

    def __init__(self, spec):
        super().__init__(spec)
        self.rate = float(spec["rate_per_step"])
        if not 0.0 < self.rate <= 1.0:
            raise FaultPlanError(
                f"random_sigkill: rate_per_step must be in (0, 1], got "
                f"{self.rate}"
            )
        self.seed = int(spec.get("seed", 0))
        self.grace = int(spec.get("grace_steps", 0))
        self.start_step = int(spec.get("start_step", 0))
        end = spec.get("end_step")
        self.end_step = None if end is None else int(end)
        if self.end_step is not None and self.end_step <= self.start_step:
            raise FaultPlanError(
                f"random_sigkill: end_step {self.end_step} must be > "
                f"start_step {self.start_step}"
            )
        self._rng = None
        self._eligible = 0
        self._fire_step = None

    def should_fire(self, engine, site, ctx):
        step = ctx.get("step")
        if not isinstance(step, int):
            return False
        if step < self.start_step or (
            self.end_step is not None and step >= self.end_step
        ):
            return False
        if self._rng is None:
            # keyed on the first eligible step: the schedule is a pure
            # function of (seed, resume point); a string seed hashes via
            # sha512 — stable across processes and platforms
            self._rng = random.Random(f"{self.seed}:{step}")
        self._eligible += 1
        if self._eligible <= self.grace:
            return False
        if self._rng.random() < self.rate:
            self._fire_step = step
            return True
        return False

    def execute(self, engine, site, ctx):
        # announce BEFORE the kill: the per-event-flushed telemetry JSONL
        # is the only record this process gets to leave
        self._announce(site, step=self._fire_step, rate=self.rate,
                       grace_steps=self.grace)
        os.kill(os.getpid(), signal.SIGKILL)


class _CorruptCkptBytes(_Fault):
    """Flip bytes of a just-committed checkpoint file in place (XOR 0xFF),
    leaving its checksum sidecar stale — exactly the on-disk damage the
    integrity pre-check + quarantine path exists for. ``offset`` None
    means the middle of the file."""

    sites = ("ckpt_commit",)
    type_name = "corrupt_ckpt_bytes"

    def __init__(self, spec):
        super().__init__(spec)
        self.save_index = spec.get("save_index")
        self.offset = spec.get("offset")
        self.count = int(spec.get("count", 64))

    def should_fire(self, engine, site, ctx):
        if self.fired:
            return False
        if self.save_index is not None and (
            engine.save_index != int(self.save_index)
        ):
            return False
        path = ctx.get("path")
        # sharded commits are directories; this fault targets the vanilla
        # single-file container
        return bool(path) and os.path.isfile(path)

    def execute(self, engine, site, ctx):
        path = ctx["path"]
        size = os.path.getsize(path)
        offset = self.offset if self.offset is not None else size // 2
        offset = max(0, min(int(offset), max(size - 1, 0)))
        count = min(self.count, size - offset)
        if count <= 0:
            return
        with open(path, "r+b") as f:
            f.seek(offset)
            data = f.read(count)
            f.seek(offset)
            f.write(bytes(b ^ 0xFF for b in data))
        self._announce(site, path=str(path), offset=offset, count=count)


class _TransientIOError(_Fault):
    """EIO on checkpoint write/fsync/rename/read that heals after
    ``fail_count`` raises — the retry/backoff path's proof load."""

    sites = ("ckpt_write", "ckpt_fsync", "ckpt_rename", "ckpt_read",
             "ckpt_chunk_write", "ckpt_manifest_commit", "ckpt_gc_unlink", "ckpt_prune",
             "router_redrive")
    type_name = "transient_io_error"
    _OPS = {"write": "ckpt_write", "fsync": "ckpt_fsync",
            "rename": "ckpt_rename", "read": "ckpt_read",
            "chunk_write": "ckpt_chunk_write", "manifest_commit": "ckpt_manifest_commit",
            "gc_unlink": "ckpt_gc_unlink", "prune": "ckpt_prune", "redrive": "router_redrive",
            "any": None}

    def __init__(self, spec):
        super().__init__(spec)
        op = spec.get("op", "any")
        if op not in self._OPS:
            raise FaultPlanError(f"transient_io_error: unknown op {op!r}")
        self.site_filter = self._OPS[op]
        self.remaining = int(spec.get("fail_count", 1))

    def should_fire(self, engine, site, ctx):
        if self.remaining <= 0:
            return False
        if self.site_filter is not None and site != self.site_filter:
            return False
        self.remaining -= 1
        return True

    def execute(self, engine, site, ctx):
        self._announce(site, path=str(ctx.get("path", "")),
                       remaining=self.remaining)
        raise _injected_os_error(f"transient_io_error at {site}")


class _LoaderStall(_Fault):
    """Block batch materialization for ``seconds`` — the hung-data-source
    scenario the loader's stall watchdog must convert into a typed error
    instead of a wedged step loop. ``batch`` picks which seam hit
    (1-based); None means the first."""

    sites = ("loader_batch",)
    type_name = "loader_stall"

    def __init__(self, spec):
        super().__init__(spec)
        self.seconds = float(spec.get("seconds", 5.0))
        self.batch = spec.get("batch")

    def should_fire(self, engine, site, ctx):
        if self.fired:
            return False
        return self.batch is None or self.hits == int(self.batch)

    def execute(self, engine, site, ctx):
        self._announce(site, seconds=self.seconds, hit=self.hits)
        time.sleep(self.seconds)


_FAULT_TYPES = {
    cls.type_name: cls
    for cls in (
        _SigtermAtStep, _Kill9DuringSave, _RandomSigkill, _CorruptCkptBytes,
        _TransientIOError, _LoaderStall,
    )
}


def _unknown_site_error(site, where):
    return FaultPlanError(
        f"unknown site {site!r} at {where}; known sites: "
        f"{sorted(FAULT_SITES)}"
    )


def _validate_fault_types():
    """Every site a fault class declares (or maps an op to) must be in
    the registry — a drifted declaration would silently never fire, so
    it fails at import instead."""
    for cls in _FAULT_TYPES.values():
        for site in cls.sites:
            if site not in FAULT_SITES:
                raise _unknown_site_error(site, f"{cls.type_name}.sites")
    for op, site in _TransientIOError._OPS.items():
        if site is not None and site not in FAULT_SITES:
            raise _unknown_site_error(site, f"transient_io_error op {op!r}")


_validate_fault_types()


class FaultEngine:
    """The active plan: parsed fault list + the per-run save counter the
    save-indexed faults key on. One engine per process; sites funnel
    through ``check``."""

    def __init__(self, plan):
        if not isinstance(plan, dict):
            raise FaultPlanError("fault plan must be a JSON object")
        self.seed = int(plan.get("seed", 0))
        self.save_index = 0
        self._lock = threading.Lock()
        self.faults = []
        for spec in plan.get("faults", []):
            ftype = spec.get("type")
            cls = _FAULT_TYPES.get(ftype)
            if cls is None:
                raise FaultPlanError(
                    f"unknown fault type {ftype!r}; known: "
                    f"{sorted(_FAULT_TYPES)}"
                )
            site = spec.get("site")
            if site is not None and site not in FAULT_SITES:
                raise _unknown_site_error(site, f"{ftype} plan spec")
            try:
                self.faults.append(cls(spec))
            except (KeyError, TypeError, ValueError) as e:
                raise FaultPlanError(f"bad {ftype} spec {spec}: {e}") from e

    def check(self, site, **ctx):
        if site not in FAULT_SITES:
            # a seam naming an unregistered site would never match any
            # plan — fail the run loudly instead of silently not injecting
            raise _unknown_site_error(site, "a live check() seam")
        if site == "ckpt_save_begin":
            with self._lock:
                self.save_index += 1
        for f in self.faults:
            if site in f.sites:
                f.maybe_fire(self, site, ctx)  # locks internally


def _noop(site, **ctx):
    return None


_bootstrap_lock = threading.Lock()


def _bootstrap(site, **ctx):
    """First seam hit of the process: resolve ``$PYRECOVER_FAULT_PLAN``
    once, then rebind ``check`` so later hits pay nothing. Locked — the
    loader's producer thread and the main thread can hit their first
    seams concurrently, and two engines would double-fire every fault."""
    global check
    with _bootstrap_lock:
        if check is _bootstrap:
            plan = load_env_plan()
            if plan is None:
                check = _noop
            else:
                install(plan)
    return check(site, **ctx)


check = _bootstrap
_engine = None


def load_env_plan():
    """Plan dict from ``$PYRECOVER_FAULT_PLAN`` (inline JSON if it starts
    with ``{``, else a path to a JSON file), or None."""
    raw = os.environ.get(PLAN_ENV, "").strip()
    if not raw:
        return None
    if not raw.startswith("{"):
        with open(raw) as f:
            raw = f.read()
    try:
        return json.loads(raw)
    except ValueError as e:
        raise FaultPlanError(f"${PLAN_ENV} is not valid JSON: {e}") from e


def install(plan):
    """Activate a fault plan (dict or FaultEngine) process-wide. Returns
    the engine. Seams go live immediately."""
    global check, _engine
    engine = plan if isinstance(plan, FaultEngine) else FaultEngine(plan)
    _engine = engine
    check = engine.check
    return engine


def clear():
    """Deactivate fault injection; seams return to no-ops."""
    global check, _engine
    _engine = None
    check = _noop


def active():
    """The installed FaultEngine, or None."""
    return _engine
