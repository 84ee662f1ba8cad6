"""Flight recorder: an always-on event ring + atomic black-box dumps (the
JAX package's ``telemetry/flight.py``; the bundle layout is the same, so
either package's ``doctor`` reads the other's bundles).

The JSONL sinks make *healthy* runs observable; this module makes *dying*
ones diagnosable from artifacts. Two pieces:

``RingSink`` — a bounded in-memory sink on the ordinary telemetry bus:
the last N events plus every currently-open span (reconstructed from the
``span_begin``/``span_end`` stream), per process. Appending to a deque
under a lock is the whole cost, so it stays installed even when the JSONL
sinks are off — the run always carries its own black box.

``FlightRecorder`` — the dump side. ``dump(reason)`` writes a postmortem
bundle under ``<exp_dir>/.postmortem/`` ATOMICALLY (staged in a tmp dir,
published with one ``os.replace`` — a crash mid-dump can't leave a
half-bundle that ``doctor`` half-trusts):

    MANIFEST.json    reason, timestamps, pid, exception, last step,
                     last checkpoint, platform/device info
    events.jsonl     the ring contents (most recent ~N events)
    open_spans.json  spans open at dump time, innermost last per thread
    stacks.txt       all-thread Python stacks (``sys._current_frames``)
    config.json      the run config snapshot handed to ``install``
    env.json         the observability-relevant environment (PYRECOVER_/
                     SLURM_/CUDA_/NCCL_/TORCH_/PYTORCH_ prefixes only —
                     never the whole environ, which may carry credentials)

Triggers wired by ``install``:

  * unhandled exceptions — ``sys.excepthook`` + ``threading.excepthook``
    (chained; the previous hooks still run), and ``train()`` dumps
    explicitly while unwinding so a caller's ``try/except`` around
    ``train()`` can't swallow the bundle;
  * fatal signals (SIGSEGV/SIGABRT/SIGBUS/SIGFPE) — ``faulthandler``
    writes all-thread stacks into ``.postmortem/fatal_signal_stacks.txt``
    (the one artifact that can't be staged atomically: the interpreter is
    already dead — ``doctor`` treats a non-empty file as crash evidence);
  * the SIGTERM-escalation path (``preempt._escalate``) and the
    watchdog's ``hang_detected`` call ``dump`` explicitly.

Every successful dump also emits a ``flight_dump`` event (reason, path)
through the bus, so the durable JSONL stream records that a bundle exists.
"""

import faulthandler
import json
import os
import sys
import threading
import time
import traceback
from collections import deque
from pathlib import Path

from pyrecover_tpu_torch.telemetry import bus

POSTMORTEM_DIRNAME = ".postmortem"
FATAL_STACKS_NAME = "fatal_signal_stacks.txt"
MANIFEST_NAME = "MANIFEST.json"
DEFAULT_RING_SIZE = 512
# runaway-crash-loop backstop: one process writes at most this many bundles
MAX_DUMPS_PER_PROCESS = 8

_ENV_PREFIXES = ("PYRECOVER_", "SLURM_", "CUDA_", "NCCL_", "TORCH_", "PYTORCH_")


class RingSink:
    """Bounded in-memory telemetry sink: last N events + open spans.

    Also tracks the run-progress facts a postmortem needs — the highest
    ``step`` field seen and the last ``ckpt_saved`` event — so a bundle
    can say "died at step 412, newest durable checkpoint ckpt_400" even
    when those events have already rotated out of the ring.
    """

    def __init__(self, maxlen=DEFAULT_RING_SIZE):
        self._lock = threading.Lock()
        self.events = deque(maxlen=int(maxlen))
        self.open_spans = {}  # span id -> span_begin record
        self.last_step = None
        self.last_ckpt = None

    def write(self, record):
        ev = record.get("event")
        with self._lock:
            self.events.append(record)
            if ev == "span_begin":
                self.open_spans[record.get("span")] = record
            elif ev == "span_end":
                self.open_spans.pop(record.get("span"), None)
            elif ev == "ckpt_saved":
                self.last_ckpt = dict(record)
            step = record.get("step")
            if isinstance(step, (int, float)):
                step = int(step)
                if self.last_step is None or step > self.last_step:
                    self.last_step = step

    def close(self):
        pass

    def snapshot(self):
        """Consistent copy: (events, open_spans sorted outermost→innermost,
        last_step, last_ckpt)."""
        with self._lock:
            events = list(self.events)
            # span ids are process-monotonic: sorting by id orders each
            # thread's open spans outermost (oldest) → innermost (newest)
            spans = sorted(
                self.open_spans.values(), key=lambda r: r.get("span") or 0
            )
            return events, spans, self.last_step, self.last_ckpt


def _platform_info():
    """Best-effort device and platform facts. Never raises (this runs inside
    crash handlers, where the CUDA context may itself be the corpse), and
    never initialises CUDA in a process that has not: a dump must not be
    what brings up a card."""
    import platform as _platform

    info = {
        "python": sys.version.split()[0],
        "platform": _platform.platform(),
        "pid": os.getpid(),
        "argv": list(sys.argv),
    }
    torch = sys.modules.get("torch")
    if torch is None:
        info["device_probe_error"] = "torch not imported"
        return info
    try:
        info["torch_version"] = torch.__version__
        info["cuda_runtime"] = torch.version.cuda
        info["process_index"] = bus._process_index()
        if torch.cuda.is_initialized():
            idx = torch.cuda.current_device()
            props = torch.cuda.get_device_properties(idx)
            info["backend"] = "gpu"
            info["device_kind"] = props.name
            info["compute_capability"] = f"{props.major}.{props.minor}"
            info["device_memory_bytes"] = int(props.total_memory)
            info["device_count"] = torch.cuda.device_count()
        else:
            info["backend"] = "cpu"
            info["device_kind"] = "cpu"
            info["device_count"] = 0
    except Exception as e:  # a dead context: record that instead
        info["device_probe_error"] = f"{type(e).__name__}: {e}"
    return info


class FlightRecorder:
    """The installed black box for one run. Use via the module-level
    ``install``/``dump``/``uninstall`` API."""

    def __init__(self, exp_dir, *, config=None, ring_size=DEFAULT_RING_SIZE,
                 enable_faulthandler=True):
        self.exp_dir = Path(exp_dir)
        self.postmortem_dir = self.exp_dir / POSTMORTEM_DIRNAME
        self.config = dict(config) if config else {}
        self.ring = RingSink(maxlen=ring_size)
        self.enable_faulthandler = enable_faulthandler
        self._dump_lock = threading.Lock()
        self._dump_count = 0
        self._fatal_file = None
        self._prev_excepthook = None
        self._prev_threading_hook = None
        # captured at install and again at the first dump after CUDA came
        # up (the recorder is installed before the device is), then reused:
        # at a later dump the context may be dead
        self._platform = None

    # -- lifecycle -----------------------------------------------------------
    def install(self):
        bus.add_sink(self.ring)
        self._platform = _platform_info()
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._excepthook
        self._prev_threading_hook = threading.excepthook
        threading.excepthook = self._thread_excepthook
        if self.enable_faulthandler:
            try:
                # remember whether someone else (pytest does, by default)
                # had faulthandler armed, so uninstall can hand it back
                self._prev_faulthandler = faulthandler.is_enabled()
                self.postmortem_dir.mkdir(parents=True, exist_ok=True)
                # faulthandler needs one
                # always-open real fd; the file is evidence only when
                # non-empty and uninstall prunes empty ones
                self._fatal_file = open(self._fatal_path(), "w")
                faulthandler.enable(file=self._fatal_file, all_threads=True)
            except Exception:
                self._fatal_file = None  # read-only exp_dir: no fatal hook
        return self

    def _fatal_path(self):
        # per-host file: multi-host runs share the exp dir, and two hosts
        # truncating one fatal-stacks file would destroy each other's
        # crash evidence
        host = bus._process_index()
        name = (
            FATAL_STACKS_NAME if not host
            else FATAL_STACKS_NAME.replace(".txt", f".host{host}.txt")
        )
        return self.postmortem_dir / name

    def uninstall(self):
        bus.remove_sink(self.ring)
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        if self._prev_threading_hook is not None:
            threading.excepthook = self._prev_threading_hook
            self._prev_threading_hook = None
        if self._fatal_file is not None:
            try:
                faulthandler.disable()
                self._fatal_file.close()
                if getattr(self, "_prev_faulthandler", False):
                    faulthandler.enable()  # back to stderr for the host app
            except Exception:
                pass
            # an empty fatal-stacks file just means "nothing fatal
            # happened"; remove it so the postmortem dir only exists when
            # there is actually something to read
            try:
                p = self._fatal_path()
                if p.exists() and p.stat().st_size == 0:
                    p.unlink()
                    self.postmortem_dir.rmdir()  # only if now empty
            except OSError:
                pass
            self._fatal_file = None

    def _platform_facts(self):
        if self._platform is None or self._platform.get("backend") != "gpu":
            self._platform = _platform_info()
        return self._platform

    # -- crash hooks ---------------------------------------------------------
    def _excepthook(self, exc_type, exc, tb):
        if not issubclass(exc_type, (KeyboardInterrupt, SystemExit)):
            try:
                self.dump("unhandled_exception", exc=(exc_type, exc, tb))
            except Exception:
                pass  # the original traceback must still print
        (self._prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)

    def _thread_excepthook(self, args):
        if args.exc_type is not SystemExit:
            try:
                self.dump(
                    "thread_exception",
                    exc=(args.exc_type, args.exc_value, args.exc_traceback),
                    thread=getattr(args.thread, "name", None),
                )
            except Exception:
                pass
        prev = self._prev_threading_hook or threading.__excepthook__
        prev(args)

    # -- the dump ------------------------------------------------------------
    # best-effort postmortem bundle; doctor tolerates a torn or absent
    # dump  # faultcheck: tear-ok
    def dump(self, reason, *, exc=None, thread=None, **extra):
      
        """Write one postmortem bundle; returns its path (None if rate-
        limited or the filesystem refused). Safe to call from any thread,
        signal handlers included — everything here is plain file I/O."""
        with self._dump_lock:
            if self._dump_count >= MAX_DUMPS_PER_PROCESS:
                return None
            self._dump_count += 1
            seq = self._dump_count
        events, open_spans, last_step, last_ckpt = self.ring.snapshot()
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        name = f"{stamp}_{seq:02d}_{reason}"
        final = self.postmortem_dir / name
        tmp = self.postmortem_dir / f".tmp_{name}_{os.getpid()}"
        manifest = {
            "reason": str(reason),
            "ts": round(time.time(), 6),
            "seq": seq,
            "last_step": last_step,
            "last_checkpoint": last_ckpt,
            "n_events": len(events),
            "n_open_spans": len(open_spans),
            "platform": self._platform_facts(),
        }
        if thread is not None:
            manifest["thread"] = str(thread)
        manifest.update(extra)
        if exc is not None:
            exc_type, exc_val, exc_tb = exc
            manifest["exception"] = {
                "type": getattr(exc_type, "__name__", str(exc_type)),
                "message": str(exc_val),
                "traceback": "".join(
                    traceback.format_exception(exc_type, exc_val, exc_tb)
                ),
            }
        try:
            tmp.mkdir(parents=True, exist_ok=True)
            _write_json(tmp / MANIFEST_NAME, manifest)
            with open(tmp / "events.jsonl", "w") as f:
                for rec in events:
                    f.write(json.dumps(rec, default=str,
                                       separators=(",", ":")) + "\n")
            _write_json(tmp / "open_spans.json", open_spans)
            _write_json(tmp / "config.json", self.config)
            _write_json(tmp / "env.json", {
                k: v for k, v in os.environ.items()
                if k.startswith(_ENV_PREFIXES)
            })
            with open(tmp / "stacks.txt", "w") as f:
                f.write(_format_all_stacks())
            # best-effort postmortem:
            # fsyncing the whole staged tree mid-crash costs more than a lost
            # bundle; doctor tolerates absence
            os.replace(tmp, final)
        except OSError:
            try:
                import shutil

                shutil.rmtree(tmp, ignore_errors=True)
            except Exception:
                pass
            return None
        bus.emit("flight_dump", reason=str(reason), path=str(final),
                 last_step=last_step)
        return final


def _write_json(path, obj):
    # writes only inside the staged .tmp_
    # bundle dir; dump() publishes the whole dir with one os.replace
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=str)


def _format_all_stacks():
    """All-thread stacks, Python-side (``faulthandler`` covers the
    interpreter-is-dying case; this covers live dumps from watchdogs and
    excepthooks where frame objects are still reachable)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        out.append(f"--- thread {names.get(ident, '?')} (ident {ident}) ---")
        out.append("".join(traceback.format_stack(frame)))
    return "\n".join(out)


# ---- module-level singleton (the faults.py pattern) -------------------------

_recorder = None


def install(exp_dir, *, config=None, ring_size=DEFAULT_RING_SIZE,
            enable_faulthandler=True):
    """Install the process-wide flight recorder (replacing any previous
    one). ``config`` is a plain dict snapshot written into every bundle."""
    global _recorder
    if _recorder is not None:
        _recorder.uninstall()
    _recorder = FlightRecorder(
        exp_dir, config=config, ring_size=ring_size,
        enable_faulthandler=enable_faulthandler,
    ).install()
    return _recorder


def uninstall():
    """Remove the recorder and its hooks (end of run / test teardown)."""
    global _recorder
    if _recorder is not None:
        _recorder.uninstall()
        _recorder = None


def active():
    """The installed FlightRecorder, or None."""
    return _recorder


def dump(reason, *, exc=None, **extra):
    """Dump a bundle through the installed recorder; no-op (returns None)
    when none is installed — call sites never need to guard."""
    if _recorder is None:
        return None
    return _recorder.dump(reason, exc=exc, **extra)


def list_bundles(exp_dir):
    """Postmortem bundle dirs under ``exp_dir`` (or a ``.postmortem`` dir,
    or a single bundle dir), oldest→newest by name (name embeds the UTC
    stamp + sequence number, so lexicographic order is dump order)."""
    root = Path(exp_dir)
    if (root / MANIFEST_NAME).is_file():
        return [root]
    if root.name != POSTMORTEM_DIRNAME:
        root = root / POSTMORTEM_DIRNAME
    if not root.is_dir():
        return []
    return sorted(
        p for p in root.iterdir()
        if p.is_dir() and not p.name.startswith(".tmp_")
        and (p / MANIFEST_NAME).is_file()
    )
