"""Silent-failure detectors for the hot path (the JAX package's
``telemetry/detectors.py``, on CUDA's own seams).

The failure modes that never raise: a recompile storm quietly eating
throughput after a shape drift, an implicit host sync serializing the
dispatch, a run that lands on the CPU when a card was expected, device
memory creeping to the OOM line. Each detector turns one of these into loud
telemetry (events + counters/gauges) that ``doctor`` and the goodput report
can see.

``RecompileWatch``     wraps the train step; a change in the batch's
                       signature (tensor shapes/dtypes, the dict's keys) is
                       what re-specializes the step (a real dynamo
                       recompile under ``torch.compile``) → one
                       ``recompile`` event + ``recompile_total`` counter
                       per change.
``transfer_watch``     a per-dispatch scope under
                       ``torch.cuda.set_sync_debug_mode("error")``: a
                       synchronizing CUDA call (``.item()``, a pageable
                       copy, ``synchronize``) emits ``implicit_transfer``
                       and raises :class:`ImplicitTransferError`;
                       ``warn=True`` (``--transfer-guard log``) only warns.
``sample_hbm``         the allocator's bytes in use and peak into ``hbm_*`` gauges;
                       ``hbm_run_summary`` folds peak-vs-budget into
                       ``run_summary`` (budget: ``mem_get_info``'s total).
``probe_accelerator``  counts devices in a subprocess under a hard
                       timeout, so a CUDA init that hangs cannot hang the
                       caller; ``check_expected_accelerator`` is the loud
                       half (``platform_fallback``).

The field names are the JAX package's (``hbm_peak_pct`` names the card's
HBM here).
"""

import contextlib
import os
import subprocess
import sys
import tempfile
import threading
import time

from pyrecover_tpu_torch.telemetry import bus, metrics

EXPECT_ACCELERATOR_ENV = "PYRECOVER_EXPECT_ACCELERATOR"
PLATFORM_FALLBACK_ENV = "PYRECOVER_PLATFORM_FALLBACK"


# ---- recompile detection ----------------------------------------------------

def _leaf_sig(leaf):
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is None and dtype is None:
        # a Python scalar or static argument: its type and value
        return (type(leaf).__name__, repr(leaf))
    return (tuple(shape) if shape is not None else None, str(dtype))


def _flatten(obj, prefix, out):
    if isinstance(obj, dict):
        for k in sorted(obj, key=str):
            _flatten(obj[k], f"{prefix}[{k!r}]", out)
    elif isinstance(obj, (list, tuple)):
        for i, x in enumerate(obj):
            _flatten(x, f"{prefix}[{i}]", out)
    else:
        out.append((prefix, obj))


def _signature(args, kwargs):
    leaves = []
    _flatten((args, kwargs), "", leaves)
    return (tuple(p for p, _ in leaves), tuple(_leaf_sig(x) for _, x in leaves))


class RecompileWatch:
    """Wrap the train step; emit ``recompile`` when the call signature
    changes after the first call.

    The signature is host-side metadata only (structure + tensor
    shape/dtype): no device sync, microseconds a call. Fires once per
    change: the stored signature updates on every mismatch, so a steady
    state of the new shape is silent until the next drift."""

    def __init__(self, fn, name="train_step"):
        self.fn = fn
        self.name = name
        self._sig = None
        self.recompiles = 0

    def __call__(self, *args, **kwargs):
        sig = _signature(args, kwargs)
        if self._sig is None:
            self._sig = sig
        elif sig != self._sig:
            changed = _describe_change(self._sig, sig)
            self._sig = sig
            self.recompiles += 1
            metrics.counter("recompile_total").inc()
            bus.emit(
                "recompile", fn=self.name, count=self.recompiles,
                changed=changed,
            )
        return self.fn(*args, **kwargs)


def _describe_change(old, new):
    """Human-readable first difference between two signatures."""
    if old[0] != new[0]:
        return "structure changed"
    for i, (a, b) in enumerate(zip(old[1], new[1])):
        if a != b:
            return f"leaf {old[0][i] or i}: {a} -> {b}"
    return "signature changed"


# ---- implicit host-sync detection -------------------------------------------

class ImplicitTransferError(RuntimeError):
    """A synchronizing CUDA call happened inside a ``transfer_watch`` scope
    (``--transfer-guard disallow``). The ``implicit_transfer`` event was
    already emitted."""


# CUDA's sync-debug mode is one process-wide setting, not a per-thread one
# like JAX's transfer guard: while a scope holds it, every thread's
# synchronizing call is held to it. Scopes therefore nest by count under a
# lock and restore the mode the first one found, and the trainer opens one
# only around the step's dispatch (see train.py).
_sync_lock = threading.Lock()
_sync_depth = [0]
_sync_prev = [0]
_SYNC_MARK = "synchronizing CUDA operation"


def _set_sync_mode(mode):
    import torch

    torch.cuda.set_sync_debug_mode(mode)


@contextlib.contextmanager
def transfer_watch(*, step=None, fn="train_step", device=None, warn=False):
    """Hold the scope's CUDA calls to ``set_sync_debug_mode("error")`` (or
    ``"warn"`` with ``warn``): a synchronizing call becomes an
    ``implicit_transfer`` event + ``implicit_transfer_total`` counter + a
    typed :class:`ImplicitTransferError`. A no-op for a CPU ``device`` or
    where CUDA is not initialised (nothing can sync a card there)."""
    import torch

    cuda = (device is None or torch.device(device).type == "cuda") and \
        torch.cuda.is_available() and torch.cuda.is_initialized()
    if cuda:
        with _sync_lock:
            if _sync_depth[0] == 0:
                _sync_prev[0] = torch.cuda.get_sync_debug_mode()
                _set_sync_mode("warn" if warn else "error")
            _sync_depth[0] += 1
    try:
        yield
    except RuntimeError as e:
        msg = str(e)
        if _SYNC_MARK in msg and not isinstance(e, ImplicitTransferError):
            metrics.counter("implicit_transfer_total").inc()
            bus.emit("implicit_transfer", fn=fn, step=step, error=msg[:400])
            raise ImplicitTransferError(msg) from e
        raise
    finally:
        if cuda:
            with _sync_lock:
                _sync_depth[0] -= 1
                if _sync_depth[0] == 0:
                    _set_sync_mode(_sync_prev[0])


# ---- device-memory sampling -------------------------------------------------

_hbm_state = {"peak": None, "limit": None, "sampled": False}


def sample_hbm(device=None):
    """Sample the caching allocator's bytes in use and their peak (the
    ``allocated_bytes.all`` counters, read from the nested stats: the flat
    ``memory_stats`` dict, which ``memory_allocated`` also builds, costs the
    sync point a sort of every key) into ``hbm_bytes_in_use`` /
    ``hbm_peak_bytes_in_use`` gauges. Returns bytes in use, or None where
    there is no card (CPU) or CUDA is not initialised. Host-side counters:
    no device sync."""
    torch = sys.modules.get("torch")
    try:
        if torch is None or not torch.cuda.is_initialized():
            return None
        if device is None:
            device = torch.cuda.current_device()
        elif torch.device(device).type != "cuda":
            return None
        allocated = torch.cuda.memory_stats_as_nested_dict(device)["allocated_bytes"]["all"]
        in_use, peak = allocated["current"], allocated["peak"]
    except Exception:
        return None  # a dead context: a sample is never worth a raise
    _hbm_state["sampled"] = True
    prev = _hbm_state["peak"]
    _hbm_state["peak"] = peak if prev is None else max(prev, peak, in_use)
    if _hbm_state["limit"] is None:
        try:
            _hbm_state["limit"] = int(torch.cuda.mem_get_info(device)[1])
        except Exception:
            pass
    metrics.gauge("hbm_bytes_in_use").set(int(in_use))
    metrics.gauge("hbm_peak_bytes_in_use").set(int(_hbm_state["peak"]))
    return in_use


def hbm_run_summary(device=None):
    """Peak-vs-budget fields for the ``run_summary`` event, or {} when
    device memory was never sampled. The budget is the card's total memory
    (``mem_get_info``)."""
    if not _hbm_state["sampled"]:
        return {}
    budget = _hbm_state["limit"]
    out = {"hbm_peak_bytes": int(_hbm_state["peak"])}
    if budget:
        out["hbm_budget_bytes"] = int(budget)
        out["hbm_peak_pct"] = round(100.0 * _hbm_state["peak"] / budget, 2)
    return out


def reset_hbm():
    """Forget sampled device-memory state (test isolation, a fresh run)."""
    _hbm_state.update(peak=None, limit=None, sampled=False)


# ---- accelerator probe ------------------------------------------------------

def probe_accelerator(timeout_s=60, retries=1):
    """Count CUDA devices in a SUBPROCESS with a hard timeout (+ retry).

    A CUDA init that blocks (a wedged driver, a card held by a dead process)
    cannot be recovered in-process; the subprocess is killed on timeout and
    the caller stays healthy. Returns ``(ok, reason)``: ``(True, None)``
    when at least one device initialises, else ``(False, "<why>")``.

    stderr goes to a FILE, not a pipe: a hung helper holding an inherited
    pipe end would block ``communicate()`` after the child is killed."""
    reason = None
    for attempt in range(int(retries) + 1):
        with tempfile.TemporaryFile() as errf:
            try:
                probe = subprocess.run(
                    [sys.executable, "-c",
                     "import sys, torch; n = torch.cuda.device_count(); "
                     "print(n); sys.exit(0 if n > 0 else 3)"],
                    stdout=subprocess.DEVNULL, stderr=errf,
                    start_new_session=True, timeout=timeout_s,
                )
                if probe.returncode == 0:
                    return True, None
                errf.seek(0)
                tail = errf.read()[-500:].decode("utf-8", "replace")
                reason = (
                    "probe found no CUDA device" if probe.returncode == 3
                    else f"probe exited {probe.returncode}"
                ) + f" (attempt {attempt + 1}): ...{tail}"
            except subprocess.TimeoutExpired:
                reason = (
                    f"probe hung for {timeout_s}s (attempt {attempt + 1}): "
                    "CUDA init deadlock"
                )
        time.sleep(min(2 ** attempt, 10) * 0.1)
    return False, reason


def emit_platform_fallback(reason, *, resolved=None, expected=None):  # obscheck: once
    """The loud half of the probe: a ``platform_fallback`` event + counter +
    host-0 WARNING. A CPU run must never pass for a card's."""
    metrics.counter("platform_fallback_total").inc()
    rec = bus.emit(
        "platform_fallback", reason=str(reason)[:500],
        resolved=resolved, expected=expected,
    )
    from pyrecover_tpu_torch.utils.logging import log_host0

    log_host0(
        "PLATFORM FALLBACK: %s (resolved platform: %s) — throughput and "
        "MFU numbers from this run are NOT accelerator numbers",
        reason, resolved, level=30,  # WARNING
    )
    return rec


def check_expected_accelerator(device):  # obscheck: once
    """When the environment declares an accelerator expectation
    (``$PYRECOVER_EXPECT_ACCELERATOR`` truthy, or a probe's recorded reason
    in ``$PYRECOVER_PLATFORM_FALLBACK``) and ``device`` is the CPU, emit
    ``platform_fallback`` and return the reason; else None. The trainer
    calls it once its device is known."""
    import torch

    resolved = torch.device(device).type
    prior = os.environ.get(PLATFORM_FALLBACK_ENV)
    expected = os.environ.get(EXPECT_ACCELERATOR_ENV, "")
    if resolved != "cpu":
        return None
    if prior:
        emit_platform_fallback(prior, resolved=resolved)
        return prior
    if expected and expected not in ("0", "false", "no"):
        reason = (
            "an accelerator platform was expected "
            f"(${EXPECT_ACCELERATOR_ENV}={expected!r}) but the run resolved cpu"
        )
        emit_platform_fallback(reason, resolved=resolved, expected=expected)
        return reason
    return None
