"""Zero-downtime weight hot-swap: watcher + double-buffered swap (the JAX
package's ``serving/hotswap/swap.py``).

A serving engine loads weights once and goes stale; this module closes the
train -> serve loop. :class:`HotSwapper` attaches to a live
:class:`~pyrecover_tpu_torch.serving.engine.ServingEngine` and the experiment
directory a trainer is writing checkpoints into, and:

  1. **Watches the registry**: a polling thread discovers newly committed
     checkpoints through ``registry.get_latest_checkpoint`` (a zerostall
     manifest exists only after its atomic rename, so a half-written save is
     invisible). ``stop(timeout)`` joins the thread, bounded.
  2. **Fetches incrementally**: for a zerostall checkpoint the loaded
     manifest's chunk digests are diffed against the new one and ONLY
     changed chunks are read from the chunk store; unchanged ones come from
     the swapper's host cache, every chunk digest-verified before assembly
     (``hotswap/fetch.py``). The manifest is PINNED (``pins.pin_manifest``)
     for the fetch, so the trainer's retention and GC cannot delete chunks
     under the read. Vanilla and sharded checkpoints take the full
     ``load_serving_params`` read through the same preflight and integrity
     gates.
  3. **Swaps double-buffered**: the new model is built and its weights
     copied to the card on the watcher thread, on a CUDA stream of its own,
     so the engine's decode never waits on the copies; an event recorded
     after the last copy travels with the staged model, and the engine's
     flip at a pass boundary makes its stream wait on it
     (``engine.install_params``). In-flight requests never see mixed weights.
     A model whose parameter names, shapes, dtypes or device differ from the
     serving model's is rejected before it is staged.

The host cache holds the bytes of the served weights as the restore or the
last fetch read them (``load_serving_params(..., host_bytes=)``): it is never
rebuilt by reading the card back, which would synchronise the device from
the watcher thread. Without a seeded cache the first incremental swap
fetches every chunk (still verified).

On a serving mesh (``mesh=``, every rank attaching a swapper to its
engine) rank 0's swapper watches and decides; its engine's next plan names
the checkpoint, and each other rank's swapper fetches it in the background
(`fetch_async`) and places its own box of it, incremental or full, as
JAX's ``_place_params(nested, mesh)`` places the tree. Rank 0 flips once
every rank reports it staged, so every rank flips at the same engine step
(``serving/engine.py``); a rank that rejects it makes rank 0 drop the swap
and keep serving.

Failure is loud and non-fatal: any fetch/verify/placement error emits
``weights_swap_rejected`` naming the manifest and reason, the manifest is
remembered as rejected (no retry loop against a bad artifact; a NEWER
manifest resets the clock), and the engine keeps serving the old weights.
Telemetry: ``weights_swap_begin`` / ``swap_fetch_bytes`` /
``weights_swap_rejected`` here, ``weights_swap_done`` from the engine's flip;
gauges ``hotswap_loaded_step``, ``hotswap_fetched_bytes``,
``hotswap_rejected`` and the ``hotswap_rejected_total`` counter.
"""

import contextlib
import threading
import time
from pathlib import Path

import torch

from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.checkpoint.registry import engine_of, get_latest_checkpoint, parse_step
from pyrecover_tpu_torch.checkpoint.vanilla import _check_structure
from pyrecover_tpu_torch.serving.restore import (
    PARAMS_PREFIX,
    load_serving_params,
    place_raw,
    serving_model,
)
from pyrecover_tpu_torch.train_state import param_leaves
from pyrecover_tpu_torch.utils.logging import log_host0


class HotSwapper:
    """Track a training run's checkpoint registry and hot-swap a live serving
    engine's weights. ``start()``/``stop()`` run the polling watcher;
    ``poll_once()``/``swap_to(path)`` are the synchronous surface. Thread
    contract: all swap state (``loaded_step``, the manifest and host-byte
    caches, the rejected set) is mutated only under ``_lock``; the fetch and
    the placement run outside every lock.

    ``loaded_host`` is the served weights' host bytes by manifest path, as
    ``load_serving_params(..., host_bytes=)`` kept them for ``loaded_path``.
    ``mesh``: the serving mesh the engine's model was restored onto; every
    rank attaches a swapper, and only rank 0's watches.
    """

    def __init__(self, engine, exp_dir, model_config, *, loaded_path=None, loaded_host=None,
                 poll_interval_s=1.0, mesh=None):
        self.engine = engine
        self.exp_dir = Path(exp_dir)
        self.model_config = model_config
        self.mesh = mesh
        if mesh is not None:
            engine.swapper = self
        self._rejected_step = None  # the step of the last swap this rank rejected
        self._previous = None  # the loaded state before the last staged swap
        self._fetch_lock = threading.Lock()
        self._fetch_next = None  # a follower's path waiting for the fetch thread
        self._fetch_thread = None
        self.poll_interval_s = float(poll_interval_s)
        self.device = engine.device
        # the stream the watcher copies weights on: a decode pass never
        # queues behind them
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        self._lock = threading.Lock()
        self._loaded_doc = None  # zerostall manifest doc of the loaded weights
        self._host_cache = None  # {manifest path: flat uint8 host bytes}
        self._rejected = {}  # manifest name -> reason (no retry loop)
        self._loaded_step = -1
        if loaded_path is not None:
            step = parse_step(loaded_path)
            self._loaded_step = step if step is not None else -1
            if engine_of(loaded_path) == "zerostall":
                from pyrecover_tpu_torch.checkpoint.zerostall.chunkstore import read_manifest

                self._loaded_doc = read_manifest(loaded_path)
                self._host_cache = dict(loaded_host) if loaded_host else None
        if engine.weights_step is None:
            engine.weights_step = self._loaded_step if self._loaded_step >= 0 else None
        if self._loaded_step >= 0:
            telemetry.metrics.gauge("hotswap_loaded_step").set(self._loaded_step)

        self._thread = None
        self._stop = threading.Event()

    @property
    def loaded_step(self):
        with self._lock:
            return self._loaded_step

    @property
    def rejected_step(self):
        """The step of the last swap this rank rejected, or None."""
        with self._lock:
            return self._rejected_step

    @property
    def rejected(self):
        """``{manifest name: reason}`` of manifests this swapper refused
        (a copy)."""
        with self._lock:
            return dict(self._rejected)

    # ---- watcher thread (bounded lifecycle) -----------------------------

    def start(self):
        """Poll the registry from a background thread until ``stop()``."""
        if self.engine.rank:
            raise RuntimeError("start() on a follower rank of a serving mesh: rank 0's swapper "
                               "watches, and its plans name what this rank fetches")
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("hot-swap watcher already running")
        self._stop.clear()
        self._thread = threading.Thread(target=self._watch_loop, name="hotswap-watcher")
        self._thread.start()

    def stop(self, timeout=60.0):
        """Stop and JOIN the watcher (and a follower's fetch), bounded: a
        wedged fetch surfaces as a TimeoutError naming the thread instead of
        a silent leak."""
        self.join_fetch(timeout)
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"hotswap-watcher thread did not stop within {timeout}s")
        self._thread = None

    def fetch_async(self, path):
        """A follower rank: fetch and stage ``path`` (rank 0's choice) on a
        thread of its own; a path named while a fetch runs waits for it
        (the latest wins)."""
        with self._fetch_lock:
            self._fetch_next = path
            if self._fetch_thread is not None and self._fetch_thread.is_alive():
                return
            self._fetch_thread = threading.Thread(target=self._fetch_loop, name="hotswap-fetch")
            self._fetch_thread.start()

    def _fetch_loop(self):
        while True:
            with self._fetch_lock:
                path, self._fetch_next = self._fetch_next, None
                if path is None:
                    self._fetch_thread = None
                    return
            self.swap_to(path)

    def join_fetch(self, timeout=60.0):
        """Wait for a follower's background fetch, bounded."""
        t = self._fetch_thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError(f"hotswap-fetch thread did not finish within {timeout}s")

    def dropped(self, path, reason):
        """Rank 0: another rank rejected the staged swap to ``path``; the
        engine keeps its weights, so this swapper goes back to them and
        will not retry that manifest."""
        with self._lock:
            if self._previous is not None:
                self._loaded_step, self._loaded_doc, self._host_cache = self._previous
                self._previous = None
            if path is not None:
                self._rejected[Path(path).name] = reason

    def _watch_loop(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:  # a poll crash must not kill the watcher
                log_host0("hot-swap poll failed (%s: %s); retrying next interval",
                          type(e).__name__, e, level=30)  # WARNING
            self._stop.wait(self.poll_interval_s)

    # ---- swap surface ---------------------------------------------------

    def poll_once(self):
        """One registry poll: swap to the newest committed checkpoint if it
        is newer than the loaded weights and not already rejected. Returns
        True when a swap was staged."""
        latest = get_latest_checkpoint(self.exp_dir)
        if latest is None:
            return False
        step = parse_step(latest)
        with self._lock:
            stale = step is None or step <= self._loaded_step or latest.name in self._rejected
        if stale:
            return False
        return self.swap_to(latest)

    def swap_to(self, path):
        """Fetch, verify and place ``path``'s params and stage them for the
        engine's next pass boundary. Returns True on success; on any failure
        emits ``weights_swap_rejected``, records the manifest as rejected and
        leaves the engine serving its current weights."""
        path = Path(path)
        step = parse_step(path)
        ckpt_engine = engine_of(path)
        t0 = time.monotonic()
        with self._lock:
            from_step = self._loaded_step
        telemetry.emit("weights_swap_begin", path=str(path), engine=ckpt_engine,
                       from_step=from_step, to_step=step)
        try:
            with self._on_stream():
                if ckpt_engine == "zerostall":
                    model, new_doc, new_cache, stats = self._fetch_zerostall(path)
                else:
                    model, stats = self._fetch_full(path)
                    new_doc, new_cache = None, None
                ready = None
                if self._stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(self._stream)
            self._check_shape_stable(model, path)
        except Exception as e:
            reason = f"{type(e).__name__}: {e}"
            with self._lock:
                self._rejected[path.name] = reason
                self._rejected_step = step
                n_rejected = len(self._rejected)
            telemetry.metrics.counter("hotswap_rejected_total").inc()
            telemetry.metrics.gauge("hotswap_rejected").set(n_rejected)
            telemetry.emit("weights_swap_rejected", path=str(path), engine=ckpt_engine,
                           from_step=from_step, to_step=step, reason=reason[:500])
            log_host0("hot-swap to %s REJECTED (%s) — still serving step %s", path.name,
                      reason, from_step, level=30)  # WARNING
            return False
        self.engine.install_params(
            model, step=step, ready=ready,
            info={"t_begin": t0, "path": str(path), "engine": ckpt_engine,
                  "from_step": from_step, "fetched_bytes": stats["fetched_bytes"],
                  "reused_bytes": stats["reused_bytes"]})
        with self._lock:
            self._previous = (self._loaded_step, self._loaded_doc, self._host_cache)
            self._loaded_step = step
            self._loaded_doc = new_doc
            self._host_cache = new_cache
        # the swap state the dashboard renders (the engine's
        # weights_swaps_total counter ticks when the flip lands)
        telemetry.metrics.gauge("hotswap_loaded_step").set(step)
        telemetry.metrics.gauge("hotswap_fetched_bytes").set(stats["fetched_bytes"])
        return True

    def _on_stream(self):
        """The watcher's copy stream as the current one (a no-op on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    # ---- fetch paths ----------------------------------------------------

    def _fetch_zerostall(self, path):
        """Incremental chunk fetch under a pin lease; returns ``(model,
        manifest_doc, host_cache, stats)``."""
        from pyrecover_tpu_torch.checkpoint.zerostall import pins
        from pyrecover_tpu_torch.checkpoint.zerostall.chunkstore import read_manifest
        from pyrecover_tpu_torch.serving.hotswap.fetch import fetch_params_incremental

        doc = read_manifest(path)
        with self._lock:
            old_doc = self._loaded_doc
            old_host = dict(self._host_cache or {})
        entries = [e for e in doc["leaves"] if e["path"].startswith(PARAMS_PREFIX)]
        model = serving_model(self.model_config, self.device, self.mesh)
        leaves = param_leaves(model)
        # the manifest must fit the model before a chunk is read
        _check_structure({"paths": [e["path"] for e in entries],
                          "leaves": [{"dtype": e["dtype"], "shape": e["shape"]}
                                     for e in entries]}, leaves, path, warn_cast=False)
        # the lease (a copy of the digest map) keeps the chunks alive while
        # the trainer's retention + GC may prune the manifest, or, if this
        # process dies mid-fetch, until the lease expires
        with pins.pin_manifest(self.exp_dir, path, doc, owner=f"hotswap{id(self) & 0xffff:x}"):
            flat, stats = fetch_params_incremental(self.exp_dir, doc, old_doc, old_host,
                                                   manifest_path=path)
        telemetry.emit("swap_fetch_bytes", path=str(path), incremental=True,
                       **{k: stats[k] for k in ("fetched_bytes", "reused_bytes", "chunks_fetched",
                                                "chunks_reused", "changed_leaves", "leaves")})
        for leaf, entry, (_, raw) in zip(leaves, entries, flat):
            place_raw(leaf, torch.from_numpy(raw), entry["dtype"])
        return model, doc, dict(flat), stats

    def _fetch_full(self, path):
        """Vanilla/sharded: the whole-checkpoint serving restore (elastic
        preflight, integrity verification, placement), the cold start's API."""
        model, info = load_serving_params(path, self.model_config, device=self.device,
                                          mesh=self.mesh)
        stats = {"fetched_bytes": int(info.get("bytes", 0)), "reused_bytes": 0}
        telemetry.emit("swap_fetch_bytes", path=str(path), incremental=False,
                       fetched_bytes=stats["fetched_bytes"], reused_bytes=0, chunks_fetched=0,
                       chunks_reused=0, changed_leaves=int(info.get("leaves", 0)),
                       leaves=int(info.get("leaves", 0)))
        return model, stats

    def _check_shape_stable(self, model, path):
        """The staged model must match the serving model parameter for
        parameter: names, shapes, dtypes and device. A drifted checkpoint
        (another model config) is rejected BEFORE staging."""
        served = dict(self.engine.model.named_parameters())
        staged = dict(model.named_parameters())
        if list(served) != list(staged):
            raise ValueError(f"{path.name}: parameter names differ from the serving model's — "
                             "not the same model")
        for name, new in staged.items():
            old = served[name]
            if (tuple(old.shape), old.dtype, old.device) != (tuple(new.shape), new.dtype,
                                                              new.device):
                raise ValueError(
                    f"{path.name}: {name} {tuple(new.shape)}/{new.dtype}/{new.device} vs serving "
                    f"{tuple(old.shape)}/{old.dtype}/{old.device} — a swap must be shape-stable")
