"""Continuous-batching serving engine with a prefill/decode split, ported
from the JAX package's ``serving/engine.py``.

``models/decode.py:generate_tokens`` is lockstep: one batch of equal-length
prompts admitted up front, finished sequences holding their memory until the
slowest one ends. This engine serves the same model math under traffic:

* **Slots, not batches.** The decode step runs at a fixed slot width
  (``max_seqs``), one token per live slot. A finished sequence releases its
  KV blocks and its slot mid-step; the next queued request takes them at the
  next scheduler pass.
* **Prefill split from decode.** New requests prefill one sequence at a
  time in chunks of ``prefill_chunk`` tokens, at most
  ``prefill_token_budget`` prompt tokens between two decode steps, so a long
  prompt cannot starve the running batch.
* **Admission control on free blocks.** A request is admitted only when a
  slot is free AND the pool covers its whole lifetime
  (``ceil((prompt + max_new) / block_size)`` blocks), so allocation never
  fails mid-flight; pool pressure shows as ``serving_backpressure_total``.
* **Request latency.** Each request carries monotonic stamps from submit to
  done, which feed the ``ttft_s``, ``tpot_s`` and ``e2e_s`` histograms.

Threading: ``submit()`` and ``install_params()`` may be called from any
thread; the waiting queue and the staged weights are the only state shared
across threads, and every touch holds ``_lock``. Staged weights copied on
another CUDA stream come with an event recorded after their last copy: the
flip makes the pump's stream wait on it, and marks every staged tensor as
used on that stream, so the first pass after a swap cannot read half-copied
weights and a retired model's memory is not reused before the passes already
queued on it have run. The scheduler state (slots,
tables, the pool's free list, in-flight requests) is mutated by exactly one
consumer, the caller pumping ``step()`` or the thread ``start()`` runs,
never both (``step()`` raises while the background loop owns the engine).
Device work runs outside the lock; the forwards enter inference mode
themselves, in whichever thread calls them. Only the chosen token ids
(``max_seqs`` ints) come back to the host each step.

On a serving mesh (a model from ``load_serving_params(mesh=)``, one
process a rank, every rank building its engine) the ranks run in lockstep,
as JAX's single controller runs one program over a placed tree. Rank 0 owns
admission, the queue, every clock and the sampling: before each forward (a
prefill chunk or the decode step) it sends its plan to the other ranks in
one small message over a gloo group of the engine's own (tokens,
positions, block tables, and a weights fetch or flip if any), every rank
runs that forward against its own pool, and the logits ``project_vocab``
gathers reach rank 0. The other ranks run `follow`, which executes
exactly those plans and returns at rank 0's `release_followers`. After
each forward every rank reports its staged weights in one exchange. A
rank that fails its part of a step leaves the process group, so a peer
waiting on it in a collective errors at once (over gloo; a peer in an NCCL
collective errors at the group's timeout), and every rank raises
`MeshServingError` at that step: no hang, no partial result. ``submit`` on
another rank than 0 raises. A hot swap on a mesh (``serving/hotswap/``) is rank 0's
decision: its plan names the checkpoint, each rank's swapper places its own
box of it, and rank 0 flips only once every rank reports those weights
staged, carrying the flip in the next plan, so every rank flips at the same
forward (``flips``).

Telemetry, as in the JAX package: ``request_admitted``, ``request_done`` and
``kv_backpressure`` events, and a finished request's retroactive
``req_queue``/``req_prefill``/``req_decode`` spans under the trace context
installed on the submitting thread, if any. A weights flip emits
``weights_swap_done`` and records a ``swap_stall`` span under each traced
in-flight request (``serving/hotswap/``).
"""

import dataclasses
import datetime
import threading
import time

import numpy as np
import torch

from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.models.decode import kv_layout, model_device
from pyrecover_tpu_torch.serving.kvpool import KV_MODES, BlockPool, blocks_for, make_block_table
from pyrecover_tpu_torch.serving.paged import paged_forward
from pyrecover_tpu_torch.telemetry import metrics, tracing

# request lifecycle
QUEUED, PREFILL, RUNNING, DONE = "queued", "prefill", "running", "done"


class EngineStoppedError(RuntimeError):
    """``submit()`` after ``stop()``: the engine takes no new work until
    ``start()`` or ``reopen()``."""


class MeshServingError(RuntimeError):
    """A rank of a serving mesh failed a lockstep step; every rank raises
    it at that step."""


# the lockstep group's bound: followers wait in it while rank 0 idles
LOCKSTEP_TIMEOUT_S = 24 * 3600.0
# rank 0's status exchanges while a staged swap waits for the other ranks
LOCKSTEP_SYNC_S = 0.02


class _Lockstep:
    """The plan channel of a serving mesh: rank 0 broadcasts each plan, and
    after it every rank reports ``[0, staged step, rejected step]`` over a
    gloo group of its own (created on every rank, in the same order, when
    the engines are built)."""

    def __init__(self):
        import torch.distributed as dist

        self.dist = dist
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.group = dist.new_group(backend="gloo",
                                    timeout=datetime.timedelta(seconds=LOCKSTEP_TIMEOUT_S))
        self.status = None  # every rank's last report
        self.fetch = None  # rank 0: (path, step) the next plan announces
        self.flip = None  # rank 0: the step the next forward flips to
        self.t_sync = 0.0

    def send(self, plan):
        self.dist.broadcast_object_list([plan], src=0, group=self.group)

    def recv(self):
        box = [None]
        self.dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def exchange(self, staged, rejected):
        mine = torch.tensor([0, staged, rejected], dtype=torch.int64)
        out = [torch.empty_like(mine) for _ in range(self.world)]
        self.dist.all_gather(out, mine, group=self.group)
        self.status = [t.tolist() for t in out]
        return self.status

    def leave(self):
        """After a failure: leave the process group, so a peer waiting on
        this rank in any collective errors at once instead of waiting out
        the group's timeout."""
        if self.dist.is_initialized():
            self.dist.destroy_process_group()

    def staged_everywhere(self, step):
        """Every other rank reported the weights of ``step`` staged."""
        return self.status is not None and all(s[1] == step for s in self.status[1:])

    def rejected_by(self, step):
        return [r for r, s in enumerate(self.status or []) if r and s[2] == step]


@dataclasses.dataclass
class ServingConfig:
    """Engine sizing (each chunk width is fixed for the engine's life)."""

    block_size: int = 16  # token positions per KV block
    num_blocks: int = 0  # 0 -> derive from pool_bytes
    pool_bytes: int = 0  # byte budget when num_blocks == 0
    max_seqs: int = 4  # decode slot count (batch width)
    prefill_chunk: int = 32  # prefill chunk width
    prefill_token_budget: int = 64  # prefill tokens per scheduler pass
    kv_mode: str = "native"  # "native" (pool in compute dtype) | "int8"
    max_model_len: int = 0  # 0 -> model_config.max_seq_len

    def __post_init__(self):
        if self.kv_mode not in KV_MODES:
            raise ValueError(f"kv_mode must be one of {KV_MODES}, got {self.kv_mode!r}")
        for name in ("block_size", "max_seqs", "prefill_chunk"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive, got {getattr(self, name)}")
        if self.prefill_token_budget < self.prefill_chunk:
            raise ValueError(
                f"prefill_token_budget ({self.prefill_token_budget}) must cover at least one "
                f"prefill_chunk ({self.prefill_chunk}) or prefill can never make progress"
            )


@dataclasses.dataclass
class Request:
    """One in-flight generation request (host-side bookkeeping only)."""

    rid: int
    prompt: list
    max_new_tokens: int
    eos_id: int = None
    state: str = QUEUED
    tokens: list = dataclasses.field(default_factory=list)  # prompt + new
    blocks: list = None
    slot: int = None
    prefill_pos: int = 0  # prompt positions already cached
    t_submit: float = 0.0
    t_admit: float = None
    t_first_token: float = None
    t_done: float = None
    backpressure_noted: bool = False
    trace: object = None  # a telemetry.tracing.TraceContext, when one came with it

    @property
    def n_new(self):
        return len(self.tokens) - len(self.prompt)

    @property
    def finished(self):
        return self.state == DONE

    def result(self):
        """Prompt + generated ids (the ``generate_tokens`` return shape)."""
        return list(self.tokens)


class ServingEngine:
    """Continuous-batching engine over the paged KV pool.

    ``model`` is a ``Transformer`` used read-only, typically from
    ``serving.restore.load_serving_params``; the pool lives on its device.
    ``submit()`` is thread-safe; scheduling runs through ``step()`` (manual
    pump) or ``start()``/``stop()`` (a background thread).
    """

    def __init__(self, model, serving_config=None):
        self.model = model
        self.model_config = model_config = model.config
        self.config = cfg = serving_config or ServingConfig()
        self.device = model_device(model)
        self.max_model_len = int(cfg.max_model_len or model_config.max_seq_len)
        if self.max_model_len > model_config.max_seq_len:
            raise ValueError(
                f"max_model_len {self.max_model_len} exceeds the model's trained position "
                f"range max_seq_len {model_config.max_seq_len}"
            )
        pool_kw = dict(kv_mode=cfg.kv_mode, device=self.device, **kv_layout(model))
        if cfg.num_blocks:
            self.pool = BlockPool(model_config, cfg.num_blocks, cfg.block_size, **pool_kw)
        elif cfg.pool_bytes:
            self.pool = BlockPool.from_budget(model_config, cfg.pool_bytes, cfg.block_size,
                                              **pool_kw)
        else:
            # max_seqs full-length sequences plus the trash block
            self.pool = BlockPool(
                model_config, cfg.max_seqs * blocks_for(self.max_model_len, cfg.block_size) + 1,
                cfg.block_size, **pool_kw,
            )
        self.table_width = self.pool.table_width(self.max_model_len)

        # cross-thread state under _lock: the submission queue and the
        # staged weights waiting for the next pass boundary
        self._lock = threading.Lock()
        self._waiting = []  # FIFO of QUEUED requests
        self._closed = False  # set by stop(): submit() raises
        self._next_rid = 0
        self._staged_swap = None  # set by install_params, consumed by _pump
        self.weights_step = None  # step of the serving weights, if known

        # single-consumer scheduler state
        self._prefill = []  # admitted, still caching their prompt
        self._slots = [None] * cfg.max_seqs  # admitted requests by slot
        self._tables = np.tile(make_block_table(self.table_width), (cfg.max_seqs, 1))
        self._done = {}  # rid -> Request
        self._arrays = self.pool.arrays

        self._thread = None
        self._stop = threading.Event()

        # a serving mesh's lockstep (see the module docstring)
        self.mesh = getattr(model, "mesh", None)
        self._lockstep = None
        if self.mesh is not None:
            from pyrecover_tpu_torch.parallel.mesh import world_size

            if world_size() > 1:
                self._lockstep = _Lockstep()
        self.swapper = None  # a mesh rank's HotSwapper (serving/hotswap/)
        self.steps_run = 0  # forwards run (lockstep steps on a mesh)
        self.flips = []  # (forward index, step) of each weights flip

        # gauge state (pump thread only): rate-limit stamp, peak occupancy
        # and the (ts, tokens_total) window the tokens/s gauge derives from
        self._gauge_stamp = 0.0
        self._peak_occupancy_pct = 0.0
        self._tok_total = 0
        self._tok_window = []

    @property
    def rank(self):
        """This engine's rank on its serving mesh (0 without one)."""
        return self._lockstep.rank if self._lockstep is not None else 0

    def _forward(self, tokens, pos, tables):
        ls = self._lockstep
        if ls is None:
            return self._run_forward(tokens, pos, tables)
        with self._lock:
            fetch, ls.fetch = ls.fetch, None
        plan = {"op": "forward", "tokens": np.asarray(tokens).tolist(),
                "pos": np.asarray(pos).tolist(), "tables": np.asarray(tables).tolist(),
                "fetch": fetch, "flip": ls.flip}
        ls.flip = None
        self._send(plan)
        return self._execute(plan)

    def _send(self, plan):
        """Rank 0: one plan to every other rank."""
        ls = self._lockstep
        try:
            ls.send(plan)
        except Exception as e:  # a follower left the group
            ls.leave()
            raise MeshServingError(f"serving mesh: rank 0 could not send its plan "
                                   f"({type(e).__name__}: {e})") from e

    def _run_forward(self, tokens, pos, tables):
        cfg = self.config
        self.steps_run += 1
        return paged_forward(self.model, self._arrays, tokens, pos, tables,
                             block_size=cfg.block_size, kv_mode=cfg.kv_mode,
                             rope_len=self.max_model_len)

    def _execute(self, plan):
        """Every rank's side of one plan: a follower starts the fetch it
        names and flips where it says, then the forward, then the exchange
        of staged steps. A rank whose side fails leaves the process group,
        so no peer waits on it in a collective: every rank raises
        `MeshServingError` at that step."""
        ls = self._lockstep
        logits = None
        try:
            if ls.rank:
                if plan.get("fetch"):
                    if self.swapper is None:
                        raise RuntimeError("rank 0 announced a weights swap but this rank has "
                                           "no HotSwapper(mesh=) attached to its engine")
                    self.swapper.fetch_async(plan["fetch"][0])
                if plan.get("flip") is not None:
                    self._flip_follower(plan["flip"])
            if plan["op"] == "forward":
                logits = self._run_forward(plan["tokens"], plan["pos"], plan["tables"])
            with self._lock:
                staged = self._staged_swap["step"] if self._staged_swap else None
            rejected = self.swapper.rejected_step if self.swapper is not None else None
            ls.exchange(-1 if staged is None else staged, -1 if rejected is None else rejected)
        except Exception as e:
            ls.leave()
            raise MeshServingError(
                f"serving mesh: rank {ls.rank} failed at lockstep step {self.steps_run} "
                f"({type(e).__name__}: {e}); it left the process group, so every rank "
                "raises at this step") from e
        return logits

    def _flip_follower(self, step):
        with self._lock:
            staged = self._staged_swap["step"] if self._staged_swap else None
        if staged != step:
            raise RuntimeError(f"rank 0 flips to step {step} but this rank has step {staged} "
                               "staged")
        self._apply_staged_swap()

    def follow(self):
        """A follower rank's loop: execute rank 0's plans until its
        `release_followers`. Raises `MeshServingError` when any rank fails
        a step."""
        ls = self._lockstep
        if ls is None or ls.rank == 0:
            raise RuntimeError("follow() runs on the ranks of a serving mesh other than 0")
        while True:
            try:
                plan = ls.recv()
            except Exception as e:  # rank 0 left the group
                ls.leave()
                raise MeshServingError(f"serving mesh: rank {ls.rank} lost rank 0's plans "
                                       f"({type(e).__name__}: {e})") from e
            if plan["op"] == "stop":
                return
            self._execute(plan)

    def release_followers(self):
        """Rank 0: end the other ranks' `follow` loops (a no-op without a
        mesh)."""
        ls = self._lockstep
        if ls is not None and ls.rank == 0:
            self._send({"op": "stop"})

    def _sync_followers(self):
        """Rank 0, while a staged swap waits for the other ranks: one plan
        without a forward, rate-limited, so their reports (and the fetch
        announcement) travel while no request runs."""
        ls = self._lockstep
        now = time.monotonic()
        if now - ls.t_sync < LOCKSTEP_SYNC_S:
            return
        ls.t_sync = now
        with self._lock:
            fetch, ls.fetch = ls.fetch, None
        plan = {"op": "sync", "fetch": fetch, "flip": ls.flip}
        ls.flip = None
        self._send(plan)
        self._execute(plan)

    # ---- submission (any thread) -------------------------------------

    def submit(self, prompt, max_new_tokens, *, eos_id=None):
        """Queue one request; returns its rid. Thread-safe."""
        if self.rank:
            raise RuntimeError(f"submit() on rank {self.rank} of a serving mesh: rank 0 owns "
                               "admission; the other ranks run follow()")
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("prompt must contain at least one token id")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        total = len(prompt) + int(max_new_tokens)
        if total > self.max_model_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"max_model_len {self.max_model_len}"
            )
        # a footprint beyond the pool's TOTAL usable blocks can never be
        # admitted: it would park at the head of the FIFO forever and
        # deadlock every request queued behind it
        need = blocks_for(total, self.config.block_size)
        if need > self.pool.usable_blocks:
            raise ValueError(
                f"request needs {need} KV blocks ({total} positions at block_size "
                f"{self.config.block_size}) but the pool only has {self.pool.usable_blocks} "
                "usable blocks; grow num_blocks/pool_bytes or shrink the request"
            )
        req = Request(rid=-1, prompt=prompt, max_new_tokens=int(max_new_tokens),
                      eos_id=eos_id, tokens=list(prompt), t_submit=time.monotonic(),
                      trace=tracing.current())
        with self._lock:
            if self._closed:
                raise EngineStoppedError(
                    "engine is stopped: submit() after stop() would queue a request no "
                    "scheduler pass will ever run (start() or reopen() to accept work again)"
                )
            req.rid = self._next_rid
            self._next_rid += 1
            self._waiting.append(req)
        return req.rid

    def result(self, rid):
        """A finished request's token ids (prompt + generated), or None."""
        req = self._done.get(rid)
        return req.result() if req is not None else None

    # ---- weights swap --------------------------------------------------

    def install_params(self, model, *, step=None, info=None, ready=None):
        """Stage a new, fully placed model (same parameter names, shapes,
        dtypes and device; the hot-swapper checks) for the next pass
        boundary. Thread-safe: only the reference is stored under the lock.
        ``ready`` is a CUDA event recorded after the model's last copy when
        those copies ran on another stream. The pump flips it in at the top
        of a pass, so no request sees mixed weights within a pass; a second
        install before the flip replaces the first (latest wins). On rank 0
        of a serving mesh ``info["path"]`` names the checkpoint: the next
        plan announces it, and the flip waits until every rank has staged
        its own box of it."""
        ls = self._lockstep
        if ls is not None and ls.rank == 0 and not (info or {}).get("path"):
            raise ValueError("install_params on a serving mesh needs info['path']: the "
                             "checkpoint every rank places its own box of")
        with self._lock:
            self._staged_swap = {"model": model, "step": step, "info": dict(info or {}),
                                 "ready": ready, "t_staged": time.monotonic()}
            if ls is not None and ls.rank == 0:
                ls.fetch = (str(info["path"]), step)

    def _apply_staged_swap(self):
        """The pass-boundary flip (pump thread only): consume the staged
        model and emit ``weights_swap_done`` once it serves."""
        t_flip = time.monotonic()
        ls = self._lockstep
        with self._lock:
            staged = self._staged_swap
            if staged is None:
                return False
            waiting = ls is not None and ls.rank == 0 and (
                ls.fetch is not None or not ls.staged_everywhere(staged["step"]))
            if not waiting:
                self._staged_swap = None
        if waiting:
            dropped_by = ls.rejected_by(staged["step"])
            if dropped_by:
                self._drop_staged_swap(staged, dropped_by)
            else:
                self._sync_followers()
            return False
        model = staged["model"]
        if staged["ready"] is not None:
            # the copies ran on the stager's stream: this pass's kernels wait
            # for them on the card, and the allocator keeps each tensor until
            # the work queued on this stream has read it
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(staged["ready"])
            for p in model.parameters():
                p.record_stream(stream)
        self.model = model
        self.weights_step = staged["step"]
        self.flips.append((self.steps_run, staged["step"]))
        if ls is not None and ls.rank == 0:
            ls.flip = staged["step"]  # the next plan flips every other rank
        info = staged["info"]
        t_begin = info.pop("t_begin", staged["t_staged"])
        t_live = time.monotonic()
        in_flight = [s for s in self._slots if s is not None]
        telemetry.emit("weights_swap_done", step=staged["step"],
                       swap_s=round(t_live - t_begin, 6), in_flight=len(in_flight), **info)
        # the swap window as each traced in-flight request saw it, a
        # `swap_stall` child span under its dispatch attempt, so trace
        # assembly attributes the stall to the swap and not to decode
        for req in in_flight:
            if req.trace is not None:
                telemetry.record_span("swap_stall", t_flip, t_live, parent=req.trace.span,
                                      trace=req.trace.trace, attempt=req.trace.attempt,
                                      rid=req.rid, step=staged["step"])
        metrics.counter("weights_swaps_total").inc()
        return True

    def _drop_staged_swap(self, staged, ranks):
        """Rank 0: another rank rejected the staged weights; serve on with
        the current ones, as a rejected swap does on one card."""
        with self._lock:
            if self._staged_swap is staged:
                self._staged_swap = None
        reason = f"rank(s) {ranks} of the serving mesh rejected step {staged['step']}"
        telemetry.emit("weights_swap_rejected", path=staged["info"].get("path"),
                       to_step=staged["step"], reason=reason)
        metrics.counter("hotswap_rejected_total").inc()
        if self.swapper is not None:
            self.swapper.dropped(staged["info"].get("path"), reason)

    # ---- scheduling (single consumer) --------------------------------

    @property
    def pending(self):
        with self._lock:
            waiting = len(self._waiting)
        return waiting + len(self._prefill) + sum(1 for s in self._slots if s is not None)

    def step(self):
        """One scheduler pass: admit, prefill (budgeted), decode. Returns
        True when any work was done. Raises while the background loop owns
        the engine."""
        if self.rank:
            raise RuntimeError("step() on a follower rank of a serving mesh: run follow()")
        owner = self._loop_owner()
        if owner is not None and threading.current_thread() is not owner:
            raise RuntimeError(
                "the background serving loop owns this engine; stop() it before pumping "
                "step() manually"
            )
        return self._pump()

    def run_until_drained(self, max_steps=100000):
        """Pump until every submitted request is DONE."""
        for _ in range(max_steps):
            if not self.step() and self.pending == 0:
                return
        raise RuntimeError(
            f"engine did not drain in {max_steps} steps ({self.pending} requests still pending)"
        )

    def _loop_owner(self):
        """The background thread while it actually runs. A loop that outlived
        ``stop()``'s join timeout but has since exited no longer owns the
        engine, which would otherwise refuse step() and start() forever."""
        t = self._thread
        if t is not None and t.ident is not None and not t.is_alive():
            self._thread = None
            return None
        return t

    def start(self):
        """Serve from a background thread until ``stop()``."""
        if self.rank:
            raise RuntimeError("start() on a follower rank of a serving mesh: run follow()")
        if self._loop_owner() is not None:
            raise RuntimeError("serving loop already running")
        self._stop.clear()
        with self._lock:
            self._closed = False
        self._thread = threading.Thread(target=self._serve_loop, name="serving-engine")
        self._thread.start()

    def reopen(self):
        """Re-arm ``submit()`` after ``stop()`` for manual ``step()`` pumping.
        Refuses while a background loop owns the engine."""
        if self._loop_owner() is not None:
            raise RuntimeError("serving loop is running; reopen() is for manual pumping")
        with self._lock:
            self._closed = False

    def stop(self, timeout=60.0):
        """Stop and join the background loop, bounded by ``timeout``: a wedged
        device call raises ``TimeoutError``. The stop flag stays set, so a
        wedged thread that later exits gives the engine back to step() and
        start()."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"serving-engine thread did not stop within {timeout}s")
        # closed only once the loop exited: after a timed-out join the engine
        # stays open for the wedged-thread recovery path
        with self._lock:
            self._closed = True
        self._thread = None

    def _serve_loop(self):
        while not self._stop.is_set():
            if not self._pump():
                self._stop.wait(0.001)  # idle: wait for submissions without spinning
        # the last pass's state, whatever the rate limit held back: a run that
        # drains inside one window would otherwise leave its start's gauges
        self._update_gauges(force=True)

    def _pump(self):
        # a staged swap applies FIRST, so the whole pass runs on one model
        progressed = self._apply_staged_swap()
        progressed = self._admit() or progressed
        progressed = self._do_prefill() or progressed
        progressed = self._do_decode() or progressed
        self._update_gauges()
        return progressed

    def _update_gauges(self, force=False):
        """Refresh the serving gauges (KV occupancy, active and queued
        depth, decode tokens/s). Pump thread only; rate-limited unless
        ``force``, no device sync."""
        now = time.monotonic()
        usable = self.pool.usable_blocks
        occupancy = 100.0 * self.pool.held_blocks / max(usable, 1)
        self._peak_occupancy_pct = max(self._peak_occupancy_pct, occupancy)
        if now - self._gauge_stamp < 0.05 and not force:
            return
        self._gauge_stamp = now
        g = metrics.gauge
        g("kv_pool_free_blocks").set(self.pool.free_blocks)
        g("kv_pool_usable_blocks").set(usable)
        g("kv_pool_occupancy_pct").set(round(occupancy, 3))
        g("kv_pool_peak_occupancy_pct").set(round(self._peak_occupancy_pct, 3))
        g("serving_active_seqs").set(sum(1 for s in self._slots if s is not None))
        with self._lock:
            queued = len(self._waiting)
        g("serving_queued").set(queued)
        # decode rate over a short sliding window of cumulative totals; keep
        # two samples so a slow pump still yields a rate
        window = self._tok_window
        window.append((now, self._tok_total))
        while len(window) > 2 and window[0][0] < now - 2.0:
            window.pop(0)
        dt = now - window[0][0]
        if dt > 0:
            g("serving_tokens_per_sec").set(round((self._tok_total - window[0][1]) / dt, 2))

    # admission: only when a slot AND the whole block footprint are free (no
    # partial grants, no mid-flight allocation); a blocked head of the queue
    # counts one backpressure event per stall
    def _admit(self):
        admitted = False
        while True:
            free_slots = [i for i, s in enumerate(self._slots) if s is None]
            with self._lock:
                if not self._waiting:
                    return admitted
                req = self._waiting[0]
                need = blocks_for(len(req.prompt) + req.max_new_tokens, self.config.block_size)
                blocked = not free_slots or need > self.pool.free_blocks
                if blocked:
                    note = not req.backpressure_noted
                    req.backpressure_noted = True
                else:
                    self._waiting.pop(0)
            if blocked:
                if note:
                    telemetry.emit(
                        "kv_backpressure", rid=req.rid, needed_blocks=need,
                        free_blocks=self.pool.free_blocks, free_slots=len(free_slots),
                        queued=len(self._waiting),
                    )
                    metrics.counter("serving_backpressure_total").inc()
                return admitted
            req.blocks = self.pool.alloc(req.rid, need)
            try:
                req.slot = free_slots[0]
                req.state = PREFILL
                req.t_admit = time.monotonic()
                self._slots[req.slot] = req
                self._tables[req.slot] = make_block_table(self.table_width, req.blocks)
                self._prefill.append(req)
            except BaseException:
                # admission failed after the grant: hand the blocks back before
                # propagating, or check_drained() reports a leak for a request
                # that never ran
                self.pool.release(req.rid)
                req.blocks = None
                if req.slot is not None and self._slots[req.slot] is req:
                    self._slots[req.slot] = None
                req.slot = None
                raise
            telemetry.emit(
                "request_admitted", rid=req.rid, prompt_tokens=len(req.prompt),
                max_new_tokens=req.max_new_tokens, blocks=need, slot=req.slot,
                queue_s=round(req.t_admit - req.t_submit, 6),
            )
            admitted = True

    # prefill: chunked and budgeted, at most prefill_token_budget prompt
    # tokens a pass, so decode latency is bounded by a known constant
    def _do_prefill(self):
        cfg = self.config
        budget = cfg.prefill_token_budget
        progressed = False
        while budget >= cfg.prefill_chunk and self._prefill:
            req = self._prefill[0]
            chunk, start = self._prefill_chunk_inputs(req)
            logits = self._forward(chunk, [start], self._tables[req.slot:req.slot + 1])
            budget -= cfg.prefill_chunk
            progressed = True
            req.prefill_pos = min(start + cfg.prefill_chunk, len(req.prompt))
            if req.prefill_pos >= len(req.prompt):
                # final chunk: the last prompt position's logits give the
                # first generated token; TTFT stops here
                first = int(logits[0, len(req.prompt) - 1 - start].argmax())
                self._prefill.pop(0)
                req.t_first_token = time.monotonic()
                req.tokens.append(first)
                req.state = RUNNING
                self._tok_total += 1
                metrics.counter("serving_tokens_total").inc()
                metrics.histogram("ttft_s").observe(req.t_first_token - req.t_submit)
                self._maybe_finish(req)
        return progressed

    def _prefill_chunk_inputs(self, req):
        """The next prompt chunk, zero-padded to the chunk width (padding
        positions are overwritten before any query attends them, or go to
        the trash block)."""
        cfg = self.config
        start = req.prefill_pos
        rows = req.prompt[start:start + cfg.prefill_chunk]
        rows = rows + [0] * (cfg.prefill_chunk - len(rows))
        return np.asarray([rows], np.int64), start

    # decode: ONE fixed-width step for every live slot
    def _do_decode(self):
        live = [r for r in self._slots if r is not None and r.state == RUNNING]
        if not live:
            return False
        tok = np.zeros((self.config.max_seqs, 1), np.int64)
        pos = np.zeros((self.config.max_seqs,), np.int64)
        # slots that are not RUNNING (idle, or a request mid-prefill whose
        # slot already holds a real table) decode against a trash-only row:
        # the forward writes KV for EVERY row, and a real table would get the
        # dummy tok 0 / pos 0 entry over the sequence's position 0 each pass
        tables = np.tile(make_block_table(self.table_width), (self.config.max_seqs, 1))
        for req in live:
            tok[req.slot, 0] = req.tokens[-1]
            pos[req.slot] = len(req.tokens) - 1
            tables[req.slot] = self._tables[req.slot]
        next_ids = self._forward(tok, pos, tables)[:, 0].argmax(dim=-1).tolist()
        for req in live:
            req.tokens.append(next_ids[req.slot])
            self._maybe_finish(req)
        self._tok_total += len(live)
        metrics.counter("serving_tokens_total").inc(len(live))
        return True

    def _maybe_finish(self, req):
        done = req.n_new >= req.max_new_tokens or (
            req.eos_id is not None and req.tokens[-1] == req.eos_id
        )
        if not done:
            return
        req.t_done = time.monotonic()
        req.state = DONE
        self._slots[req.slot] = None
        self._tables[req.slot] = make_block_table(self.table_width)
        released = self.pool.release(req.rid)
        self._done[req.rid] = req
        ttft = req.t_first_token - req.t_submit
        tpot = (req.t_done - req.t_first_token) / max(req.n_new - 1, 1)
        e2e = req.t_done - req.t_submit
        metrics.histogram("tpot_s").observe(tpot)
        metrics.histogram("e2e_s").observe(e2e)
        with tracing.installed(req.trace):  # a no-op without a context
            telemetry.record_span("req_queue", req.t_submit, req.t_admit, rid=req.rid)
            telemetry.record_span("req_prefill", req.t_admit, req.t_first_token, rid=req.rid)
            telemetry.record_span("req_decode", req.t_first_token, req.t_done, rid=req.rid)
            telemetry.emit(
                "request_done", rid=req.rid, prompt_tokens=len(req.prompt),
                new_tokens=req.n_new, blocks_released=released, ttft_s=round(ttft, 6),
                tpot_s=round(tpot, 6), e2e_s=round(e2e, 6),
            )
