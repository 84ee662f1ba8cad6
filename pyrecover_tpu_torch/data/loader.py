"""Data loader with background prefetch, ported from the JAX package's
``data/loader.py``.

A producer thread draws index batches from the deterministic
``StatefulSampler`` and hands them to a small thread pool that reads the
items and collates them a few batches ahead into a bounded queue, so
per-item Python work (tokenizing, packing, collating) stays out of the
step. Each batch becomes host tensors (token ids as int64, segment ids as
int32); on a CUDA device they are pinned, one fresh pinned buffer per batch,
and the consumer copies them to the card with ``non_blocking`` copies on
the current stream, so the copy overlaps the previous step's kernels. A
pinned buffer is never refilled: PyTorch's pinned-memory allocator keeps
it until the copy that reads it has finished.

The sampler runs ahead of the step by the queue's depth plus the pool's
width, so a checkpoint records the number of batches the step CONSUMED and
a resume seeks the sampler there (``StatefulSampler.seek``), never the live
cursor. ``stall_timeout`` > 0 turns a producer that yields nothing for that
long into `LoaderStallError` (and a ``loader_stall_timeout`` event). A
consumer wait on an empty queue is an open ``loader_wait`` span, a
``data_stall`` event and a ``loader_wait_s`` sample (an exact zero on a
hit); each collated batch is a ``loader`` heartbeat for the run-health
watchdog, and the ``loader_batch`` fault seam sits where a hung data source
would. Each process feeds its own card: under data parallelism every rank
draws the same global index batch from the same sampler and collates only
its rows of it, ``[r * gbs / n, (r + 1) * gbs / n)`` for rank r of n (the
JAX loader's per-host slice, ``pyrecover_tpu/data/loader.py:71-89``); a
global batch that the ranks cannot split evenly raises. The sampler, and so
``state_dict_at``, keeps counting global batches.
"""

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.data.collate import collate_clm
from pyrecover_tpu_torch.resilience import faults
from pyrecover_tpu_torch.utils.device import resolve_device

_INT64_KEYS = ("inputs", "labels")
# a consumer wait above this is a real stall (the prefetch queue ran dry),
# not scheduler noise: emitted as a `data_stall` event
_STALL_EVENT_THRESHOLD_S = 1e-3


class LoaderStallError(RuntimeError):
    """The prefetch pipeline produced nothing for ``stall_timeout`` seconds:
    a wedged data source (hung filesystem, dead tokenizer worker). Raised
    instead of blocking the step loop forever so the trainer fails fast
    inside its preemption grace window."""


class DataLoader:
    """``next(loader)`` -> ``(epoch, batch)``: ``batch`` maps ``inputs``,
    ``labels`` (and ``segments`` for packed rows) to tensors on ``device``.
    ``prefetch`` 0 collates on the caller's thread. ``device`` is the card
    unless the caller asks for ``cpu`` (``utils/device.py::resolve_device``:
    with no card, the default raises)."""

    def __init__(self, dataset, sampler, pad_token_id, device="cuda", prefetch=2,
                 num_workers=4, stall_timeout=0.0, rank=None, world_size=None):
        self.dataset = dataset
        self.sampler = sampler
        self.pad_token_id = pad_token_id
        self.device = resolve_device(device)
        self.prefetch = max(int(prefetch), 0)
        self.num_workers = max(int(num_workers), 1)
        # 0 disables: blocking waits are legitimate on a cold start
        self.stall_timeout = max(float(stall_timeout), 0.0)
        self._pin = self.device.type == "cuda"
        self._queue = None
        self._thread = None
        self._stop = threading.Event()
        self.batches_served = 0
        self.stall_count = 0  # times the consumer found the queue empty
        self.stall_s = 0.0  # seconds it waited then
        self._wait_hist = None  # the loader_wait_s histogram, bound lazily
        # this process's slot among the data-parallel ranks (the live process
        # group's unless given)
        if world_size is None:
            from pyrecover_tpu_torch.parallel import mesh

            world_size = mesh.world_size()
            rank = mesh.rank() if rank is None else rank
        self.rank, self.world_size = int(rank or 0), int(world_size)
        if sampler.global_batch_size % self.world_size:
            raise ValueError(f"global batch {sampler.global_batch_size} not divisible by "
                             f"{self.world_size} data-parallel ranks")

    def _observe_wait(self, waited):
        if self._wait_hist is None:
            self._wait_hist = telemetry.metrics.histogram("loader_wait_s")
        self._wait_hist.observe(waited)

    def _local_indices(self, global_indices):
        """This rank's rows of a global index batch."""
        if self.world_size == 1:
            return global_indices
        per = len(global_indices) // self.world_size
        return global_indices[self.rank * per:(self.rank + 1) * per]

    def _make_batch(self, indices):
        """Read and collate this rank's rows of one global batch into host
        tensors (pinned for a card)."""
        # fault seam: `loader_stall` wedges exactly here, host-side batch
        # materialization, which is what a hung data source looks like
        faults.check("loader_batch", batch=self.batches_served + 1)
        batch = collate_clm([self.dataset[i] for i in self._local_indices(indices)],
                            self.pad_token_id)
        out = {}
        for key, value in batch.items():
            t = torch.from_numpy(value)
            if key in _INT64_KEYS:
                t = t.long()
            out[key] = t.pin_memory() if self._pin else t
        # a completed batch is loader progress for the run-health watchdog
        telemetry.watchdog.beat("loader")
        return out

    def _to_device(self, batch):
        return {k: t.to(self.device, non_blocking=self._pin) for k, t in batch.items()}

    # -- background prefetch -------------------------------------------------
    def _producer(self):
        with ThreadPoolExecutor(max_workers=self.num_workers,
                                thread_name_prefix="loader-worker") as pool:
            pending = []
            while not self._stop.is_set():
                while len(pending) < self.num_workers:
                    idx = self.sampler.next_batch()
                    pending.append((self.sampler.epoch, pool.submit(self._make_batch, idx)))
                epoch, fut = pending.pop(0)
                try:
                    batch = fut.result()
                except Exception as e:  # surfaced by the consumer
                    self._queue.put(e)
                    return
                while not self._stop.is_set():
                    try:
                        self._queue.put((epoch, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue

    def start(self):
        """Start the producer (idempotent; without prefetch, nothing)."""
        if self.prefetch > 0 and self._thread is None:
            self._queue = queue.Queue(maxsize=self.prefetch)
            self._stop.clear()
            self._thread = threading.Thread(target=self._producer, name="loader-prefetch",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self):
        """Stop the producer and join it (bounded)."""
        self._stop.set()
        if self._thread is not None:
            # drain so the producer can observe the stop flag
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)
            self._thread = None

    def __next__(self):
        if self.prefetch == 0:
            idx = self.sampler.next_batch()
            epoch, batch = self.sampler.epoch, self._make_batch(idx)
        else:
            if self._thread is None:
                self.start()
            try:
                item = self._queue.get_nowait()
                if telemetry.enabled():
                    # a hit: the histogram records an exact zero, so p50 = 0
                    # with a stall tail reads at a glance
                    self._observe_wait(0.0)
            except queue.Empty:
                # the queue ran dry: the step now waits on the host. A real
                # (begin/end) span: while the wait lasts, the open
                # `loader_wait` span is what a hang bundle names
                t0 = time.monotonic()
                wait_span = telemetry.spans.begin(
                    "loader_wait", batch=self.batches_served + 1, metric="loader_wait_s",
                )
                try:
                    item = self._queue.get(timeout=self.stall_timeout or None)
                except queue.Empty:
                    waited = time.monotonic() - t0
                    self.stall_count += 1
                    self.stall_s += waited
                    wait_span.end(ok=False, error="LoaderStallError")
                    telemetry.emit(
                        "loader_stall_timeout", wait_s=round(waited, 3),
                        timeout_s=self.stall_timeout, batch=self.batches_served + 1,
                    )
                    raise LoaderStallError(
                        f"data loader produced no batch for {waited:.1f} s "
                        f"(--loader-stall-timeout {self.stall_timeout:g} s) "
                        f"at batch {self.batches_served + 1}"
                    ) from None
                waited = time.monotonic() - t0
                self.stall_count += 1
                self.stall_s += waited
                wait_span.end()
                if waited >= _STALL_EVENT_THRESHOLD_S:
                    telemetry.emit(
                        "data_stall", wait_s=round(waited, 6), depth=self._queue.qsize(),
                        batch=self.batches_served + 1,
                    )
            if isinstance(item, Exception):
                raise item
            epoch, batch = item
        self.batches_served += 1
        return epoch, self._to_device(batch)

    def __iter__(self):
        while True:
            yield next(self)
