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
long into `LoaderStallError`. One process feeds one device: the JAX
loader's mesh and per-host slicing wait for data parallelism, and its
``loader_wait`` span and ``data_stall`` event for the telemetry core.
"""

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from pyrecover_tpu_torch.data.collate import collate_clm

_INT64_KEYS = ("inputs", "labels")


class LoaderStallError(RuntimeError):
    """The prefetch pipeline produced nothing for ``stall_timeout`` seconds:
    a wedged data source (hung filesystem, dead tokenizer worker). Raised
    instead of blocking the step loop forever so the trainer fails fast
    inside its preemption grace window."""


class DataLoader:
    """``next(loader)`` -> ``(epoch, batch)``: ``batch`` maps ``inputs``,
    ``labels`` (and ``segments`` for packed rows) to tensors on ``device``.
    ``prefetch`` 0 collates on the caller's thread."""

    def __init__(self, dataset, sampler, pad_token_id, device="cpu", prefetch=2,
                 num_workers=4, stall_timeout=0.0):
        self.dataset = dataset
        self.sampler = sampler
        self.pad_token_id = pad_token_id
        self.device = torch.device(device)
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

    def _make_batch(self, indices):
        """Read and collate one batch into host tensors (pinned for a card)."""
        batch = collate_clm([self.dataset[i] for i in indices], self.pad_token_id)
        out = {}
        for key, value in batch.items():
            t = torch.from_numpy(value)
            if key in _INT64_KEYS:
                t = t.long()
            out[key] = t.pin_memory() if self._pin else t
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
            except queue.Empty:
                # the queue ran dry: the step now waits on the host
                t0 = time.monotonic()
                try:
                    item = self._queue.get(timeout=self.stall_timeout or None)
                except queue.Empty:
                    waited = time.monotonic() - t0
                    self.stall_count += 1
                    self.stall_s += waited
                    raise LoaderStallError(
                        f"data loader produced no batch for {waited:.1f} s "
                        f"(--loader-stall-timeout {self.stall_timeout:g} s) "
                        f"at batch {self.batches_served + 1}"
                    ) from None
                self.stall_count += 1
                self.stall_s += time.monotonic() - t0
            if isinstance(item, Exception):
                raise item
            epoch, batch = item
        self.batches_served += 1
        return epoch, self._to_device(batch)

    def __iter__(self):
        while True:
            yield next(self)
