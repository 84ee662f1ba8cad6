"""The zero-stall save pipeline: the device-to-host snapshot in the shadow of
training (the JAX package's ``checkpoint/zerostall/snapshot.py``).

The vanilla engine's background save still copies every part to the host
on the calling thread (1.2 s at a 2.97 GB state on the H100, ``PERF.md``).
This engine takes the copy off the train loop:

  1. **The blocking window: copy-on-snapshot.** The optimizer updates the
     parameters and moments in place, so a transfer that read the live
     tensors would race the next step. Every device part is copied, on the
     current stream and so after the step that produced it, into one fresh
     device buffer laid out leaf after leaf. A side stream waits on an event
     recorded after those copies and copies the buffer, ``non_blocking``,
     into a pinned host buffer set, then records a completion event. The
     device buffer is ``record_stream``-ed on the side stream, so the caching
     allocator hands its memory out again only after the transfer. Nothing
     here waits for the device. The numpy leaves (counters, ``rng``) are
     copied on the host. On the CPU the copy is a plain clone and no stream
     is used. There is no synchronous ``.cpu()`` path on the card: a failed
     stream or pinned allocation raises.
  2. **Two pinned buffer sets, alternating.** The emergency tier
     (``emergency.py``) keeps the last committed snapshot's host bytes by
     hand-over, so one set is held by it while the next snapshot fills the
     other; with one set the next snapshot would overwrite the record in
     place. Both are allocated at the first save of a state (pinning a
     15 GB state takes seconds: that save's ``alloc_s``) and dropped by
     `release`, which ``train`` calls on every exit and which hands the
     caching host allocator's free pinned blocks back to the OS; the set the
     emergency record holds lives on with the record. That allocator rounds
     each set up to a power of two, and ``pinned_bytes`` counts it so.
  3. **The shadow write.** A thread waits on the completion event (never on
     a device-wide sync), cuts each leaf's bytes into the content-addressed
     store (``chunkstore.py``), commits the manifest, prunes and collects
     garbage, and publishes the snapshot to the emergency tier.
  4. **Depth-1 back-pressure.** A save that arrives while the previous one
     is still writing waits for it and says so: a ``ckpt_backpressure``
     event with the seconds waited, apart from the save's ``blocking_s``.
     The wait is also what makes the set not held by the emergency tier
     free.

Host 0 writes; the other ranks pass the entry barrier only (the state is
replicated). The fault seams: ``ckpt_snapshot`` (after the copies are
queued), ``ckpt_chunk_write`` (each chunk), ``ckpt_manifest_commit``
(durable but unpublished); a kill at any of them leaves the previous
manifest the newest restorable checkpoint.
"""

import contextlib
import threading
import time
from pathlib import Path

import numpy as np
import torch

from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.checkpoint.manifest import state_manifest
from pyrecover_tpu_torch.checkpoint.registry import prune_checkpoints
from pyrecover_tpu_torch.checkpoint.vanilla import (
    TOPOLOGY,
    _check_structure,
    _itemsize,
    _restore,
)
from pyrecover_tpu_torch.checkpoint.zerostall import chunkstore, emergency
from pyrecover_tpu_torch.parallel.mesh import sync_global_devices
from pyrecover_tpu_torch.resilience import faults
from pyrecover_tpu_torch.utils.logging import log_host0, process_index

# each leaf starts at a multiple of this in the snapshot's buffers, so every
# part's bytes view as its dtype
_ALIGN = 64


class ZerostallSaveHandle:
    """One save. ``blocking_s`` is what the caller waited after any
    back-pressure (``backpressure_s``), ``alloc_s`` the part of it spent
    pinning the buffer sets (the first save only), ``snapshot_s`` the copy
    window; once written, ``bytes`` (new chunk bytes), ``write_s`` =
    ``shadow_s`` (the writer's seconds) and ``reuse`` (the chunk counts);
    ``pinned_bytes`` is what the two buffer sets pin, as the allocator
    rounds them. ``wait()`` joins the writer and re-raises its error."""

    def __init__(self, path):
        self.path = Path(path)
        self.blocking_s = self.backpressure_s = self.alloc_s = self.snapshot_s = 0.0
        self.shadow_s = 0.0
        self.bytes = self.write_s = self.reuse = None
        self.pinned_bytes = 0
        self.error = None
        self._thread = None

    def wait(self, timeout=None):
        """Join the writer (bounded by ``timeout`` when given: a timeout
        raises ``TimeoutError`` with the thread still running) and re-raise
        any writer error."""
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(f"zerostall writer still running after {timeout:.0f}s")
            self._thread = None
        if self.error is not None:
            raise self.error

    @property
    def done(self):
        return self._thread is None or not self._thread.is_alive()

    @property
    def report(self):
        """The save's figures beyond the common handle's."""
        return {"backpressure_s": self.backpressure_s, "alloc_s": self.alloc_s,
                "snapshot_s": self.snapshot_s, "shadow_s": self.shadow_s,
                "pinned_bytes": self.pinned_bytes, "reuse": self.reuse}


def _pinned_size(nbytes):
    """What PyTorch's caching host allocator pins for a request of
    ``nbytes``: its blocks are rounded up to a power of two."""
    return 1 << max(int(nbytes) - 1, 0).bit_length()


def _empty_host_cache():
    """Return the caching host allocator's free pinned blocks to the OS: a
    dropped buffer set otherwise stays pinned, and cached, for the life of
    the process."""
    empty = (getattr(getattr(torch, "accelerator", None), "empty_host_cache", None)
             or getattr(torch._C, "_host_emptyCache", None))
    if empty is None:  # pragma: no cover - a PyTorch without the call
        log_host0("this PyTorch cannot empty its pinned host cache: released zerostall "
                  "buffer sets stay pinned until the process exits", level=30)
        return
    empty()


def _is_device_leaf(leaf):
    return all(isinstance(p, torch.Tensor) and p.device.type == "cuda" for p in leaf.parts)


class _Layout:
    """Where each leaf's bytes lie in a snapshot's buffers: the card's
    leaves first (the span the one device-to-host copy moves), then the
    host's."""

    def __init__(self, leaves):
        self.key = tuple((leaf.path, tuple(leaf.shape), leaf.dtype, _is_device_leaf(leaf))
                         for leaf in leaves)
        self.offsets = [None] * len(leaves)
        off = 0
        for want_device in (True, False):
            for i, leaf in enumerate(leaves):
                if _is_device_leaf(leaf) == want_device:
                    off = -(-off // _ALIGN) * _ALIGN
                    self.offsets[i] = off
                    off += leaf.nbytes
            if want_device:
                self.device_bytes = off
        self.nbytes = off
        self.device = next((leaf.parts[0].device for leaf in leaves if _is_device_leaf(leaf)),
                           None)


@contextlib.contextmanager
def _unfilled():
    """Allocate without the fill deterministic algorithms give new memory:
    every byte a snapshot reads is copied in first, and filling a 15 GB
    pinned set would add seconds to the first save."""
    det = torch.utils.deterministic
    old = det.fill_uninitialized_memory
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        det.fill_uninitialized_memory = old


class _Saver:
    """An experiment's snapshot machinery: its layout, its two buffer sets,
    its side stream and its save in flight."""

    def __init__(self):
        self.layout = None
        self.sets = []
        self.pinned_bytes = 0
        self.stream = None
        self.inflight = None

    def acquire(self, leaves, exp_dir):
        """The buffer set the next snapshot fills: the one the emergency
        record does not hold (both are allocated at the first save of this
        layout). Returns ``(set, seconds spent allocating)``."""
        layout = _Layout(leaves)
        alloc_s = 0.0
        if self.layout is None or self.layout.key != layout.key:
            t0 = time.monotonic()
            pinned = layout.device is not None
            self.sets = []  # the old sets go before the new are pinned
            with _unfilled():
                self.sets = [torch.empty(layout.nbytes, dtype=torch.uint8, pin_memory=pinned)
                             for _ in range(2)]
            self.layout = layout
            self.pinned_bytes = 2 * _pinned_size(layout.nbytes) if pinned else 0
            if pinned:
                self.stream = torch.cuda.Stream(device=layout.device)
            alloc_s = time.monotonic() - t0
        for buf in self.sets:
            if not emergency.holds(exp_dir, buf):
                return buf, alloc_s
        raise RuntimeError("both snapshot buffer sets are held")  # pragma: no cover

    def snapshot(self, leaves, buf):
        """Queue the copies of ``leaves`` into ``buf``; returns the event
        that completes the device-to-host copy (None on the CPU)."""
        layout = self.layout
        dev = None
        if layout.device_bytes:
            current = torch.cuda.current_stream(layout.device)
            dev = torch.empty(layout.device_bytes, dtype=torch.uint8, device=layout.device)
        for leaf, off in zip(leaves, layout.offsets):
            target = dev if _is_device_leaf(leaf) else buf
            for part in leaf.parts:
                n = int(np.prod(part.shape, dtype=np.int64)) * _itemsize(leaf.dtype)
                if isinstance(part, np.ndarray):
                    buf.numpy()[off:off + n] = np.ascontiguousarray(part).reshape(-1).view(
                        np.uint8)
                else:
                    target[off:off + n].view(part.dtype).view(part.shape).copy_(part.detach())
                off += n
        if dev is None:
            return None
        copied = torch.cuda.Event()
        copied.record(current)
        self.stream.wait_event(copied)
        with torch.cuda.stream(self.stream):
            buf[:layout.device_bytes].copy_(dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        # the caching allocator reuses dev's memory only after the transfer
        dev.record_stream(self.stream)
        return done

    def host_leaves(self, buf):
        """Each leaf's bytes in ``buf`` as a flat uint8 numpy view."""
        arr = buf.numpy()
        return [arr[off:off + int(np.prod(shape, dtype=np.int64)) * _itemsize(dtype)]
                for off, (_, shape, dtype, _) in zip(self.layout.offsets, self.layout.key)]


# the savers by experiment directory: each keeps at most one save in flight
_savers = {}
_savers_lock = threading.Lock()


def _key(exp_dir):
    return str(Path(exp_dir).absolute())


def _saver(exp_dir):
    with _savers_lock:
        return _savers.setdefault(_key(exp_dir), _Saver())


def backpressure(exp_dir, path):
    """Wait for the experiment's save in flight, if any, with a
    ``ckpt_backpressure`` event; re-raises its error. Returns the seconds
    waited."""
    prev = _saver(exp_dir).inflight
    if prev is None or prev.done:
        return 0.0
    t0 = time.monotonic()
    prev.wait()  # a failed background save fails the run here
    waited = time.monotonic() - t0
    telemetry.emit("ckpt_backpressure", engine="zerostall", path=str(path),
                   wait_s=round(waited, 4))
    log_host0("zerostall save of %s waited %.2fs for the previous in-flight save "
              "(ckpt_backpressure) — consider a lower save frequency", Path(path).name, waited,
              level=30)
    return waited


def release(exp_dir):
    """Drop the experiment's buffer sets and stream, and unpin what they
    held. A writer still running keeps its own set until it ends; the set
    the emergency record holds lives on with the record."""
    with _savers_lock:
        saver = _savers.pop(_key(exp_dir), None)
    if saver is not None and saver.pinned_bytes:
        del saver
        _empty_host_cache()


def save_ckpt_zerostall(path, leaves, sampler_state=None, *, max_keep=None, extra_meta=None,
                        background=True):
    """Save ``leaves`` (a list of `Leaf`) through the zero-stall pipeline.
    Returns a `ZerostallSaveHandle`; with ``background`` False it returns
    once the manifest is committed. Every chunk read re-verifies its
    digest, so the save takes no ``verify``."""
    path = Path(path)
    exp_dir = path.parent
    telemetry.emit("ckpt_save_start", engine="zerostall", path=str(path),
                   background=bool(background))
    faults.check("ckpt_save_begin", engine="zerostall", path=str(path))
    handle = ZerostallSaveHandle(path)
    handle.backpressure_s = backpressure(exp_dir, path)
    t0 = time.monotonic()
    blocking_span = telemetry.spans.begin("ckpt_blocking", engine="zerostall", path=str(path),
                                          metric="ckpt_zerostall_blocking_s")
    try:
        sync_global_devices("zerostall_save_enter")
        # every rank reaches this on every save: the exchange is collective
        emergency.replicate_to_peers(exp_dir)
        if process_index() == 0:
            saver = _saver(exp_dir)
            with telemetry.span("ckpt_snapshot", engine="zerostall", path=str(path),
                                metric="ckpt_zerostall_snapshot_s"):
                buf, handle.alloc_s = saver.acquire(leaves, exp_dir)
                done = saver.snapshot(leaves, buf)
                faults.check("ckpt_snapshot", engine="zerostall", path=str(path),
                             leaves=len(leaves))
            handle.snapshot_s = time.monotonic() - t0
            handle.pinned_bytes = saver.pinned_bytes
            doc = {
                "format": chunkstore.ZS_FORMAT_VERSION, "engine": "zerostall",
                "sampler": sampler_state or {}, "manifest": state_manifest(leaves),
                "topology": TOPOLOGY, "chunk_bytes": chunkstore.chunk_bytes_default(),
                **(extra_meta or {}),
            }
            handle._thread = threading.Thread(
                target=_write_snapshot, name="ckpt-zerostall-writer", daemon=True,
                args=(handle, buf, saver.host_leaves(buf), done, doc, max_keep))
            saver.inflight = handle
            handle._thread.start()
        if not background:
            handle.wait()
    finally:
        blocking_span.end()
    handle.blocking_s = time.monotonic() - t0
    telemetry.emit("ckpt_save_blocking", engine="zerostall", path=str(path),
                   blocking_s=round(handle.blocking_s, 4), background=bool(background))
    return handle


def _write_snapshot(handle, buf, host_leaves, done, doc, max_keep):
    """The shadow half, host 0's thread: wait for the transfer, write the
    chunks, commit the manifest, prune and collect, publish to the emergency
    tier. It launches nothing on the card and joins no collective."""
    path = handle.path
    t0 = time.monotonic()
    try:
        if done is not None:
            done.synchronize()  # this snapshot's transfer, not the device
        store = chunkstore.ChunkStore(path.parent)
        chunk_bytes = doc["chunk_bytes"]
        entries = []
        with telemetry.span("ckpt_chunk_write", engine="zerostall", path=str(path),
                            metric="ckpt_zerostall_chunk_write_s"):
            for entry, arr in zip(doc["manifest"]["leaves"], host_leaves):
                digests, reused = chunkstore.write_leaf(store, arr, chunk_bytes)
                entries.append({
                    "path": entry["path"], "dtype": entry["dtype"],
                    "shape": list(entry["shape"]), "nbytes": int(arr.nbytes),
                    "chunk_bytes": chunk_bytes, "chunks": digests, "reused": int(reused),
                })
        doc["leaves"] = entries
        doc["reuse"] = handle.reuse = store.reuse_stats()
        with telemetry.span("ckpt_manifest_commit", engine="zerostall", path=str(path),
                            metric="ckpt_zerostall_commit_s"):
            chunkstore.commit_manifest(path, doc)
        faults.check("ckpt_commit", engine="zerostall", path=str(path))
        handle.bytes = store.written_bytes
        telemetry.emit("ckpt_commit", engine="zerostall", path=str(path),
                       bytes=store.written_bytes, reused_bytes=store.reused_bytes,
                       chunks_written=store.written_chunks, chunks_reused=store.reused_chunks,
                       write_s=round(time.monotonic() - t0, 4))
        if max_keep:
            # manifest retention first, then refcounted chunk GC: a chunk
            # lives as long as some live manifest needs it
            prune_checkpoints(path.parent, max_keep, engine="zerostall")
            chunkstore.collect_garbage(path.parent)
        emergency.publish(path.parent, doc, host_leaves, buf)  # $PYRECOVER_EMERGENCY=0: no-op
    except BaseException as e:  # surfaced by wait()
        handle.error = e
    finally:
        # the writer's whole time, the transfer's wait and the publish
        # included: what the time-aware stop budgets for a final save
        handle.shadow_s = handle.write_s = time.monotonic() - t0
        telemetry.emit("ckpt_save_shadow", engine="zerostall", path=str(path),
                       shadow_s=round(handle.shadow_s, 4), ok=handle.error is None)


# ---- restore ---------------------------------------------------------------


def _meta_of(doc):
    """A manifest's leaves as the vanilla meta's ``paths`` and ``leaves``."""
    return {"paths": [e["path"] for e in doc["leaves"]],
            "leaves": [{"dtype": e["dtype"], "shape": e["shape"]} for e in doc["leaves"]]}


def precheck_ckpt_zerostall(path, *, verify=False, target=None):
    """Host-local integrity check of a manifest, with no full-leaf reads:
    the manifest parses and every chunk it names exists at the size its
    leaf's layout demands; with ``verify`` every chunk's digest is
    recomputed. Returns ``(ok, reason)``. With ``target`` (a list of `Leaf`)
    it raises `CheckpointStructureError` when the manifest does not fit it
    (a dtype difference is logged: the restore casts)."""
    path = Path(path)
    try:
        doc = chunkstore.read_manifest(path)
        store = chunkstore.ChunkStore(path.parent)
        jobs = []
        for entry in doc.get("leaves", []):
            sizes = chunkstore.expected_chunk_sizes(int(entry["nbytes"]),
                                                    int(entry["chunk_bytes"]))
            if len(sizes) != len(entry["chunks"]):
                return False, (f"{entry['path']}: {len(entry['chunks'])} chunks in manifest, "
                               f"layout expects {len(sizes)}")
            for digest, size in zip(entry["chunks"], sizes):
                cp = chunkstore.chunk_path(store.root, digest)
                if not cp.is_file():
                    return False, f"missing chunk {digest} ({entry['path']})"
                if cp.stat().st_size != size:
                    return False, (f"chunk {digest}: {cp.stat().st_size} bytes, expected "
                                   f"{size} ({entry['path']})")
                jobs.append((digest, size))
        if verify:  # every digest recomputed
            chunkstore._map(lambda job: store.get(job[0], expected_len=job[1]), jobs)
    except Exception as e:
        return False, f"{type(e).__name__}: {e}"
    if target is not None:
        _check_structure(_meta_of(doc), target, path)
    return True, ""


def load_ckpt_zerostall(path, target):
    """Restore the manifest at ``path`` into ``target`` (a list of `Leaf`),
    a leaf at a time, every chunk's digest verified on the read. Returns the
    manifest."""
    path = Path(path)
    t0 = time.monotonic()
    telemetry.emit("ckpt_restore_start", engine="zerostall", path=str(path))
    sync_global_devices("zerostall_load_enter")
    doc = chunkstore.read_manifest(path)
    _check_structure(_meta_of(doc), target, path)
    store = chunkstore.ChunkStore(path.parent)
    with telemetry.span("ckpt_read", engine="zerostall", path=str(path),
                        metric="ckpt_zerostall_read_s"):
        for entry, leaf in zip(doc["leaves"], target):
            _restore(leaf, torch.from_numpy(chunkstore.assemble_leaf(store, entry)),
                     entry["dtype"])
    sync_global_devices("zerostall_load_exit")
    telemetry.emit("ckpt_restore_done", engine="zerostall", path=str(path),
                   seconds=round(time.monotonic() - t0, 4), step=int(doc.get("step", 0)))
    return doc
