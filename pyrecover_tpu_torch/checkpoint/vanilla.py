"""Vanilla checkpoints: one ``PYRCKPT2`` file holding the whole training
state, in the JAX package's format (``checkpoint/vanilla.py``), so that
each package reads the other's files.

The container (format 2): MAGIC, a u64 little-endian meta length, the meta
JSON, then for each leaf a u64 byte length and the leaf's raw little-endian
C-order bytes. The meta names the leaves' key paths (``paths``) and their
dtypes and shapes (``leaves``), and carries the sampler state, ``step``,
``epoch`` and ``topology``. The JAX package's legacy v1 (msgpack) files are
not read.

The state is a list of `Leaf`: a key path, a shape, a dtype name, and the
tensors (or numpy arrays) whose bytes, one after another, are the leaf's.
A leaf of layers stacked on axis 0 is its layers' tensors in order, so it
is written and restored a layer at a time and the stack never exists in
memory.

* Saving streams leaf by leaf into a temporary file, folds the sidecar
  checksum into the same pass (``xxh64tree:16777216:<hex>`` through the
  native engine, ``checkpoint/native_io.py``, when it builds; ``sha256::``
  otherwise, as the JAX package degrades), fsyncs, publishes with
  ``os.replace`` and then prunes to ``max_keep``. A synchronous save holds
  one part in host RAM at a time. A background save takes the device-to-host
  snapshot of every part on the calling thread (on the CPU a copy of each
  tensor, since the next optimizer step updates them in place) and writes
  in a thread, freeing each part as it is written.
* Loading streams too: one leaf in host RAM at a time, read with the
  native engine's parallel ``pread`` when it loads (a buffered read
  otherwise) and copied into its parts; the checksum is verified in a
  thread that is joined on every exit path. Either package's sidecars
  verify in the other: ``xxh64tree:`` through the native ``hash_file``
  (the pure-Python ``utils/xxh.py`` without the library), ``sha256::``
  through hashlib.
* ``precheck_ckpt_vanilla`` checks the sidecar and walks the frames with
  seeks, and with a target raises `CheckpointStructureError` when the file
  does not fit the model.

Telemetry and fault seams sit at the JAX package's points: the
``ckpt_save_start``/``ckpt_save_blocking``/``ckpt_save_shadow``/``ckpt_commit``
and ``ckpt_restore_start``/``ckpt_restore_done`` events, a span per phase
(``ckpt_gather``, ``ckpt_write``, ``ckpt_fsync``, ``ckpt_rename``,
``ckpt_sidecar``; ``ckpt_read``, ``ckpt_verify_wait``), a ``ckpt_writer``
heartbeat per snapshotted part and written chunk, and the
``ckpt_save_begin``/``ckpt_write``/``ckpt_fsync``/``ckpt_rename``/
``ckpt_commit``/``ckpt_read`` seams of ``resilience/faults.py``.
"""

import dataclasses
import hashlib
import json
import logging
import os
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.checkpoint import native_io
from pyrecover_tpu_torch.checkpoint.registry import prune_checkpoints
from pyrecover_tpu_torch.resilience import faults
from pyrecover_tpu_torch.resilience.retry import io_retry

log = logging.getLogger("pyrecover_tpu_torch")

FORMAT_VERSION = 2
MAGIC = b"PYRCKPT2"
# one process on one device: the JAX package's elastic-resume gate reads this
TOPOLOGY = {"devices": 1, "processes": 1, "mesh": None}
_HASH_CHUNK = 16 * 1024 * 1024

# dtype names as numpy spells them (the meta's ``dtype``); uint32 and other
# types torch lacks or only partly supports go through numpy
_TORCH_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16,
    "float64": torch.float64, "int64": torch.int64, "int32": torch.int32,
    "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


class CheckpointStructureError(ValueError):
    """The checkpoint decoded fine but does not fit the target state (leaf
    paths, count or shapes differ): a configuration error, not corruption.
    The latest-resume fallback must not skip past it, since every candidate
    would fail the same way."""


def dtype_name(x):
    """The meta's dtype name of a tensor or numpy array."""
    if isinstance(x, np.ndarray):
        return str(x.dtype)
    return _DTYPE_NAMES[x.dtype]


def _itemsize(name):
    return 2 if name == "bfloat16" else np.dtype(name).itemsize


def _numel(part):
    return part.size if isinstance(part, np.ndarray) else part.numel()


@dataclasses.dataclass
class Leaf:
    """One leaf of the saved state: its key path, shape and dtype name, and
    the tensors or numpy arrays whose C-order bytes, in order, make it up.
    Saving reads the parts; restoring writes into them."""

    path: str
    shape: tuple
    dtype: str
    parts: list

    @property
    def nbytes(self):
        return int(np.prod(self.shape, dtype=np.int64)) * _itemsize(self.dtype)


def _part_bytes(part):
    """A part's C-order bytes as a flat uint8 numpy array on the host: a
    view of a host part, a device-to-host copy of a device one."""
    if isinstance(part, np.ndarray):
        return np.ascontiguousarray(part).reshape(-1).view(np.uint8)
    t = part.detach().cpu().contiguous().reshape(-1)
    return t.view(torch.uint8).numpy()


def _snapshot(part):
    """A host copy of a part that later in-place updates cannot reach."""
    # a part copied is checkpoint-writer progress for the run-health watchdog
    telemetry.watchdog.beat("ckpt_writer")
    if isinstance(part, np.ndarray):
        return part.copy()
    return part.detach().to("cpu", copy=True)


def _typed(raw, name, shape):
    """The leaf bytes in ``raw`` (a uint8 CPU tensor) as a tensor of dtype
    ``name`` and ``shape``, sharing its memory."""
    if name in _TORCH_DTYPES:
        return raw.view(_TORCH_DTYPES[name]).reshape(shape)
    return torch.from_numpy(raw.numpy().view(np.dtype(name)).reshape(shape))


def _restore(leaf, raw, name):
    """Copy a leaf's bytes, saved as dtype ``name``, into its parts (casting
    when the part's dtype differs, and moving to the part's device)."""
    off, itemsize = 0, _itemsize(name)
    for part in leaf.parts:
        n = _numel(part) * itemsize
        chunk = _typed(raw[off:off + n], name, tuple(part.shape))
        off += n
        if isinstance(part, np.ndarray):
            part[...] = chunk.numpy()
        else:
            with torch.no_grad():
                part.copy_(chunk)


# ---- checksums -------------------------------------------------------------


def _sidecar(path):
    p = Path(path)
    return p.with_suffix(p.suffix + ".sha256")


def _sha256_file(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(_HASH_CHUNK):
            h.update(chunk)
    return h.hexdigest()


def verify_checksum(path, expected):
    """Check ``path`` against a sidecar string: ``xxh64tree:<chunk>:<hex>``
    (the native engine's, either package's) or ``sha256::<hex>`` (the
    fallback of both)."""
    algo, param, digest = expected.strip().split(":", 2)
    if algo == "sha256":
        return _sha256_file(path) == digest
    if algo == "xxh64tree":
        chunk = int(param)
        if native_io.available():
            return f"{native_io.hash_file(path, chunk=chunk):016x}" == digest
        from pyrecover_tpu_torch.utils import xxh

        return f"{xxh.tree_hash_file(path, chunk):016x}" == digest
    raise ValueError(f"Unknown checksum algorithm {algo!r}")


class _IncrementalChecksum:
    """The sidecar checksum folded into the streaming write pass (the JAX
    package's): with the native engine, xxh64 digests of each
    ``_HASH_CHUNK`` of the byte stream combined at the end, equal to
    ``native_io.hash_file`` of the written file; else streaming sha256.
    Whole chunks are hashed straight from the caller's buffer; only a
    chunk that straddles two writes is copied."""

    def __init__(self, chunk=_HASH_CHUNK):
        self.chunk = chunk
        self.native = native_io.available()
        if self.native:
            self._buf = bytearray()
            self._digests = []
        else:
            self._h = hashlib.sha256()

    def update(self, data):
        if not self.native:
            self._h.update(data)
            return
        data = memoryview(data).cast("B")
        if self._buf:
            take = min(self.chunk - len(self._buf), len(data))
            self._buf += data[:take]
            data = data[take:]
            if len(self._buf) == self.chunk:
                self._digest(self._buf)
                self._buf = bytearray()
        while len(data) >= self.chunk:
            self._digest(data[:self.chunk])
            data = data[self.chunk:]
        if len(data):
            self._buf += data

    def _digest(self, piece):
        self._digests.append(native_io.xxh64(piece).to_bytes(8, "little"))

    def result(self):
        if not self.native:
            return f"sha256::{self._h.hexdigest()}"
        if self._buf or not self._digests:
            self._digest(self._buf)
            self._buf = bytearray()
        digest = native_io.xxh64(b"".join(self._digests))
        return f"xxh64tree:{self.chunk}:{digest:016x}"


# ---- saving ----------------------------------------------------------------


class VanillaSaveHandle:
    """One save: ``blocking_s`` (what the caller waited), and once written
    ``bytes`` and ``write_s``. For a background save ``wait()`` joins the
    writer and re-raises its error; for a synchronous one it returns at
    once."""

    def __init__(self, path):
        self.path = Path(path)
        self.blocking_s = 0.0
        self.bytes = None
        self.write_s = None
        self.shadow_s = 0.0  # a background writer's seconds, overlapped with training
        self.error = None
        self._thread = None

    def wait(self, timeout=None):
        """Join the writer, bounded by ``timeout`` when given (a timeout
        raises ``TimeoutError`` with the thread still running), and
        re-raise any writer error."""
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"background checkpoint writer still running after {timeout:.0f}s"
                )
            self._thread = None
        if self.error is not None:
            raise self.error

    @property
    def done(self):
        return self._thread is None or not self._thread.is_alive()


def _checkpoint_meta(leaves, sampler_state, extra_meta):
    meta = {
        "format": FORMAT_VERSION,
        "num_leaves": len(leaves),
        "treedef": "TrainState",
        "paths": [leaf.path for leaf in leaves],
        "sampler": sampler_state or {},
        "leaves": [{"dtype": leaf.dtype, "shape": list(leaf.shape)} for leaf in leaves],
        "topology": TOPOLOGY,
    }
    meta.update(extra_meta or {})
    return meta


def save_ckpt_vanilla(path, leaves, sampler_state=None, *, verify=False,
                      max_keep=None, extra_meta=None, background=False):
    """Write ``leaves`` (a list of `Leaf`) to ``path``. Returns a
    `VanillaSaveHandle`. With ``background`` the snapshot is taken here and
    the write, sidecar and pruning run in a thread; otherwise all of it runs
    here, one part in host RAM at a time."""
    t0 = time.monotonic()
    path = Path(path)
    telemetry.emit("ckpt_save_start", engine="vanilla", path=str(path),
                   background=bool(background))
    faults.check("ckpt_save_begin", engine="vanilla", path=str(path))
    meta = _checkpoint_meta(leaves, sampler_state, extra_meta)
    handle = VanillaSaveHandle(path)
    if not background:
        handle.bytes, handle.write_s = _write_stream(
            handle.path, leaves, lambda i: map(_part_bytes, leaves[i].parts),
            meta, verify, max_keep,
        )
        handle.blocking_s = time.monotonic() - t0
        telemetry.emit("ckpt_save_blocking", engine="vanilla", path=str(path),
                       blocking_s=round(handle.blocking_s, 4), background=False)
        return handle

    with telemetry.span("ckpt_gather", engine="vanilla", metric="ckpt_vanilla_gather_s"):
        snap = [[_snapshot(p) for p in leaf.parts] for leaf in leaves]

    def drain(i):
        parts, snap[i] = snap[i], None
        for j in range(len(parts)):
            part, parts[j] = parts[j], None  # free each part once written
            yield _part_bytes(part)

    def run():
        t_bg = time.monotonic()
        try:
            handle.bytes, handle.write_s = _write_stream(
                handle.path, leaves, drain, meta, verify, max_keep)
        except BaseException as e:  # surfaced by wait()
            handle.error = e
        finally:
            handle.shadow_s = time.monotonic() - t_bg
            telemetry.emit("ckpt_save_shadow", engine="vanilla", path=str(path),
                           shadow_s=round(handle.shadow_s, 4), ok=handle.error is None)

    handle._thread = threading.Thread(target=run, name="ckpt-writer", daemon=True)
    handle._thread.start()
    handle.blocking_s = time.monotonic() - t0
    telemetry.emit("ckpt_save_blocking", engine="vanilla", path=str(path),
                   blocking_s=round(handle.blocking_s, 4), background=True)
    return handle


def _write_stream(path, leaves, parts_of, meta, verify, max_keep):
    """Stream the container to a temporary file beside ``path``, then fsync,
    publish and prune. ``parts_of(i)`` yields leaf i's bytes as uint8 numpy
    arrays. Returns ``(bytes written, seconds)``."""
    t0 = time.monotonic()
    path_s = str(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    meta_b = json.dumps(meta).encode()
    checksum = _IncrementalChecksum() if verify else None
    written = 0
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb", buffering=4 * 1024 * 1024) as f:

            def write_once(b):
                # the seam raises BEFORE the real write, so a retried chunk
                # is never half-applied by the fault itself
                faults.check("ckpt_write", path=path_s, written=written)
                f.write(b)

            def w(b):
                nonlocal written
                io_retry(lambda: write_once(b), op="write", path=path_s)
                written += len(b)
                # a landed chunk is checkpoint-writer progress: a save that
                # is writing is slow, not hung
                telemetry.watchdog.beat("ckpt_writer")
                if checksum is not None:
                    checksum.update(b)

            def fsync_once():
                faults.check("ckpt_fsync", path=path_s)
                os.fsync(f.fileno())

            with telemetry.span("ckpt_write", engine="vanilla", path=path_s,
                                metric="ckpt_vanilla_write_s"):
                w(MAGIC)
                w(len(meta_b).to_bytes(8, "little"))
                w(meta_b)
                for i, leaf in enumerate(leaves):
                    w(leaf.nbytes.to_bytes(8, "little"))
                    start = written
                    for data in parts_of(i):
                        data = memoryview(data)
                        for off in range(0, len(data), _HASH_CHUNK):
                            w(data[off:off + _HASH_CHUNK])
                        del data
                    if written - start != leaf.nbytes:
                        raise ValueError(f"leaf {leaf.path}: {written - start} bytes written, "
                                         f"{leaf.nbytes} expected from its dtype and shape")
            # durable before the publish: `latest` never names unsynced pages
            with telemetry.span("ckpt_fsync", engine="vanilla", metric="ckpt_vanilla_fsync_s"):
                f.flush()
                io_retry(fsync_once, op="fsync", path=path_s)
        if not verify:  # a sidecar left by an earlier file of this name would not match
            _sidecar(path).unlink(missing_ok=True)

        def rename_once():
            faults.check("ckpt_rename", path=path_s)
            os.replace(tmp, path)  # the atomic publish

        with telemetry.span("ckpt_rename", engine="vanilla", metric="ckpt_vanilla_commit_s"):
            io_retry(rename_once, op="rename", path=path_s)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    if verify:
        sidecar = checksum.result()
        with telemetry.span("ckpt_sidecar", engine="vanilla", metric="ckpt_vanilla_sidecar_s"):
            io_retry(lambda: _sidecar(path).write_text(sidecar), op="sidecar", path=path_s)
    faults.check("ckpt_commit", engine="vanilla", path=path_s)
    write_s = time.monotonic() - t0
    telemetry.emit("ckpt_commit", engine="vanilla", path=path_s, bytes=written,
                   write_s=round(write_s, 4), checksum=bool(verify))
    if max_keep:
        prune_checkpoints(path.parent, max_keep, engine="vanilla")
    return written, write_s


# ---- reading ---------------------------------------------------------------


def _read_header(f):
    """``(meta, offset of the first frame)`` from an open container."""
    if f.read(len(MAGIC)) != MAGIC:
        raise ValueError("not a PYRCKPT2 container (bad magic)")
    mlen = int.from_bytes(f.read(8), "little")
    meta = json.loads(f.read(mlen).decode())
    if meta.get("format") != FORMAT_VERSION:
        raise ValueError(f"Unsupported checkpoint format {meta.get('format')}")
    return meta, len(MAGIC) + 8 + mlen


def read_ckpt_meta(path):
    """The meta JSON alone: a header read, no tensor data."""
    with open(path, "rb") as f:
        return _read_header(f)[0]


def _leaf_nbytes(lm):
    return int(np.prod(lm["shape"], dtype=np.int64)) * _itemsize(lm["dtype"])


def _check_leaf_frame(i, lm, n, end, size):
    """A leaf frame's length prefix must match its meta entry and the frame
    must end inside the file; a corrupt prefix would otherwise shift every
    later leaf into garbage."""
    expect = _leaf_nbytes(lm)
    if n != expect:
        raise ValueError(
            f"leaf {i}: length prefix {n} != {expect} expected from meta "
            f"(dtype {lm['dtype']}, shape {lm['shape']}) — corrupt frame"
        )
    if end > size:
        raise ValueError(
            f"leaf {i}: frame extends past end of file ({end} > {size}) — truncated checkpoint"
        )


def _frame_spans(f, meta, off, size):
    """Yield ``(i, leaf meta, data offset, byte count)`` for every leaf frame
    of an open container whose first frame is at ``off``, checking each
    length prefix; reads the prefixes only."""
    for i, lm in enumerate(meta["leaves"]):
        f.seek(off)
        prefix = f.read(8)
        if len(prefix) < 8:
            raise ValueError(f"leaf {i}: truncated length prefix")
        n = int.from_bytes(prefix, "little")
        _check_leaf_frame(i, lm, n, off + 8 + n, size)
        yield i, lm, off + 8, n
        off += 8 + n


def _walk_ckpt_frames(path):
    """Read the header and every length prefix, seeking past the data: O(meta)
    bytes. Raises on any structural fault; returns the meta."""
    with open(path, "rb") as f:
        meta, off = _read_header(f)
        for _ in _frame_spans(f, meta, off, os.fstat(f.fileno()).st_size):
            pass
    return meta


def _read_into(f, buf, offset, path_s):
    """Fill ``buf`` with the file's bytes at ``offset``: parallel ``pread``
    through the native engine when it loads, else a seek and ``readinto``
    on the open file ``f``."""
    def once():
        faults.check("ckpt_read", path=path_s)
        if native_io.available():
            native_io.pread_into(path_s, offset, buf)
            return
        f.seek(offset)
        got = f.readinto(buf)
        if got != len(buf):
            raise ValueError(f"short read at offset {offset}: {got} of {len(buf)} bytes")

    io_retry(once, op="read", path=path_s)


def _check_structure(meta, target, ckpt, warn_cast=True):
    """Raise `CheckpointStructureError` when the saved leaves' paths, count or
    shapes differ from ``target``'s; a dtype difference is logged and
    emitted (the restore casts) when ``warn_cast``."""
    name = Path(ckpt).name
    paths = meta.get("paths") or [leaf.path for leaf in target]
    if len(meta["leaves"]) != len(target):
        raise CheckpointStructureError(
            f"checkpoint {name} does not fit the configured model: it has "
            f"{len(meta['leaves'])} leaves, the model {len(target)}"
        )
    drift = []
    for path, lm, leaf in zip(paths, meta["leaves"], target):
        if path != leaf.path:
            drift.append(f"leaf {path} where the model has {leaf.path}")
        elif list(lm["shape"]) != list(leaf.shape):
            drift.append(f"{path}: shape {list(lm['shape'])} != {list(leaf.shape)}")
        elif warn_cast and lm["dtype"] != leaf.dtype:
            # the JAX pre-check's SC09 warning
            detail = (f"{path}: dtype {lm['dtype']} in checkpoint vs {leaf.dtype} in model "
                      "— restore would silently cast")
            log.warning("resume manifest: %s (restore will cast)", detail)
            telemetry.emit("ckpt_manifest_dtype_drift", path=str(ckpt), detail=detail)
    if drift:
        raise CheckpointStructureError(
            f"checkpoint {name} does not fit the configured model: " + "; ".join(drift[:3])
        )


def _restore_frames(f, meta, off, path, slots):
    """Restore each frame whose leaf index is in ``slots`` into its `Leaf`,
    one leaf in host RAM at a time; the other frames are skipped with a
    seek, their data never read."""
    for i, lm, start, n in _frame_spans(f, meta, off, os.fstat(f.fileno()).st_size):
        if i not in slots:
            continue
        raw = torch.empty(n, dtype=torch.uint8)
        if n:
            _read_into(f, raw.numpy(), start, str(path))
        _restore(slots[i], raw, lm["dtype"])
        del raw


def precheck_ckpt_vanilla(path, *, verify=False, target=None):
    """Integrity check before a load: the sidecar checksum, if there is one
    (a missing one fails when ``verify``), and the frame walk. Returns
    ``(ok, reason)``. With ``target`` (a list of `Leaf`) it also raises
    `CheckpointStructureError` when the file does not fit it."""
    path = Path(path)
    try:
        sidecar = _sidecar(path)
        if sidecar.exists():
            if not verify_checksum(path, sidecar.read_text().strip()):
                return False, "checksum mismatch"
        elif verify:
            return False, f"checksum sidecar missing: {sidecar}"
        meta = _walk_ckpt_frames(path)
    except Exception as e:
        return False, f"{type(e).__name__}: {e}"
    if target is not None:
        _check_structure(meta, target, path)
    return True, ""


def load_ckpt_vanilla(path, target, *, verify=False):
    """Restore the checkpoint at ``path`` into ``target`` (a list of `Leaf`),
    one leaf at a time. With ``verify`` the sidecar checksum is checked in a
    thread alongside the read. Returns the meta."""
    path = Path(path)
    t0 = time.monotonic()
    telemetry.emit("ckpt_restore_start", engine="vanilla", path=str(path))
    verify_error = []
    verify_thread = None
    if verify:
        sidecar = _sidecar(path)

        def _verify():
            if not sidecar.exists():
                verify_error.append(f"checksum sidecar missing: {sidecar}")
                return
            expected = sidecar.read_text().strip()
            try:
                ok = verify_checksum(path, expected)
            except Exception as e:
                verify_error.append(f"checksum verification failed for {path}: {e}")
                return
            if not ok:
                verify_error.append(f"checksum mismatch for {path}: expected {expected}")

        verify_thread = threading.Thread(target=_verify, name="ckpt-verify", daemon=True)
        verify_thread.start()

    # the verify thread is joined on every exit path: a failed load must not
    # leave a reader behind for each candidate the fallback rejects
    try:
        with open(path, "rb") as f:
            meta, off = _read_header(f)
            _check_structure(meta, target, path)
            # reads and copies interleave a leaf at a time: one span
            with telemetry.span("ckpt_read", engine="vanilla", path=str(path),
                                metric="ckpt_vanilla_read_s"):
                _restore_frames(f, meta, off, path, dict(enumerate(target)))
    except BaseException:
        if verify_thread is not None:
            verify_thread.join(timeout=600)
        raise
    if verify_thread is not None:
        with telemetry.span("ckpt_verify_wait", engine="vanilla",
                            metric="ckpt_vanilla_verify_s"):
            verify_thread.join()
        if verify_error:
            raise ValueError(verify_error[0])
        log.info("Checkpoint checksum verified: %s", path)
    telemetry.emit("ckpt_restore_done", engine="vanilla", path=str(path),
                   seconds=round(time.monotonic() - t0, 4), verified=bool(verify),
                   step=int(meta.get("step", 0)))
    return meta


def load_subset_vanilla(path, target, prefix):
    """Restore only the leaves whose key path starts with ``prefix`` into
    ``target`` (a list of `Leaf` for exactly those leaves, in file order),
    one leaf at a time; every other frame is skipped unread. The parts'
    dtypes may differ from the saved ones (the restore casts, silently).
    Raises `CheckpointStructureError` when the selected leaves do not fit
    ``target``. Returns the meta. No checksum is checked here: the caller
    checks the sidecar first."""
    path = Path(path)
    with open(path, "rb") as f:
        meta, off = _read_header(f)
        paths = meta.get("paths") or []
        picked = [i for i, p in enumerate(paths) if p.startswith(prefix)]
        _check_structure({"paths": [paths[i] for i in picked],
                          "leaves": [meta["leaves"][i] for i in picked]},
                         target, path, warn_cast=False)
        _restore_frames(f, meta, off, path, dict(zip(picked, target)))
    return meta
