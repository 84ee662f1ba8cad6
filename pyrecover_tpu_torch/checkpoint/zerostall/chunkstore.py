"""Content-addressed incremental chunk store of the zerostall engine (the
JAX package's ``checkpoint/zerostall/chunkstore.py``: the same format
version, layout, digests and chunking, so each package reads the other's
stores).

Every leaf's byte stream is cut into fixed-size chunks addressed by a
BLAKE2b-128 digest of their content under ``<exp_dir>/chunks/<dd>/<digest>``.
A chunk that already exists costs no write on the next save, and a
checkpoint is a small manifest (``ckpt_<step>.zs.json``) mapping leaves to
chunk digests, published with one atomic rename:

  * **incremental saves**: a second save of a mostly unchanged state writes
    only the chunks whose content moved; each leaf's ``reused`` count in the
    manifest says how many were deduplicated;
  * **torn saves cannot corrupt**: chunks are immutable once written (one
    digest, one content) and the manifest rename is the only commit point,
    so a kill at any earlier stage leaves every earlier manifest restorable
    and at worst orphan chunks for the garbage collector;
  * **refcounted garbage collection** (`collect_garbage`): a chunk goes only
    when no live manifest references it, quarantined manifests under
    ``.corrupt/`` and unexpired pins (``pins.py``) included.

Chunks are cut over a leaf's WHOLE byte stream. The port keeps a stacked
leaf as one tensor a layer (``checkpoint/vanilla.py::Leaf``); the snapshot
lays each leaf's parts out contiguously, so a chunk may span parts (one
4 MiB chunk holds all of llama-1b's RMSNorm scale parts) and the digests
equal the JAX package's. Chunk reads re-verify the digest: the address is
the checksum, and there are no sidecars. The chunk size is recorded in each
manifest entry; ``$PYRECOVER_ZS_CHUNK_BYTES`` sets it (default 4 MiB).

A leaf's chunks are hashed, written, read and checked on a few threads at
once (`_map`): BLAKE2b and file I/O release the interpreter lock, and one
core hashes and writes a 3 GB state at ~220 MB/s (``PERF.md``). The digest
lists, and the written and reused counts, are the sequential ones: the first
of several equal chunks in a save is written, the others are hits.
"""

import concurrent.futures
import hashlib
import json
import os
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.resilience import faults
from pyrecover_tpu_torch.resilience.retry import io_retry

ZS_FORMAT_VERSION = 1
CHUNKS_DIRNAME = "chunks"
CHUNK_BYTES_ENV = "PYRECOVER_ZS_CHUNK_BYTES"
DEFAULT_CHUNK_BYTES = 4 * 1024 * 1024


# the threads a leaf's chunks are processed on
_WORKERS = min(4, os.cpu_count() or 1)


def chunk_bytes_default():
    return int(os.environ.get(CHUNK_BYTES_ENV, DEFAULT_CHUNK_BYTES))


def _map(fn, items):
    """``[fn(x) for x in items]`` on the chunk threads, in order; the first
    error raises."""
    items = list(items)
    if len(items) <= 1:
        return [fn(x) for x in items]
    with concurrent.futures.ThreadPoolExecutor(_WORKERS, thread_name_prefix="zs-chunk") as ex:
        return list(ex.map(fn, items))


def chunk_digest(data):
    """Content address of one chunk: BLAKE2b-128 hex (32 chars)."""
    return hashlib.blake2b(data, digest_size=16).hexdigest()


def chunks_root(exp_dir):
    return Path(exp_dir) / CHUNKS_DIRNAME


def chunk_path(root, digest):
    # two-hex-char fan-out keeps directory listings short
    return Path(root) / digest[:2] / digest


def byte_view(arr):
    """A flat ``memoryview`` of bytes over a host array (numpy, or a CPU
    tensor), without a copy when it is contiguous."""
    if not isinstance(arr, np.ndarray):
        arr = arr.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
    return memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8)).cast("B")


def split_chunks(view, chunk_bytes):
    """Yield fixed-size windows over a contiguous byte view."""
    for off in range(0, len(view), chunk_bytes):
        yield view[off:off + chunk_bytes]
    if len(view) == 0:
        # a zero-byte leaf still gets one addressable chunk
        yield view


def leaf_chunk_digests(arr, chunk_bytes):
    """The chunk digests a save of this host array's bytes would give: the
    emergency tier's digest gate and the tests key on them."""
    return _map(chunk_digest, split_chunks(byte_view(arr), chunk_bytes))


class ChunkStore:
    """Write and read handle over ``<exp_dir>/chunks/``, counting the bytes
    and chunks written and reused for the manifest's ``reuse`` record."""

    def __init__(self, exp_dir):
        self.root = chunks_root(exp_dir)
        self.written_bytes = 0
        self.reused_bytes = 0
        self.written_chunks = 0
        self.reused_chunks = 0
        self._claimed = set()  # digests this store has written or is writing
        self._lock = threading.Lock()

    def _count(self, n, *, written):
        with self._lock:
            if written:
                self.written_chunks += 1
                self.written_bytes += n
            else:
                self.reused_chunks += 1
                self.reused_bytes += n

    def put(self, data):
        """Store one chunk (bytes or a memoryview); returns its digest. A
        chunk already stored (or being stored by another thread) with the
        right size is a hit and costs no write. Thread-safe."""
        digest = chunk_digest(data)
        dest = chunk_path(self.root, digest)
        with self._lock:
            first = digest not in self._claimed
            self._claimed.add(digest)
        if not first or (dest.exists() and dest.stat().st_size == len(data)):
            self._count(len(data), written=False)
            return digest
        dest.parent.mkdir(parents=True, exist_ok=True)
        path_s = str(dest)

        def write_once():
            # the seam raises or kills BEFORE the write, so an injected fault
            # never leaves half a chunk behind the retry
            faults.check("ckpt_chunk_write", path=path_s, written=self.written_bytes)
            fd, tmp = tempfile.mkstemp(dir=dest.parent, prefix=digest, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, dest)  # a chunk is whole or absent
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)

        io_retry(write_once, op="chunk_write", path=path_s)
        self._count(len(data), written=True)
        # a landed chunk is checkpoint-writer progress for the watchdog
        telemetry.watchdog.beat("ckpt_writer")
        return digest

    def get(self, digest, expected_len=None):
        """Read one chunk and re-verify its digest."""
        path = chunk_path(self.root, digest)

        def read_once():
            faults.check("ckpt_read", path=str(path))
            return path.read_bytes()

        data = io_retry(read_once, op="read", path=str(path))
        if expected_len is not None and len(data) != expected_len:
            raise ValueError(f"chunk {digest}: {len(data)} bytes on disk, expected "
                             f"{expected_len} — torn or foreign chunk")
        actual = chunk_digest(data)
        if actual != digest:
            raise ValueError(f"chunk {digest}: content digest {actual} does not match "
                             "its address — on-disk corruption")
        return data

    def reuse_stats(self):
        return {
            "chunks_total": self.written_chunks + self.reused_chunks,
            "chunks_written": self.written_chunks,
            "chunks_reused": self.reused_chunks,
            "bytes_total": self.written_bytes + self.reused_bytes,
            "bytes_written": self.written_bytes,
            "bytes_reused": self.reused_bytes,
        }


def write_leaf(store, arr, chunk_bytes):
    """Chunk one leaf's host bytes into the store; returns ``(digests,
    reused)``, ``reused`` the chunks that were hits."""
    before = store.reused_chunks
    digests = _map(store.put, split_chunks(byte_view(arr), chunk_bytes))
    return digests, store.reused_chunks - before


def expected_chunk_sizes(nbytes, chunk_bytes):
    """The chunk sizes a leaf of ``nbytes`` splits into."""
    if nbytes == 0:
        return [0]
    sizes = [chunk_bytes] * (nbytes // chunk_bytes)
    if nbytes % chunk_bytes:
        sizes.append(nbytes % chunk_bytes)
    return sizes


def assemble_leaf(store, entry):
    """A leaf's bytes as a flat uint8 numpy array, from its manifest entry,
    every chunk's digest verified on the way."""
    nbytes = int(entry["nbytes"])
    sizes = expected_chunk_sizes(nbytes, int(entry["chunk_bytes"]))
    if len(sizes) != len(entry["chunks"]):
        raise ValueError(f"{entry['path']}: manifest lists {len(entry['chunks'])} chunks, "
                         f"layout expects {len(sizes)}")
    buf = np.empty(nbytes, np.uint8)
    offsets = np.cumsum([0] + sizes[:-1]).tolist()

    def fill(job):
        digest, size, off = job
        buf[off:off + size] = np.frombuffer(store.get(digest, expected_len=size), np.uint8)

    _map(fill, zip(entry["chunks"], sizes, offsets))
    return buf


# ---- manifest commit / read ------------------------------------------------


def commit_manifest(path, doc):
    """Publish a manifest atomically: a temporary file, fsync, one
    ``os.replace``. The ``ckpt_manifest_commit`` seam sits between the
    durable temporary file and the rename: a kill there leaves the previous
    manifest the newest restorable checkpoint."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = json.dumps(doc).encode()
    path_s = str(path)

    def commit_once():
        fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            faults.check("ckpt_manifest_commit", path=path_s)  # durable, unpublished
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    io_retry(commit_once, op="manifest_commit", path=path_s)
    telemetry.watchdog.beat("ckpt_writer")
    return len(payload)


def read_manifest(path):
    """Parse a ``.zs.json`` manifest; raises on a malformed or unsupported
    one (the pre-check turns that into a fallback)."""
    doc = json.loads(Path(path).read_text())
    if doc.get("format") != ZS_FORMAT_VERSION:
        raise ValueError(f"unsupported zerostall manifest format {doc.get('format')!r}")
    return doc


# ---- garbage collection ----------------------------------------------------


def _iter_manifests(exp_dir):
    """Every manifest whose chunks must stay: the experiment's checkpoints,
    the quarantined ones under ``.corrupt/`` (evidence stays restorable) and
    unexpired pins under ``pins/``."""
    from pyrecover_tpu_torch.checkpoint.registry import ZEROSTALL_SUFFIX
    from pyrecover_tpu_torch.checkpoint.zerostall import pins
    from pyrecover_tpu_torch.resilience.quarantine import QUARANTINE_DIRNAME

    exp_dir = Path(exp_dir)
    if exp_dir.is_dir():
        for p in exp_dir.iterdir():
            if p.is_file() and p.name.endswith(ZEROSTALL_SUFFIX):
                yield p
    qdir = exp_dir / QUARANTINE_DIRNAME
    if qdir.is_dir():
        for p in qdir.iterdir():
            # collision-suffixed names (ckpt_3.zs.json.1) count too
            if p.is_file() and ZEROSTALL_SUFFIX in p.name:
                yield p
    yield from pins.live_pins(exp_dir)


def referenced_digests(exp_dir):
    """The digests any live, quarantined or pinned manifest references."""
    refs = set()
    for manifest in _iter_manifests(exp_dir):
        try:
            doc = json.loads(manifest.read_text())
        except ValueError:
            continue  # a torn manifest references nothing provable
        for entry in doc.get("leaves", []):
            refs.update(entry.get("chunks", []))
    return refs


def collect_garbage(exp_dir):
    """Remove every chunk no live manifest references (orphans of a killed
    writer included), never one a live, quarantined or pinned manifest
    needs. Stale pins expire first. Returns ``(removed, removed_bytes)``."""
    from pyrecover_tpu_torch.checkpoint.registry import ZEROSTALL_SUFFIX
    from pyrecover_tpu_torch.checkpoint.zerostall import pins

    t0 = time.monotonic()
    exp_dir = Path(exp_dir)
    pins.expire_stale_pins(exp_dir)
    root = chunks_root(exp_dir)
    # manifest temporaries a kill left between mkstemp and the rename: the
    # depth-1 queue means no other writer has a commit in flight
    if exp_dir.is_dir():
        for tmp in exp_dir.glob(f"ckpt_*{ZEROSTALL_SUFFIX}*.tmp"):
            tmp.unlink(missing_ok=True)
    if not root.is_dir():
        return 0, 0
    refs = referenced_digests(exp_dir)
    removed = removed_bytes = kept = 0
    for sub in sorted(root.iterdir()):
        if not sub.is_dir():
            continue
        for chunk in sorted(sub.iterdir()):
            if chunk.name in refs:
                kept += 1
                continue
            # seam BEFORE the unlink: a drill can stop the sweep between the
            # choice of victim and the deletion
            faults.check("ckpt_gc_unlink", path=str(chunk))
            try:
                removed_bytes += chunk.stat().st_size
                chunk.unlink()
                removed += 1
            except OSError:
                kept += 1
        try:
            sub.rmdir()  # only when empty
        except OSError:
            pass
    if removed:
        telemetry.emit("ckpt_gc", engine="zerostall", removed=removed,
                       removed_bytes=removed_bytes, kept=kept,
                       seconds=round(time.monotonic() - t0, 4))
    return removed, removed_bytes
