"""Incremental weight fetch: move only the chunks whose digests changed (the
JAX package's ``serving/hotswap/fetch.py``, over the port's chunk store,
which writes the JAX manifest format: both packages plan the same fetch
from the same manifests).

The zerostall chunk store is content-addressed (BLAKE2b-128 per chunk,
``checkpoint/zerostall/chunkstore.py``), which makes a manifest diff the
exact transfer plan: a chunk whose digest appears in BOTH the loaded and
the new manifest is already in the serving process's RAM and costs zero
reads; only changed chunks touch the store.

Verification is structural: every byte that enters an assembled leaf is
digest-checked against the NEW manifest. Fetched chunks through
``ChunkStore.get`` (the address IS the checksum); reused chunks by hashing
the bytes as they were copied into the leaf's buffer, so a process that
corrupted its own cache never launders it into "verified" weights: such a
chunk is fetched from the store instead. A chunk the store cannot give
with its digest raises; the swapper turns that into a loud
``weights_swap_rejected`` and keeps serving the old weights.

A leaf's chunks are checked and fetched on the chunk store's threads
(BLAKE2b and file reads release the interpreter lock). Leaves come back as
their raw bytes (flat ``uint8`` arrays, the manifest's dtype), which are
both what the swapper places on the device and its next reuse cache.
"""

import threading

import numpy as np

from pyrecover_tpu_torch.checkpoint.zerostall.chunkstore import (
    ChunkStore,
    _map,
    chunk_digest,
    expected_chunk_sizes,
)
from pyrecover_tpu_torch.resilience import faults


def diff_manifest_chunks(old_doc, new_doc, *, prefix=None):
    """Per-leaf chunk-digest diff between two zerostall manifest docs.

    Returns ``{"leaves": [...], ...totals}`` where each leaf row carries
    ``chunks_total`` / ``chunks_changed`` / ``fetch_bytes`` /
    ``reused_bytes`` against the OLD manifest (a leaf absent there, or
    chunked at a different ``chunk_bytes``, is all-changed: digests at
    different chunk sizes are not comparable). ``prefix`` restricts to one
    manifest-path subtree (the fetcher passes ``.params``)."""
    old_by_path = {e["path"]: e for e in old_doc.get("leaves", [])}
    rows = []
    totals = {"fetch_bytes": 0, "reused_bytes": 0, "chunks_changed": 0, "chunks_total": 0}
    for entry in new_doc.get("leaves", []):
        if prefix and not entry["path"].startswith(prefix):
            continue
        sizes = expected_chunk_sizes(int(entry["nbytes"]), int(entry["chunk_bytes"]))
        old = old_by_path.get(entry["path"])
        comparable = old is not None and int(old.get("chunk_bytes", -1)) == int(
            entry["chunk_bytes"])
        old_chunks = old["chunks"] if comparable else []
        changed = [i for i, d in enumerate(entry["chunks"])
                   if i >= len(old_chunks) or old_chunks[i] != d]
        fetch = sum(sizes[i] for i in changed)
        row = {
            "path": entry["path"],
            "nbytes": int(entry["nbytes"]),
            "chunks_total": len(entry["chunks"]),
            "chunks_changed": len(changed),
            "fetch_bytes": fetch,
            "reused_bytes": int(entry["nbytes"]) - fetch,
            "changed": bool(changed),
            "new_leaf": old is None,
        }
        rows.append(row)
        for key in totals:
            totals[key] += row[key]
    return {
        "leaves": rows,
        "changed_leaves": sum(1 for r in rows if r["changed"]),
        "num_leaves": len(rows),
        **totals,
    }


def fetch_leaf_incremental(store, entry, old_entry, old_bytes, *, manifest_path, stats):
    """Assemble one leaf's bytes for the NEW manifest ``entry`` as a flat
    ``uint8`` array, reusing chunks whose digests match ``old_entry`` out of
    ``old_bytes`` (the loaded leaf's flat bytes) and fetching the rest from
    ``store``. EVERY chunk is digest-verified before the leaf is returned:
    a reused one by hashing the bytes in the buffer (a mismatch fetches it
    instead), a fetched one inside ``store.get`` (a mismatch raises).
    ``stats`` (the byte and chunk ledger) is updated under a lock."""
    chunk_bytes = int(entry["chunk_bytes"])
    nbytes = int(entry["nbytes"])
    sizes = expected_chunk_sizes(nbytes, chunk_bytes)
    if len(sizes) != len(entry["chunks"]):
        raise ValueError(f"{entry['path']}: manifest lists {len(entry['chunks'])} chunks, "
                         f"layout expects {len(sizes)}")
    comparable = (old_entry is not None and old_bytes is not None
                  and int(old_entry.get("chunk_bytes", -1)) == chunk_bytes
                  and len(old_bytes) == int(old_entry.get("nbytes", -1)))
    old_chunks = old_entry["chunks"] if comparable else []
    buf = np.empty(nbytes, np.uint8)
    offsets = np.cumsum([0] + sizes[:-1]).tolist()
    lock = threading.Lock()

    def fill(job):
        i, digest, size, off = job
        window = buf[off:off + size]
        if i < len(old_chunks) and old_chunks[i] == digest:
            window[...] = old_bytes[off:off + size]
            # hash what now sits in the buffer: the cache is this process's
            # own RAM, and a swap must not launder a local corruption
            if chunk_digest(window) == digest:
                with lock:
                    stats["reused_bytes"] += size
                    stats["chunks_reused"] += 1
                return
        with lock:
            written = stats["fetched_bytes"]
        faults.check("swap_fetch", path=str(manifest_path), written=written)
        window[...] = np.frombuffer(store.get(digest, expected_len=size), np.uint8)
        with lock:
            stats["fetched_bytes"] += size
            stats["chunks_fetched"] += 1

    _map(fill, zip(range(len(sizes)), entry["chunks"], sizes, offsets))
    return buf


def fetch_params_incremental(exp_dir, new_doc, old_doc, old_host, *, manifest_path,
                             prefix=".params"):
    """Fetch the ``prefix`` subtree of ``new_doc`` incrementally against the
    loaded manifest ``old_doc`` and its cached bytes ``old_host`` (``{manifest
    path: flat uint8 array}``). Returns ``(flat, stats)``: ``flat`` is
    ``[(path, bytes)]`` in manifest order and ``stats`` the fetched/reused
    ledger. ``old_doc``/``old_host`` may be None: everything is then fetched
    (still digest-verified)."""
    store = ChunkStore(exp_dir)
    old_by_path = {e["path"]: e for e in (old_doc or {}).get("leaves", [])}
    old_host = old_host or {}
    stats = {"fetched_bytes": 0, "reused_bytes": 0, "chunks_fetched": 0, "chunks_reused": 0,
             "changed_leaves": 0, "leaves": 0}
    flat = []
    for entry in new_doc.get("leaves", []):
        path = entry["path"]
        if prefix and not path.startswith(prefix):
            continue
        before = stats["chunks_fetched"]
        raw = fetch_leaf_incremental(store, entry, old_by_path.get(path), old_host.get(path),
                                     manifest_path=manifest_path, stats=stats)
        stats["leaves"] += 1
        if stats["chunks_fetched"] > before:
            stats["changed_leaves"] += 1
        flat.append((path, raw))
    if not flat:
        raise ValueError(f"manifest {manifest_path} carries no {prefix!r} leaves — not a "
                         "training-state checkpoint a serving engine can swap to")
    return flat, stats
