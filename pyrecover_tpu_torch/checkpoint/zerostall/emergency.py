"""In-RAM emergency tier: restore without touching disk (the JAX package's
``checkpoint/zerostall/emergency.py``).

A disk restore scales with the checkpoint's size, and a fleet that restarts
often pays it every time. This tier keeps the last COMMITTED zerostall
snapshot in host RAM, so that ``train._resume`` restores in a fraction of a
second when the disk tier is behind (a save was mid-write when the run
died) or gone.

  * **Publish** runs in the zerostall writer thread after the manifest
    commit: the tier only ever holds a state that was durable once, so
    preferring it never resurrects an uncommitted step. On one host it is a
    hand-over of the snapshot's host buffers, not a copy: the record holds
    one of the snapshot's two pinned buffer sets (``snapshot.py``) until the
    next publish frees it. Costs one state of host RAM;
    ``$PYRECOVER_EMERGENCY=0`` turns the tier off.
  * **Several processes**: host 0, the writer, holds the record. With
    ``$PYRECOVER_EMERGENCY_PEER=1`` (read on host 0: taking part is host
    0's verdict, broadcast) every rank joins an exchange over the process
    group's CPU backend (the manifest, then every leaf's bytes) inside the
    next save's blocking window, on the calling thread, so each rank's RAM
    holds the whole state. It is opt-in because it moves a state's bytes.
  * **The gate before the tier is preferred**: the record's step is at least
    the newest disk manifest's, the saved topology equals the live one
    (elastic restores take the disk path), and every leaf's chunk digests
    are recomputed over the bytes in RAM and compared with the manifest: a
    flipped or torn record is rejected, never restored.

The store lives in the process (RAM dies with it): it spans ``train()``
calls in one process (a resilient launcher loop, a notebook, a test) and,
for peers, their processes.
"""

import os
import threading
import time
from pathlib import Path

import numpy as np
import torch

from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.checkpoint.zerostall import chunkstore
from pyrecover_tpu_torch.utils.logging import log_host0, process_index

EMERGENCY_ENV = "PYRECOVER_EMERGENCY"
PEER_EXCHANGE_ENV = "PYRECOVER_EMERGENCY_PEER"

_store = {}
_lock = threading.Lock()


def enabled():
    return os.environ.get(EMERGENCY_ENV, "1") != "0"


def _key(exp_dir):
    return str(Path(exp_dir).absolute())


def publish(exp_dir, doc, host_leaves, buffers=None):
    """Install a just-committed snapshot as the experiment's record (writer
    thread, host 0). ``host_leaves`` are the leaves' bytes as flat uint8
    numpy arrays and ``buffers`` the buffer set they view: a hand-over, so
    the caller must not write into them again while the record holds them."""
    if not enabled():
        return None
    record = {
        "doc": doc, "leaves": host_leaves, "buffers": buffers,
        "step": int(doc.get("step", 0)), "published_ts": time.time(),
        "peer_replicated": False,
    }
    with _lock:
        _store[_key(exp_dir)] = record
    telemetry.emit("emergency_publish", engine="zerostall", step=record["step"],
                   exp_dir=str(exp_dir), leaves=len(host_leaves),
                   bytes=int(sum(a.nbytes for a in host_leaves)))
    return record


def holds(exp_dir, buffers):
    """True when the experiment's record holds the buffer set ``buffers``."""
    with _lock:
        record = _store.get(_key(exp_dir))
    return record is not None and record.get("buffers") is buffers


# distcheck: congruent -- every rank calls this at the same point of every
# save; whether the exchange runs is host 0's verdict, broadcast first
def replicate_to_peers(exp_dir):  # jaxlint: sync-point
    """The opt-in exchange (``$PYRECOVER_EMERGENCY_PEER=1`` on host 0):
    broadcast the latest record, the manifest first and then each leaf's
    bytes, so every rank's RAM holds the whole, verifiable state. Runs on
    the calling thread of every rank, at the same point; a no-op in one
    process. Host 0 decides whether it runs and broadcasts that first, so
    no rank waits in a broadcast the others skipped."""
    from pyrecover_tpu_torch.parallel import mesh

    if mesh.world_size() <= 1:
        return False
    import torch.distributed as dist

    host0 = process_index() == 0
    want, record = 0, None
    if host0 and os.environ.get(PEER_EXCHANGE_ENV) == "1":
        with _lock:
            record = _store.get(_key(exp_dir))
        if record is not None and not record.get("peer_replicated"):
            want = 1
    if int(mesh.broadcast_host0_scalar(want)) != 1:
        return False
    doc = mesh.broadcast_host0_obj(record["doc"] if record is not None else None)
    replicated = []
    with telemetry.collective_phase("emergency_peer_exchange",
                                    leaves=len(doc.get("leaves", ()))):
        for i, entry in enumerate(doc["leaves"]):
            # host 0 sends its bytes; the others receive into buffers sized
            # from the broadcast manifest, so every rank takes part in the
            # same sequence of broadcasts
            if host0:  # want == 1: host 0 holds the record
                buf = torch.from_numpy(record["leaves"][i])
            else:
                buf = torch.empty(int(entry["nbytes"]), dtype=torch.uint8)
            dist.broadcast(buf, src=0)
            replicated.append(buf.numpy())
    new_record = {
        "doc": doc, "leaves": replicated,
        "buffers": record["buffers"] if host0 else None,
        "step": int(doc.get("step", 0)),
        "published_ts": record["published_ts"] if host0 else time.time(),
        "peer_replicated": True,
    }
    with _lock:
        _store[_key(exp_dir)] = new_record
    telemetry.emit("emergency_peer_exchange", engine="zerostall", step=new_record["step"],
                   exp_dir=str(exp_dir), leaves=len(replicated),
                   bytes=int(sum(a.nbytes for a in replicated)))
    return True


def peek(exp_dir):
    """``(step, record)`` of the experiment's record, or None."""
    with _lock:
        record = _store.get(_key(exp_dir))
    if record is None:
        return None
    return record["step"], record


def usable(exp_dir, target_topology, *, min_step=0):
    """Host-local gate: a record fresh enough and on the SAME topology
    (restores onto another go through the disk path and its preflight).
    Returns the record or None."""
    from pyrecover_tpu_torch.checkpoint.elastic import topologies_differ
    from pyrecover_tpu_torch.parallel import mesh

    got = peek(exp_dir)
    if got is None:
        return None
    step, record = got
    if step < min_step:
        return None
    if topologies_differ(record["doc"].get("topology"), target_topology):
        return None
    if mesh.world_size() > 1 and not record.get("peer_replicated"):
        # without the exchange only host 0 holds the bytes
        return None
    return record


def verify(record):
    """Recompute every leaf's chunk digests over the bytes in RAM and compare
    them with the committed manifest. Returns ``(ok, reason)``."""
    doc, leaves = record["doc"], record["leaves"]
    if len(leaves) != len(doc.get("leaves", [])):
        return False, (f"record holds {len(leaves)} leaves, manifest lists "
                       f"{len(doc.get('leaves', []))}")
    for entry, arr in zip(doc["leaves"], leaves):
        if chunkstore.leaf_chunk_digests(arr, int(entry["chunk_bytes"])) != entry["chunks"]:
            return False, (f"{entry['path']}: in-RAM bytes no longer match the committed "
                           "manifest digests")
    return True, ""


def restore(exp_dir, target, *, verified=False):
    """Restore ``target`` (a list of `Leaf`) from the record, every leaf's
    digests verified first (a mismatch raises; the caller falls back to
    disk) unless the caller's gate ``verified`` this record a moment ago.
    The bytes are copied into the target's parts on their device. Returns
    ``(sampler_state, doc)``."""
    from pyrecover_tpu_torch.checkpoint.vanilla import _restore

    got = peek(exp_dir)
    if got is None:
        raise LookupError(f"no emergency record for {exp_dir}")
    _, record = got
    doc, leaves = record["doc"], record["leaves"]
    t0 = time.monotonic()
    if len(leaves) != len(target):
        raise ValueError(f"emergency record has {len(leaves)} leaves, target expects "
                         f"{len(target)}")
    if not verified:
        with telemetry.span("ckpt_emergency_verify", engine="zerostall",
                            metric="ckpt_zerostall_emergency_verify_s"):
            ok, reason = verify(record)
            if not ok:
                raise ValueError(f"emergency record rejected: {reason}")
    with telemetry.span("ckpt_emergency_restore", engine="zerostall",
                        metric="ckpt_zerostall_emergency_restore_s"):
        for entry, raw, leaf in zip(doc["leaves"], leaves, target):
            if entry["path"] != leaf.path or list(entry["shape"]) != list(leaf.shape):
                raise ValueError(f"emergency record leaf {entry['path']} "
                                 f"{tuple(entry['shape'])} vs target {leaf.path} {leaf.shape}")
            _restore(leaf, torch.from_numpy(np.asarray(raw)), entry["dtype"])
    seconds = time.monotonic() - t0
    log_host0("Restored step %d from the in-RAM emergency tier in %.3f s (disk tier "
              "bypassed)", int(doc.get("step", 0)), seconds)
    telemetry.emit("emergency_restore", engine="zerostall", step=int(doc.get("step", 0)),
                   seconds=round(seconds, 4))
    return doc.get("sampler", {}), doc


def drop(exp_dir=None):
    """Forget the records (all of them with no argument), and with them the
    buffers they hold."""
    with _lock:
        if exp_dir is None:
            _store.clear()
        else:
            _store.pop(_key(exp_dir), None)
