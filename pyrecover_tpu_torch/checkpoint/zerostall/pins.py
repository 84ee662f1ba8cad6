"""Manifest pin leases: keep a reader's chunks alive across GC (the JAX
package's ``checkpoint/zerostall/pins.py``, the same files and TTL).

``collect_garbage`` reclaims every chunk no live manifest references —
which is exactly wrong for a *reader* that is mid-fetch on a manifest
the trainer's retention just pruned: the manifest file disappears, its
chunks lose their last reference, and GC deletes bytes the reader is
about to ``store.get``. The JAX package's serving hot-swap fetcher is
such a reader (a replica can lag the training run by several saves).

A pin is a *lease*: a copy of the manifest document written atomically
into ``<exp_dir>/pins/``. Because the pin carries the full chunk-digest
map (manifests are small — digests, never tensor bytes), GC can count a
pinned manifest's chunks as live even after the manifest itself was
pruned. Leases are crash-safe by expiry, not by cleanup: a reader that
dies mid-fetch (a SIGKILL, say)
leaves a stale pin behind, and GC unlinks any lease older than
``$PYRECOVER_PIN_TTL_S`` (default 900 s) before computing the live set —
a dead reader delays reclamation by one TTL, never blocks it forever.
Live readers that fetch for longer than the TTL call
:meth:`PinLease.refresh` to re-arm the clock.

Pin files live under their own subdirectory so checkpoint discovery
(``registry.list_checkpoints``) and retention never see them; the
``pins/`` name cannot parse as a checkpoint step either.
"""

import json
import os
import tempfile
import time
from pathlib import Path

from pyrecover_tpu_torch.resilience import faults

PINS_DIRNAME = "pins"
PIN_SUFFIX = ".pin"
PIN_TTL_ENV = "PYRECOVER_PIN_TTL_S"
DEFAULT_PIN_TTL_S = 900.0


def pins_dir(exp_dir):
    return Path(exp_dir) / PINS_DIRNAME


def pin_ttl_s():
    try:
        return float(os.environ.get(PIN_TTL_ENV, DEFAULT_PIN_TTL_S))
    except ValueError:
        return DEFAULT_PIN_TTL_S


class PinLease:
    """Handle over one live pin file. ``release()`` (or context exit)
    unlinks it; ``refresh()`` re-arms the staleness clock mid-fetch."""

    def __init__(self, path):
        self.path = Path(path)

    def refresh(self):
        try:
            os.utime(self.path, None)
        except OSError:
            pass  # expired + collected underneath us; release is a no-op

    def release(self):
        self.path.unlink(missing_ok=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


def pin_manifest(exp_dir, manifest_path, doc=None, *, owner=""):
    """Pin ``manifest_path``'s chunks: atomically publish a copy of its
    document (plus lease metadata) under ``pins/``. Returns a
    :class:`PinLease`. ``doc`` skips a re-read when the caller already
    parsed the manifest."""
    manifest_path = Path(manifest_path)
    if doc is None:
        doc = json.loads(manifest_path.read_text())
    pdir = pins_dir(exp_dir)
    pdir.mkdir(parents=True, exist_ok=True)
    owner = owner or f"pid{os.getpid()}"
    lease_doc = dict(doc)
    lease_doc["pin_manifest"] = manifest_path.name
    lease_doc["pin_owner"] = owner
    lease_doc["pinned_ts"] = time.time()
    dest = pdir / f"{manifest_path.name}.{owner}{PIN_SUFFIX}"
    payload = json.dumps(lease_doc).encode()
    fd, tmp = tempfile.mkstemp(dir=pdir, prefix=dest.name, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        # faultcheck: disable-next=unseamed-durable-effect -- leases are
        # crash-safe by TTL expiry, not by injection: a reader killed while
        # it holds a pin is exactly what the expiry clock handles
        os.replace(tmp, dest)  # a pin is whole or absent — GC parses it
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return PinLease(dest)


def expire_stale_pins(exp_dir, *, ttl_s=None):
    """Unlink leases older than the TTL; returns the removed names. GC
    calls this before computing the live digest set, so a crashed
    reader's pin delays reclamation by at most one TTL.

    ``.tmp`` orphans are swept by the same clock: a pin writer killed
    between ``mkstemp`` and the rename leaves a tmp file that no
    ``release()`` will ever unlink, and a fresh one belongs to a write
    still in flight — the TTL separates the two."""
    pdir = pins_dir(exp_dir)
    if not pdir.is_dir():
        return []
    ttl = pin_ttl_s() if ttl_s is None else float(ttl_s)
    now = time.time()
    removed = []
    for p in sorted(pdir.iterdir()):
        if not p.is_file():
            continue
        if not (p.name.endswith(PIN_SUFFIX) or p.name.endswith(".tmp")):
            continue
        try:
            stale = now - p.stat().st_mtime > ttl
        except OSError:
            continue  # racing release(); either way it is gone or fresh
        if not stale:
            continue
        # seam BEFORE the unlink so a drill can kill or EIO the sweep
        # between victim selection and the deletion itself
        faults.check("ckpt_gc_unlink", path=str(p))
        try:
            p.unlink()
            removed.append(p.name)
        except OSError:
            continue  # racing release(); gone is what we wanted
    return removed


def live_pins(exp_dir):
    """Every unexpired pin file (expiry is GC's job — this just lists)."""
    pdir = pins_dir(exp_dir)
    if not pdir.is_dir():
        return []
    return sorted(
        p for p in pdir.iterdir()
        if p.is_file() and p.name.endswith(PIN_SUFFIX)
    )
