"""Quarantine: move failed checkpoints aside, never delete them (the JAX
package's ``resilience/quarantine.py``; each move is a ``ckpt_quarantined``
event).

When the latest-resume fallback finds a checkpoint that fails its integrity
pre-check, the file (with its checksum sidecars, or a whole sharded
directory) moves into ``<exp_dir>/.corrupt/``:

  * the move is a same-filesystem ``os.replace``: atomic, no copy;
  * ``checkpoint.registry`` never looks inside ``.corrupt/``, so the next
    restart does not re-discover the file and retention never counts or
    deletes it; the evidence survives for a post-mortem;
  * the same name quarantined twice gets a numeric suffix instead of
    overwriting the earlier one.

Quarantine never turns a recoverable resume into a crash: a failure here is
logged and the caller's fallback walk goes on with the file left in place.
"""

import logging
import os
from pathlib import Path

from pyrecover_tpu_torch import telemetry

log = logging.getLogger("pyrecover_tpu_torch")

QUARANTINE_DIRNAME = ".corrupt"

_SIDECAR_SUFFIXES = (".sha256", ".md5")


def list_quarantined(exp_dir):
    """Quarantined checkpoint paths (newest-suffix last), [] if none."""
    q = Path(exp_dir) / QUARANTINE_DIRNAME
    if not q.is_dir():
        return []
    return sorted(p for p in q.iterdir() if not p.name.endswith(_SIDECAR_SUFFIXES))


def quarantine_checkpoint(path, reason=""):
    """Move a failed checkpoint into ``.corrupt/`` next to it, with its
    checksum sidecars. Returns the destination Path, or None when nothing
    was moved (missing source or a filesystem refusal: logged, never
    raised)."""
    path = Path(path)
    if not path.exists():
        return None
    qdir = path.parent / QUARANTINE_DIRNAME
    try:
        qdir.mkdir(exist_ok=True)
        dest = qdir / path.name
        n = 0
        while dest.exists():
            n += 1
            dest = qdir / f"{path.name}.{n}"
        # faultcheck: disable-next=unseamed-durable-effect -- quarantine IS the
        # failure path: it runs after a corrupt_ckpt_bytes drill detects
        # damage, and seaming the mover would inject faults into fault
        # handling itself; the whole move is retried on the next precheck
        os.replace(path, dest)
        if not dest.is_dir():  # a single file: bring its checksum sidecars
            for suffix in _SIDECAR_SUFFIXES:
                side = path.with_suffix(path.suffix + suffix)
                if side.exists():
                    os.replace(side, qdir / (dest.name + suffix))
    except OSError as e:
        log.warning("could not quarantine checkpoint %s (%s: %s); leaving it in place",
                    path, type(e).__name__, e)
        return None
    log.warning("Quarantined checkpoint %s -> %s/%s%s", path.name, QUARANTINE_DIRNAME,
                dest.name, f" ({reason})" if reason else "")
    telemetry.emit("ckpt_quarantined", path=str(path), dest=str(dest), reason=reason)
    return dest
