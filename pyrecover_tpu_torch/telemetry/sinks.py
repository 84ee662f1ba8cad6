"""Telemetry sinks + the tolerant JSONL read-back (the JAX package's
``telemetry/sinks.py``; either package reads the other's files).

``JsonlSink`` is the durable substrate: one JSON object per line, appended
and flushed per event so a SIGTERM/preemption kill loses at most the line
being written — the read-back side (``read_events``) therefore tolerates a
torn final line (and any other garbage line) by skipping it, mirroring the
loss-CSV torn-row policy in ``metrics.LossCSVLogger``.
"""

import json
import logging
import os
from pathlib import Path

from pyrecover_tpu_torch.telemetry.bus import _process_index

# size-based rotation defaults (env-overridable so test harnesses can
# exercise rotation on tiny runs without new CLI flags)
MAX_BYTES_ENV = "PYRECOVER_TELEMETRY_MAX_BYTES"
KEEP_ENV = "PYRECOVER_TELEMETRY_KEEP"
DEFAULT_KEEP = 3


def rotated_paths(path):
    """Existing rotated shards for ``path``, OLDEST FIRST (``p.N`` down to
    ``p.1``) — the read-back order that reconstructs the original stream
    when followed by the live file."""
    path = Path(path)
    out = []
    for p in path.parent.glob(path.name + ".*"):
        suffix = p.name[len(path.name) + 1:]
        if suffix.isdigit():
            out.append((int(suffix), p))
    return [p for _, p in sorted(out, reverse=True)]


class JsonlSink:
    """Host-0 JSONL file sink (one event per line, flushed per event).

    ``host0_only=False`` writes on every host — useful when each host logs
    to its own local file. ``append=False`` truncates (fresh run);
    ``append=True`` continues an existing stream (resume), which is what
    lets goodput accounting see the previous attempt's progress.

    Size-based rotation (``max_bytes`` / ``$PYRECOVER_TELEMETRY_MAX_BYTES``):
    once the live file crosses the limit it is renamed to ``<path>.1``
    (older shards shifting to ``.2`` … ``.keep``; the oldest beyond
    ``keep`` is deleted) and a fresh file is opened — a week-long soak
    cannot fill the disk with telemetry. ``read_events`` transparently
    merges the surviving shards, so goodput accounting and traceview see
    one continuous stream.
    """

    # fresh-run shard sweep of advisory telemetry; a crash mid-sweep
    # leaves stale shards the next sweep removes
    # faultcheck: tear-ok
    def __init__(self, path, *, host0_only=True, append=True,
                 max_bytes=None, keep=None):
        self.path = Path(path)
        self._file = None
        if max_bytes is None:
            max_bytes = int(os.environ.get(MAX_BYTES_ENV, "0")) or None
        if keep is None:
            keep = int(os.environ.get(KEEP_ENV, str(DEFAULT_KEEP)))
        self.max_bytes = max_bytes
        self.keep = max(int(keep), 1)
        self._bytes = 0
        if host0_only and _process_index() != 0:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if not append:
            # a fresh run must not leave a previous run's rotated shards
            # behind: read_events would merge two unrelated streams
            for p in rotated_paths(self.path):
                p.unlink(missing_ok=True)
        self._file = open(self.path, "a" if append else "w")
        if append and self.path.exists():
            self._bytes = self.path.stat().st_size

    def _rotate(self):  # faultcheck: tear-ok -- advisory log rotation
        self._file.close()
        self._file = None
        shards = rotated_paths(self.path)  # oldest first
        for n, p in [(int(p.name.rsplit(".", 1)[1]), p) for p in shards]:
            if n + 1 > self.keep:
                p.unlink(missing_ok=True)
            else:
                # rotation renames already-durable JSONL shards; the stream
                # flushes per event and every reader is torn-tail-tolerant
                os.replace(p, self.path.with_name(f"{self.path.name}.{n + 1}"))
        # the same rotation protocol as the shard shift above
        os.replace(self.path, self.path.with_name(self.path.name + ".1"))
        self._file = open(self.path, "w")
        self._bytes = 0

    def write(self, record):
        if self._file is None:
            return
        line = json.dumps(record, default=str, separators=(",", ":")) + "\n"
        self._file.write(line)
        self._file.flush()
        self._bytes += len(line)
        if self.max_bytes and self._bytes >= self.max_bytes:
            self._rotate()

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


class MemorySink:
    """In-memory sink for tests: records land in ``self.events``."""

    def __init__(self):
        self.events = []

    def write(self, record):
        self.events.append(dict(record))

    def close(self):
        pass


class LogSink:
    """Mirror events into the host-0 text log (one compact line each)."""

    def __init__(self, level=logging.INFO):
        self.level = level

    def write(self, record):
        from pyrecover_tpu_torch.utils.logging import log_host0

        fields = " ".join(
            f"{k}={record[k]}" for k in record
            if k not in ("ts", "event", "host")
        )
        log_host0("telemetry | %s %s", record["event"], fields, level=self.level)

    def close(self):
        pass


def read_events(path, *, include_rotated=True):
    """All parseable events from a telemetry JSONL, in file order —
    rotated shards (``path.N`` … ``path.1``) are prepended oldest-first so
    a rotated stream reads back as one continuous sequence.

    Torn lines (a kill mid-write), blank lines, and non-event JSON are
    skipped, never raised — the stream is observability, not state.
    Returns [] for a missing file.
    """
    path = Path(path)
    files = (rotated_paths(path) if include_rotated else []) + [path]
    out = []
    for p in files:
        if not p.exists():
            continue
        with open(p, "r", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and "event" in rec:
                    out.append(rec)
    return out


def last_recorded_step(path):
    """Highest ``step`` field recorded in a telemetry JSONL, or None.

    The resumed run uses this as the previous attempt's high-water mark:
    steps replayed below it are counted as lost (not productive) work in
    the goodput accounting — it survives hard kills because the JSONL is
    flushed per event.
    """
    best = None
    for rec in read_events(path):
        step = rec.get("step")
        if isinstance(step, (int, float)):
            step = int(step)
            if best is None or step > best:
                best = step
    return best
