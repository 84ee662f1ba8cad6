"""Checkpoint naming, latest-discovery and retention pruning (the JAX
package's ``checkpoint/registry.py``):

    <checkpoint_dir>/<experiment_name>/ckpt_<step>[_final][.ckpt]

Vanilla checkpoints are single ``.ckpt`` files; sharded checkpoints
(``checkpoint/sharded.py``, and the JAX package's) are directories;
zerostall checkpoints (``checkpoint/zerostall/``) are ``.zs.json``
manifests over a chunk store. ``engine_of`` tells them apart, so that discovery,
``latest`` and retention are scoped by engine and one engine's pruning never
touches another's checkpoints. A sharded save in progress is a hidden
``.ckpt_<step>.partial`` directory, which no listing matches. Order is always by the parsed step number, never by name
(``ckpt_1000`` sorts after ``ckpt_200``) or mtime (mtime breaks ties only).
"""

import re
import shutil
from pathlib import Path

from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.resilience import faults
from pyrecover_tpu_torch.resilience.quarantine import QUARANTINE_DIRNAME

_CKPT_RE = re.compile(r"^ckpt_(\d+)(_final)?(\.ckpt|\.zs\.json)?$")

VANILLA_SUFFIX = ".ckpt"
ZEROSTALL_SUFFIX = ".zs.json"

ENGINES = ("vanilla", "sharded", "zerostall")


def engine_of(path):
    """Which engine owns a checkpoint path: directories are sharded,
    ``.zs.json`` manifests are zerostall, everything else is a vanilla
    single file."""
    path = Path(path)
    if path.is_dir():
        return "sharded"
    if path.name.endswith(ZEROSTALL_SUFFIX):
        return "zerostall"
    return "vanilla"


def _check_engine(engine):
    if engine is not None and engine not in ENGINES:
        raise ValueError(f"unknown checkpoint engine {engine!r}")
    return engine


def checkpoint_path(checkpoint_dir, experiment_name, step, *, final=False, engine="vanilla"):
    """The checkpoint of ``step``: a vanilla ``.ckpt`` file, a sharded
    directory or a zerostall ``.zs.json`` manifest."""
    _check_engine(engine)
    name = f"ckpt_{int(step)}{'_final' if final else ''}"
    name += {"vanilla": VANILLA_SUFFIX, "zerostall": ZEROSTALL_SUFFIX}.get(engine, "")
    return Path(checkpoint_dir) / experiment_name / name


def parse_step(path):
    """Step number of a checkpoint path, or None if not a checkpoint name."""
    m = _CKPT_RE.match(Path(path).name)
    return int(m.group(1)) if m else None


def list_checkpoints(exp_dir, *, engine=None):
    """All checkpoints in ``exp_dir``, oldest to newest by step; only
    ``engine``'s when it is given. ``.corrupt/`` is never listed."""
    exp_dir = Path(exp_dir)
    want = _check_engine(engine)
    if not exp_dir.is_dir():
        return []
    out = []
    for p in exp_dir.iterdir():
        if p.name == QUARANTINE_DIRNAME:
            continue
        step = parse_step(p)
        if step is None:
            continue
        if want is not None and engine_of(p) != want:
            continue
        out.append((step, p.stat().st_mtime, p))
    out.sort(key=lambda t: (t[0], t[1]))
    return [p for _, _, p in out]


def get_latest_checkpoint(exp_dir, *, engine=None):
    """Newest checkpoint by step number, or None."""
    ckpts = list_checkpoints(exp_dir, engine=engine)
    return ckpts[-1] if ckpts else None


def prune_checkpoints(exp_dir, max_keep, *, engine=None):
    """Delete the oldest checkpoints beyond ``max_keep`` (with their
    checksum sidecars); only ``engine``'s count and go when it is given.
    Each removal is a ``ckpt_pruned`` event, the sweep one ``ckpt_prune``.
    Returns the deleted paths."""
    if max_keep is None or max_keep <= 0:
        return []
    ckpts = list_checkpoints(exp_dir, engine=engine)
    doomed = ckpts[:-max_keep] if len(ckpts) > max_keep else []
    engine_label = engine or "any"
    for p in doomed:
        # seam BEFORE the deletion: a drill must be able to fail between the
        # choice of victim and the unlink, to prove a half-finished prune
        # leaves the survivors restorable
        faults.check("ckpt_prune", path=p.name, step=parse_step(p))
        if p.is_dir():
            shutil.rmtree(p, ignore_errors=True)
        else:
            p.unlink(missing_ok=True)
            for suffix in (".sha256", ".md5"):
                p.with_suffix(p.suffix + suffix).unlink(missing_ok=True)
        # one event per removal: retention destroys durable state, so each
        # deletion is attributable in the stream
        telemetry.emit("ckpt_pruned", engine=engine_label, path=p.name, step=parse_step(p))
    if doomed:
        telemetry.emit("ckpt_prune", engine=engine_label, count=len(doomed),
                       removed=[p.name for p in doomed])
    return doomed
