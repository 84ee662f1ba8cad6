"""Sharded checkpoints on ``torch.distributed.checkpoint`` (DCP): the
reference's second strategy (``save_ckpt_distributed`` /
``load_ckpt_distributed``, ``checkpoint.py:218-368``), with the interface of
the JAX package's ``checkpoint/sharded.py`` (``ShardedCheckpointer`` with
``save``, ``wait``, ``restore`` and ``close``; ``precheck_ckpt_sharded``;
``save_ckpt_sharded``; ``load_ckpt_sharded``).

A checkpoint is a directory ``ckpt_<step>[_final]`` in the port's own DCP
layout (not Orbax's; the vanilla ``PYRCKPT2`` file stays the format both
packages share):

  * DCP's files: ``.metadata`` and each rank's ``__<rank>_<n>.distcp``,
    written with ``FileSystemWriter``. The state dict holds one tensor per
    part of each `Leaf` of the training state: ``<leaf path>`` for a single
    tensor, ``<leaf path>#<i>`` for layer i of a stacked leaf. DCP writes
    each replicated tensor once, spread over the ranks, so under DDP every
    rank writes a share and nothing is gathered; a restore reads any
    layout onto any number of ranks (a dp2 checkpoint resumes at dp1).
    A leaf of which each rank holds a slice (an fsdp, tensor or expert slice
    of a parameter or moment, a ZeRO-1 moment, a row of the int8 residual: the
    `Leaf`'s ``shard``) is written by each rank as its
    slice, under the part's key plus ``@<dim>:<start>:<stop>`` for each
    dimension the slice narrows (an fsdp x tensor slice names two) unless
    the slice is whole parts (layers), which keep their plain keys. A restore reads, for each part it wants, whichever saved
    pieces overlap it, so zero1 and ``none`` checkpoints restore into each
    other at any ``--dp``.
  * ``meta.json``: the leaf paths, dtypes, shapes and specs (where a leaf
    has one: a sharded leaf's rule), the sampler state and
    counters (``step``, ``epoch``, ``topology``), the host-side leaves
    (optimizer counts, ``step``, ``epoch``, ``rng``: numpy values, kept in
    the JSON), and a BLAKE2b-128 digest of each ``.params`` leaf's bytes
    (the JAX package's ``leaf_digests``), computed by reading the leaf back
    from the written files.

A save writes into ``.<name>.partial`` beside its target; host 0 publishes
it with one ``os.replace`` after every rank's files and ``.metadata`` are
down, so ``latest`` never names a torn save. With ``use_async`` the save
goes through ``dcp.async_save``: the device-to-host copy happens in the
call, the file writes and the publish overlap the following steps, and
``wait`` joins them. DCP's collectives run on a gloo group of their own,
made when the checkpointer is (every rank makes it at the same point), so a
background save never interleaves with the step's collectives. In one
process there is no group: DCP runs without one (``no_dist``).

The events and fault seams are the vanilla writer's: ``ckpt_save_start``,
``ckpt_save_blocking``, ``ckpt_save_shadow``, ``ckpt_commit``,
``ckpt_restore_start``/``ckpt_restore_done``; the spans ``ckpt_serialize``
(the call's blocking part), ``ckpt_write`` (the files), ``ckpt_fsync``,
``ckpt_rename`` and ``ckpt_read``; the seams ``ckpt_save_begin``, ``ckpt_write`` (before a
rank's files), ``ckpt_fsync`` (the meta, after DCP's writer has synced its
own files), ``ckpt_rename`` (before the publish), ``ckpt_commit`` and
``ckpt_read``.
"""

import hashlib
import json
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.checkpoint.registry import prune_checkpoints
from pyrecover_tpu_torch.checkpoint.vanilla import (
    FORMAT_VERSION,
    CheckpointStructureError,
    _check_structure,
)
from pyrecover_tpu_torch.resilience import faults
from pyrecover_tpu_torch.resilience.retry import io_retry
from pyrecover_tpu_torch.utils.logging import log_host0, process_index

META_NAME = "meta.json"
DCP_METADATA = ".metadata"


def _is_tensor_leaf(leaf):
    return all(isinstance(p, torch.Tensor) for p in leaf.parts)


def _part_keys(leaf):
    """The DCP key of each of ``leaf``'s parts."""
    shard = leaf.shard
    if shard is None:
        if len(leaf.parts) == 1:
            return [leaf.path]
        return [f"{leaf.path}#{i}" for i in range(len(leaf.parts))]
    n = shard.shape[0] if shard.stacked else 1
    full = shard.shape[1:] if shard.stacked else shard.shape
    keys = []
    for i in range(n):
        region = shard.part_region(i)
        if region is None:
            continue
        base = f"{leaf.path}#{i}" if n > 1 else leaf.path
        keys.append(base + "".join(f"@{d}:{a}:{a + length}"
                                   for d, (a, length) in enumerate(region)
                                   if (a, length) != (0, full[d])))
    return keys


def _split_key(key):
    """``(base key, box-narrowing regions or None)`` of a DCP key: one
    ``(dim, start, stop)`` a narrowed dimension."""
    base, *sfx = key.split("@")
    return base, tuple(tuple(int(x) for x in r.split(":")) for r in sfx) if sfx else None


def _box(shape, region):
    box = [(0, int(n)) for n in shape]
    for d, a, b in region or ():
        box[d] = (a, b)
    return box


def _view(t, box, origin):
    """``t`` (holding ``origin``'s box) narrowed to ``box``."""
    for d, ((a, b), (o, _)) in enumerate(zip(box, origin)):
        t = t.narrow(d, a - o, b - a)
    return t


def _read_plan(leaves, saved_keys, alloc=True):
    """``(state dict to read, copies)`` for restoring ``leaves``' tensor
    parts from a checkpoint holding ``saved_keys``: a part whose key was
    saved reads in place; any other reads each saved piece of its base key
    that overlaps it into a host tensor, and ``copies`` lists ``(part, its
    box, piece, the piece's box, the overlap)``. Raises
    `CheckpointStructureError` for a part the pieces do not cover; without
    ``alloc`` it only checks that (nothing is allocated)."""
    pieces = {}
    for key in saved_keys:
        base, region = _split_key(key)
        pieces.setdefault(base, []).append((region, key))
    sd, copies = {}, []
    for leaf in leaves:
        if not _is_tensor_leaf(leaf):
            continue
        stacked = "['layers']" in leaf.path  # a part a layer
        full = tuple(leaf.shape[1:]) if stacked else tuple(leaf.shape)
        for key, part in zip(_part_keys(leaf), leaf.parts):
            if key in saved_keys:
                sd[key] = part
                continue
            base, region = _split_key(key)
            tbox = _box(full, region)
            covered = 0
            for sregion, skey in pieces.get(base, []):
                sbox = _box(full, sregion)
                inter = [(max(a, c), min(b, d)) for (a, b), (c, d) in zip(tbox, sbox)]
                if any(a >= b for a, b in inter):
                    continue
                if alloc:
                    if skey not in sd:
                        sd[skey] = torch.empty([b - a for a, b in sbox], dtype=part.dtype)
                    copies.append((part, tbox, sd[skey], sbox, inter))
                covered += int(np.prod([b - a for a, b in inter]))
            if covered != int(np.prod([b - a for a, b in tbox])):
                raise CheckpointStructureError(
                    f"checkpoint does not hold the whole of {key} (saved pieces of {base}: "
                    f"{sorted(k for _, k in pieces.get(base, []))[:4]})")
    return sd, copies


def state_dict_of(leaves):
    """DCP's state dict for ``leaves``: each tensor part under its key."""
    sd = {}
    for leaf in leaves:
        if _is_tensor_leaf(leaf):
            for key, part in zip(_part_keys(leaf), leaf.parts):
                sd[key] = part.detach()
    return sd


def _host_leaves(leaves):
    """The numpy leaves, JSON-ready."""
    return {leaf.path: {"dtype": str(leaf.parts[0].dtype),
                        "value": np.asarray(leaf.parts[0]).tolist()}
            for leaf in leaves if not _is_tensor_leaf(leaf)}


def _leaf_digest(parts):
    """BLAKE2b-128 over a leaf's C-order bytes, its parts in order."""
    h = hashlib.blake2b(digest_size=16)
    for part in parts:
        t = part.detach().cpu().contiguous().reshape(-1)
        h.update(t.view(torch.uint8).numpy())
    return h.hexdigest()


def _read_back(path, leaves):
    """``{leaf path: its whole parts}``, fresh CPU tensors read from the DCP
    files at ``path`` by this process alone: a leaf every rank wrote a slice
    of is assembled from the slices."""
    import torch.distributed.checkpoint as dcp

    from pyrecover_tpu_torch.checkpoint.vanilla import _TORCH_DTYPES, Leaf

    whole = []
    for leaf in leaves:
        dtype = _TORCH_DTYPES[leaf.dtype]
        if leaf.shard is None:
            shapes = [tuple(p.shape) for p in leaf.parts]
        elif leaf.shard.stacked:
            shapes = [tuple(leaf.shape[1:])] * int(leaf.shape[0])
        else:
            shapes = [tuple(leaf.shape)]
        whole.append(Leaf(leaf.path, leaf.shape, leaf.dtype,
                          [torch.empty(s, dtype=dtype) for s in shapes]))
    reader = dcp.FileSystemReader(str(path))
    sd, copies = _read_plan(whole, set(reader.read_metadata().state_dict_metadata))
    dcp.load(sd, storage_reader=reader, no_dist=True)
    for part, tbox, piece, sbox, inter in copies:
        _view(part, inter, tbox).copy_(_view(piece, inter, sbox))
    return {leaf.path: leaf.parts for leaf in whole}


def param_digests(path, leaves):
    """``{.params leaf path: digest}`` of the checkpoint's files, read back
    whole (``leaves`` name the params' paths, shapes and dtypes)."""
    params = [leaf for leaf in leaves if leaf.path.startswith(".params")]
    return {path_: _leaf_digest(parts) for path_, parts in _read_back(path, params).items()}


def verify_param_digests(path, leaves):
    """True when every ``.params`` leaf of the checkpoint hashes to the
    digest its meta recorded."""
    meta = read_meta(path)
    want = meta.get("leaf_digests") or {}
    return bool(want) and param_digests(path, leaves) == want


def read_meta(path):
    return json.loads((Path(path) / META_NAME).read_text())


class ShardedSaveHandle:
    """One save: ``blocking_s`` (what the caller waited), and once durable
    ``bytes`` and ``write_s`` (``bytes`` counts this rank's files). For an
    asynchronous save ``wait()`` joins it and re-raises its error."""

    def __init__(self, path):
        self.path = Path(path)
        self.blocking_s = 0.0
        self.bytes = None
        self.write_s = None
        self.shadow_s = 0.0  # seconds written in the background
        self.error = None
        self._thread = None

    def wait(self, timeout=None):
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"background sharded checkpoint save still running after {timeout:.0f}s")
            self._thread = None
        if self.error is not None:
            raise self.error

    @property
    def done(self):
        return self._thread is None or not self._thread.is_alive()


class ShardedCheckpointer:
    """Long-lived sharded checkpointer; owns DCP's process group and the
    save in flight. Every rank makes one at the same point, calls ``save``
    and ``restore`` together, and ``close``s it (or uses it as a context
    manager)."""

    def __init__(self, use_async=True):
        import torch.distributed as dist

        from pyrecover_tpu_torch.parallel import mesh

        self.use_async = bool(use_async)
        self.group = dist.new_group(backend="gloo") if mesh.world_size() > 1 else None
        self._in_flight = None

    def _barrier(self, tag):
        if self.group is not None:
            import torch.distributed as dist

            with telemetry.collective_phase(f"barrier:{tag}"):
                dist.all_reduce(torch.zeros(1), group=self.group)

    def save(self, path, leaves, sampler_state=None, *, max_keep=None, extra_meta=None,
             background=None):
        """Save ``leaves`` (a list of `Leaf`) to the directory ``path``,
        through ``dcp.async_save`` when ``background`` (default: the
        checkpointer's ``use_async``). Returns a `ShardedSaveHandle`; an
        asynchronous save is durable once its ``wait()`` (or the
        checkpointer's) returns."""
        import torch.distributed.checkpoint as dcp

        background = self.use_async if background is None else bool(background)
        t0 = time.monotonic()
        path = Path(path).absolute()
        path_s = str(path)
        telemetry.emit("ckpt_save_start", engine="sharded", path=path_s,
                       background=background)
        faults.check("ckpt_save_begin", engine="sharded", path=path_s)
        self.wait()  # one save in flight
        tmp = path.with_name(f".{path.name}.partial")
        host0 = process_index() == 0
        if host0:
            shutil.rmtree(tmp, ignore_errors=True)  # a torn save's leftovers
        self._barrier("ckpt_partial")

        def prepare():
            faults.check("ckpt_write", path=path_s, written=0)
            tmp.mkdir(parents=True, exist_ok=True)

        io_retry(prepare, op="write", path=path_s)
        meta = {
            "format": FORMAT_VERSION, "engine": "sharded", "treedef": "TrainState",
            "paths": [leaf.path for leaf in leaves],
            # a leaf's spec where it has one: the elastic plan's saved grid
            "leaves": [{"dtype": leaf.dtype, "shape": list(leaf.shape),
                        **({"spec": list(leaf.spec)} if leaf.spec is not None else {})}
                       for leaf in leaves],
            "sampler": sampler_state or {},
            "host_leaves": _host_leaves(leaves),
            **(extra_meta or {}),
        }
        handle = ShardedSaveHandle(path)
        writer = dcp.FileSystemWriter(str(tmp))
        state = state_dict_of(leaves)
        t_write = time.monotonic()
        with telemetry.span("ckpt_serialize", engine="sharded", path=path_s,
                            metric="ckpt_sharded_serialize_s"):
            if background:
                future = dcp.async_save(state, storage_writer=writer, process_group=self.group,
                                        no_dist=self.group is None)
            else:
                with telemetry.span("ckpt_write", engine="sharded", path=path_s,
                                    metric="ckpt_sharded_write_s"):
                    dcp.save(state, storage_writer=writer, process_group=self.group,
                             no_dist=self.group is None)
                future = None
        del state

        def finish():
            if future is not None:
                with telemetry.span("ckpt_write", engine="sharded", path=path_s,
                                    metric="ckpt_sharded_write_s"):
                    future.result()
            handle.bytes = sum(p.stat().st_size for p in tmp.glob(f"__{process_index()}_*"))
            handle.write_s = time.monotonic() - t_write
            telemetry.watchdog.beat("ckpt_writer")
            if host0:
                self._publish(path, tmp, leaves, meta, max_keep, handle)

        if future is None:
            finish()
        else:
            def run():
                t_bg = time.monotonic()
                try:
                    finish()
                except BaseException as e:  # surfaced by wait()
                    handle.error = e
                finally:
                    handle.shadow_s = time.monotonic() - t_bg
                    telemetry.emit("ckpt_save_shadow", engine="sharded", path=path_s,
                                   shadow_s=round(handle.shadow_s, 4),
                                   ok=handle.error is None)

            handle._thread = threading.Thread(target=run, name="ckpt-sharded-writer",
                                              daemon=True)
            handle._thread.start()
            self._in_flight = handle
        handle.blocking_s = time.monotonic() - t0
        telemetry.emit("ckpt_save_blocking", engine="sharded", path=path_s,
                       blocking_s=round(handle.blocking_s, 4), background=background)
        return handle

    def _publish(self, path, tmp, leaves, meta, max_keep, handle):
        """Host 0, after every rank's files: the digests (read back), the
        meta, the atomic rename, retention."""
        path_s = str(path)
        meta["leaf_digests"] = param_digests(tmp, leaves)
        meta_b = json.dumps(meta).encode()

        def meta_once():
            faults.check("ckpt_fsync", path=path_s)
            with open(tmp / META_NAME, "wb") as f:
                f.write(meta_b)
                f.flush()
                os.fsync(f.fileno())  # durable before the publish; DCP synced its files

        with telemetry.span("ckpt_fsync", engine="sharded", metric="ckpt_sharded_fsync_s"):
            io_retry(meta_once, op="fsync", path=path_s)

        def rename_once():
            faults.check("ckpt_rename", path=path_s)
            if path.exists():  # a save of the same step from an earlier attempt
                shutil.rmtree(path)
            os.replace(tmp, path)

        with telemetry.span("ckpt_rename", engine="sharded", metric="ckpt_sharded_commit_s"):
            io_retry(rename_once, op="rename", path=path_s)
        faults.check("ckpt_commit", engine="sharded", path=path_s)
        total = sum(p.stat().st_size for p in path.iterdir() if p.is_file())
        telemetry.emit("ckpt_commit", engine="sharded", path=path_s, bytes=total,
                       write_s=round(handle.write_s, 4), checksum=True)
        if max_keep:
            prune_checkpoints(path.parent, max_keep, engine="sharded")

    def wait(self):
        """Block until the save in flight, if any, is durable (re-raising
        its error)."""
        handle, self._in_flight = self._in_flight, None
        if handle is not None:
            t0 = time.monotonic()
            handle.wait()
            telemetry.emit("ckpt_save_durable", engine="sharded",
                           wait_s=round(time.monotonic() - t0, 4))

    def restore(self, path, leaves, *, verify=False):
        """Read the checkpoint at ``path`` into ``leaves`` (its tensors in
        place, its numpy leaves from the meta), on every rank together.
        With ``verify`` the ``.params`` digests are checked on host 0.
        Returns the meta."""
        import torch.distributed.checkpoint as dcp

        path = Path(path).absolute()
        path_s = str(path)
        t0 = time.monotonic()
        telemetry.emit("ckpt_restore_start", engine="sharded", path=path_s)
        meta = read_meta(path)
        _check_structure(meta, leaves, path)
        io_retry(lambda: faults.check("ckpt_read", path=path_s), op="read", path=path_s)
        with telemetry.span("ckpt_read", engine="sharded", path=path_s,
                            metric="ckpt_sharded_read_s"):
            reader = dcp.FileSystemReader(path_s)
            sd, copies = _read_plan(leaves, set(reader.read_metadata().state_dict_metadata))
            dcp.load(sd, storage_reader=reader, process_group=self.group,
                     no_dist=self.group is None)
            with torch.no_grad():
                for part, tbox, piece, sbox, inter in copies:
                    _view(part, inter, tbox).copy_(_view(piece, inter, sbox))
        host = meta.get("host_leaves", {})
        for leaf in leaves:
            if not _is_tensor_leaf(leaf):
                saved = host[leaf.path]
                leaf.parts[0][...] = np.asarray(saved["value"], dtype=saved["dtype"])
        if verify and process_index() == 0 and not verify_param_digests(path, leaves):
            raise ValueError(f"params digest mismatch for {path}")
        telemetry.emit("ckpt_restore_done", engine="sharded", path=path_s,
                       seconds=round(time.monotonic() - t0, 4), verified=bool(verify),
                       step=int(meta.get("step", 0)))
        return meta

    def close(self):
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def precheck_ckpt_sharded(path, *, verify=False, target=None):
    """Integrity check of a sharded checkpoint directory before a load,
    host-local: the directory, its ``meta.json`` and DCP's ``.metadata``
    exist and parse, and every file the metadata names holds the bytes it
    says (a truncated shard fails); no tensor is read unless ``verify``,
    which also checks the ``.params`` digests (``target`` names the leaves).
    Returns ``(ok, reason)``. With ``target`` (a list of `Leaf`) it raises
    `CheckpointStructureError` when the checkpoint does not fit it."""
    import torch.distributed.checkpoint as dcp

    path = Path(path)
    try:
        if not path.is_dir():
            return False, "not a directory"
        if not (path / DCP_METADATA).exists():
            return False, "missing DCP .metadata (torn save?)"
        meta = read_meta(path)
        md = dcp.FileSystemReader(str(path)).read_metadata()
        ends = {}
        for info in md.storage_data.values():
            name = info.relative_path
            ends[name] = max(ends.get(name, 0), int(info.offset) + int(info.length))
        for name, end in ends.items():
            f = path / name
            if not f.exists():
                return False, f"missing shard file {name}"
            if f.stat().st_size < end:
                return False, f"truncated shard file {name} ({f.stat().st_size} < {end} bytes)"
        keys = set(md.state_dict_metadata)
    except Exception as e:
        return False, f"{type(e).__name__}: {e}"
    if target is not None:
        _check_structure(meta, target, path)
        try:
            _read_plan(target, keys, alloc=False)
        except CheckpointStructureError as e:
            raise CheckpointStructureError(
                f"checkpoint {path.name} does not fit the configured model: {e}") from None
        if verify and not verify_param_digests(path, target):
            return False, "params digest mismatch"
    return True, ""


def save_ckpt_sharded(path, leaves, sampler_state=None, *, max_keep=None, extra_meta=None):
    """One synchronous sharded save. Returns the seconds it blocked."""
    with ShardedCheckpointer(use_async=False) as ckptr:
        handle = ckptr.save(path, leaves, sampler_state, max_keep=max_keep,
                            extra_meta=extra_meta)
    log_host0("Sharded checkpoint saved to %s", path)
    return handle.blocking_s


def load_ckpt_sharded(path, leaves, *, verify=False):
    """Restore the sharded checkpoint at ``path`` into ``leaves``; returns
    the meta."""
    with ShardedCheckpointer(use_async=False) as ckptr:
        return ckptr.restore(path, leaves, verify=verify)
