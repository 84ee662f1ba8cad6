"""Read-only weight restore for serving (the JAX package's
``serving/restore.py``): the ``.params`` leaves of a checkpoint of any
engine, placed on the serving device.

The engine needs exactly the ``.params`` leaves of a training checkpoint: no
optimizer moments, no RNG, no counters. `load_serving_params` reads the
checkpoint's metadata without tensor data (``elastic.read_saved_meta``),
runs the elastic preflight on the params' plan for the serving topology (one
device: SC11 infeasible grids, SC05 over the card's memory) before any
tensor is read, and then reads the leaves a leaf at a time into a
``Transformer`` on the device, by engine:

  * vanilla: the file's checksum sidecar is checked first, then only the
    ``.params`` frames of the ``PYRCKPT2`` file are read (the ``mu``/``nu``
    frames, two thirds of the file, are skipped unread);
  * zerostall: only the ``.params`` leaves of the manifest are assembled,
    every chunk's digest verified as it is read;
  * sharded: a ``torch.distributed.checkpoint`` load of the ``.params``
    tensors alone into host memory, each leaf checked against the
    ``leaf_digests`` the save recorded before anything is placed (DCP's
    read verifies no content of its own).

Serving weights are read-only, so each matrix (``tok_embed``, ``output``
and every layer's ``wq``/``wk``/``wv``/``wo``/``w1``/``w3``/``w2``, or an
MoE layer's ``moe_w1``/``moe_w3``/``moe_w2``) is stored in the compute
dtype, cast once here as the restore copies it in, instead of at every use
of every step; the forward's casts are then no-ops and compute the same
values. The RMSNorm scales keep the parameter dtype, since the forward
reads them in fp32, and an MoE router stays fp32, as it trains: the model
of ``model_config`` (``n_experts`` > 0 for an MoE checkpoint) must have the
checkpoint's leaves, or the restore raises before it reads a tensor.

The read is a ``serving_restore`` span and ends in a ``weights_loaded``
event with the plan's accounting, as in the JAX package. A checkpoint
trained on an fsdp, tensor or expert mesh serves as any other: the vanilla and
zerostall files hold whole leaves, and the sharded engine's slices are
assembled whole on the read. Serving meshes (a model sharded over several
cards while it serves) are not ported.
"""

import time
from pathlib import Path

import torch
from torch import nn

from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.checkpoint.elastic import preflight_elastic, read_saved_meta
from pyrecover_tpu_torch.checkpoint.manifest import manifest_from_ckpt_meta
from pyrecover_tpu_torch.checkpoint.registry import engine_of
from pyrecover_tpu_torch.checkpoint.vanilla import (
    CheckpointStructureError,
    _check_structure,
    _restore,
    _sidecar,
    load_subset_vanilla,
    verify_checksum,
)
from pyrecover_tpu_torch.models.llama import Transformer
from pyrecover_tpu_torch.train_state import param_leaves
from pyrecover_tpu_torch.utils.device import resolve_device
from pyrecover_tpu_torch.utils.dtypes import resolve_dtype

PARAMS_PREFIX = ".params"
# the parameters the forward only ever reads cast to the compute dtype
MATRIX_KEYS = ("tok_embed", "output", "wq", "wk", "wv", "wo", "w1", "w3", "w2", "moe_w1",
               "moe_w3", "moe_w2")


class ServingRestoreError(RuntimeError):
    """The checkpoint cannot serve: it fails its checksum sidecar, carries
    no ``.params`` leaves, or does not fit the model."""


def serving_model(model_config, device):
    """An uninitialised, frozen ``Transformer`` on ``device`` whose matrices
    are in the compute dtype, whose norm scales are in the parameter dtype
    and whose MoE routers (if any) are fp32."""
    cdt = resolve_dtype(model_config.compute_dtype)
    model = Transformer(model_config, device="meta")
    # each parameter allocated on the device as it is (``to_empty`` would
    # send every one through meta dispatch, seconds of a process's start)
    for module in (model, *model.layers):
        for name, p in list(module.named_parameters(recurse=False)):
            dtype = cdt if name in MATRIX_KEYS else p.dtype
            setattr(module, name, nn.Parameter(torch.empty(p.shape, dtype=dtype, device=device),
                                               requires_grad=False))
    return model


def _vanilla_sidecar(path):
    """Check a vanilla file's checksum sidecar, if the save left one: a
    flipped byte inside a tensor frame decodes silently. Returns the
    scheme, or None without a sidecar."""
    checksum = None
    sidecar = _sidecar(path)
    if sidecar.exists():
        expected = sidecar.read_text().strip()
        if expected:
            if not verify_checksum(path, expected):
                raise ServingRestoreError(
                    f"checkpoint {path.name} fails its checksum sidecar — file tampered or "
                    "bit-flipped after save; refusing to serve from it"
                )
            checksum = expected.split(":", 1)[0]
    return checksum


def _read_params_vanilla(path, target, host_bytes):
    load_subset_vanilla(path, target, PARAMS_PREFIX)


def _read_params_zerostall(path, target, host_bytes):
    from pyrecover_tpu_torch.checkpoint.zerostall.chunkstore import (
        ChunkStore,
        assemble_leaf,
        read_manifest,
    )

    doc = read_manifest(path)
    entries = [e for e in doc["leaves"] if e["path"].startswith(PARAMS_PREFIX)]
    _check_structure({"paths": [e["path"] for e in entries],
                      "leaves": [{"dtype": e["dtype"], "shape": e["shape"]} for e in entries]},
                     target, path, warn_cast=False)
    store = ChunkStore(path.parent)
    for entry, leaf in zip(entries, target):
        try:
            raw = assemble_leaf(store, entry)
        except ValueError as e:  # a chunk's digest or size does not hold
            raise ServingRestoreError(f"checkpoint {path.name}: {e}; refusing to serve "
                                      "from it") from e
        _restore(leaf, torch.from_numpy(raw), entry["dtype"])
        if host_bytes is not None:
            host_bytes[entry["path"]] = raw


def _read_params_sharded(path, target, host_bytes):
    from pyrecover_tpu_torch.checkpoint.sharded import _leaf_digest, _read_back, read_meta
    from pyrecover_tpu_torch.checkpoint.vanilla import Leaf

    meta = read_meta(path)
    saved = {p: lm for p, lm in zip(meta["paths"], meta["leaves"])
             if p.startswith(PARAMS_PREFIX)}
    _check_structure({"paths": list(saved), "leaves": list(saved.values())}, target, path,
                     warn_cast=False)
    # the saved dtypes, read into host memory; nothing is placed before
    # every leaf's digest holds
    host = [Leaf(leaf.path, leaf.shape, saved[leaf.path]["dtype"], leaf.parts)
            for leaf in target]
    # whole leaves, assembled from the ranks' slices when the run was fsdp
    # or tensor sharded
    read = _read_back(path, host)
    digests = meta.get("leaf_digests") or {}
    for leaf in host:
        want = digests.get(leaf.path)
        if want is None or _leaf_digest(read[leaf.path]) != want:
            raise ServingRestoreError(
                f"checkpoint {path.name}: leaf {leaf.path} fails its recorded content digest — "
                "a shard file tampered or bit-flipped after save; refusing to serve from it")
    with torch.no_grad():
        for leaf in target:
            for part, src in zip(leaf.parts, read[leaf.path]):
                part.copy_(src)


_READERS = {"vanilla": _read_params_vanilla, "zerostall": _read_params_zerostall,
            "sharded": _read_params_sharded}


def serving_topology():
    """The serving placement's topology (the preflight's target): one device."""
    return {"devices": 1, "processes": 1, "mesh": {}}


def load_serving_params(path, model_config, *, device="cuda", host_bytes=None):
    """Restore the ``.params`` leaves of the checkpoint at ``path`` (any
    engine) into a serving model (`serving_model`) on ``device`` (the card
    unless ``cpu`` is asked for; with no card it raises). Given a dict as
    ``host_bytes``, a zerostall restore keeps each leaf's digest-verified
    bytes there, by manifest path: the hot-swapper's reuse cache
    (``serving/hotswap/``), seeded without reading the card back.

    Returns ``(model, info)``; ``info`` holds the ``engine``, the
    checkpoint's ``step``, the ``leaves`` and ``bytes`` read, the plan's
    ``resharded_leaves`` and ``plan_bytes_moved``, the ``checksum`` scheme
    checked (a vanilla sidecar's, ``blake2b-chunks`` or ``blake2b-leaves``;
    None for a vanilla file without a sidecar) and the ``seconds`` taken.
    Raises `ServingRestoreError` when the preflight rejects the plan, the
    checkpoint carries no ``.params`` leaves or does not fit
    ``model_config``, or a checksum or digest does not hold."""
    path = Path(path)
    t0 = time.monotonic()
    device = resolve_device(device)
    engine = engine_of(path)
    try:
        meta = read_saved_meta(path)
    except (OSError, ValueError) as e:
        raise ServingRestoreError(f"checkpoint {path.name} is unreadable: {e}") from e
    manifest = manifest_from_ckpt_meta(meta)
    entries = [e for e in manifest.get("leaves", []) if e["path"].startswith(PARAMS_PREFIX)]
    if not entries:
        raise ServingRestoreError(
            f"checkpoint {path.name} carries no .params leaves — not a training-state "
            "checkpoint this engine can serve from"
        )
    target_topology = serving_topology()
    findings, plan = preflight_elastic(
        {"schema": manifest.get("schema", 0), "num_leaves": len(entries), "leaves": entries},
        meta.get("topology"), target_topology, device=device, locus=f"serving:{path.name}")
    if findings:
        raise ServingRestoreError(
            f"checkpoint {path.name} cannot serve on {target_topology}: "
            + "; ".join(f"{f.rule_id}: {f.message}" for f in findings[:4]))
    # the vanilla sidecar before any model is built; the other engines check
    # each chunk or leaf as they read it, before it is placed
    checksum = {"vanilla": _vanilla_sidecar(path) if engine == "vanilla" else None,
                "zerostall": "blake2b-chunks", "sharded": "blake2b-leaves"}[engine]
    with telemetry.span("serving_restore", engine=engine, path=str(path),
                        metric="serving_restore_s"):
        model = serving_model(model_config, device)
        try:
            _READERS[engine](path, param_leaves(model), host_bytes)
        except CheckpointStructureError as e:
            raise ServingRestoreError(str(e)) from e
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    info = {
        "engine": engine, "step": int(meta.get("step", 0)), "leaves": len(entries),
        "bytes": int(plan.total_bytes), "resharded_leaves": int(plan.resharded_leaves),
        "plan_bytes_moved": int(plan.bytes_moved), "checksum": checksum,
        "seconds": time.monotonic() - t0,
    }
    telemetry.emit("weights_loaded", path=str(path), engine=engine, step=info["step"],
                   leaves=info["leaves"], bytes=info["bytes"],
                   resharded_leaves=info["resharded_leaves"],
                   plan_bytes_moved=info["plan_bytes_moved"],
                   seconds=round(info["seconds"], 4), target_topology=target_topology)
    return model, info
