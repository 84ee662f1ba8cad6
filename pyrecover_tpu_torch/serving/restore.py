"""Read-only weight restore for serving, ported from the JAX package's
``serving/restore.py`` for vanilla checkpoints.

The engine needs exactly the ``.params`` leaves of a training checkpoint: no
optimizer moments, no RNG, no counters. `load_serving_params` checks the
file's checksum sidecar before it decodes anything, then reads the
``.params`` frames of the ``PYRCKPT2`` file a leaf at a time into a
``Transformer`` on the device; the ``mu``/``nu`` frames, two thirds of the
file, are skipped unread.

Serving weights are read-only, so each matrix (``tok_embed``, ``output``
and every layer's ``wq``/``wk``/``wv``/``wo``/``w1``/``w3``/``w2``) is stored
in the compute dtype, cast once here as the restore copies it in, instead of
at every use of every step; the forward's casts are then no-ops and compute
the same values. The RMSNorm scales keep the parameter dtype, since the
forward reads them in fp32.

The read is a ``serving_restore`` span and ends in a ``weights_loaded``
event, as in the JAX package. The JAX package's sharded and zerostall
readers, serving meshes and the elastic preflight (SC05/SC11) are not
ported: sharded and zerostall paths raise ``NotImplementedError``.
"""

import time
from pathlib import Path

import torch
from torch import nn

from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.checkpoint.registry import engine_of
from pyrecover_tpu_torch.checkpoint.vanilla import (
    CheckpointStructureError,
    _leaf_nbytes,
    _sidecar,
    load_subset_vanilla,
    read_ckpt_meta,
    verify_checksum,
)
from pyrecover_tpu_torch.models.llama import Transformer
from pyrecover_tpu_torch.train_state import param_leaves
from pyrecover_tpu_torch.utils.device import resolve_device
from pyrecover_tpu_torch.utils.dtypes import resolve_dtype

PARAMS_PREFIX = ".params"
# the parameters the forward only ever reads cast to the compute dtype
MATRIX_KEYS = ("tok_embed", "output", "wq", "wk", "wv", "wo", "w1", "w3", "w2")


class ServingRestoreError(RuntimeError):
    """The checkpoint cannot serve: it fails its checksum sidecar, carries
    no ``.params`` leaves, or does not fit the model."""


def serving_model(model_config, device):
    """An uninitialised, frozen ``Transformer`` on ``device`` whose matrices
    are in the compute dtype and whose norm scales are in the parameter
    dtype."""
    cdt = resolve_dtype(model_config.compute_dtype)
    model = Transformer(model_config, device="meta")
    for module in (model, *model.layers):
        for name, p in list(module.named_parameters(recurse=False)):
            if name in MATRIX_KEYS:
                setattr(module, name, nn.Parameter(torch.empty(p.shape, dtype=cdt, device="meta")))
    return model.to_empty(device=device).requires_grad_(False)


def load_serving_params(path, model_config, *, device="cuda"):
    """Restore the ``.params`` leaves of the vanilla checkpoint at ``path``
    into a serving model (`serving_model`) on ``device`` (the card unless
    ``cpu`` is asked for; with no card it raises).

    Returns ``(model, info)``; ``info`` holds the ``engine``, the
    checkpoint's ``step``, the ``leaves`` and ``bytes`` read, the sidecar's
    ``checksum`` scheme (None without a sidecar) and the ``seconds`` taken.
    Raises `ServingRestoreError` when the sidecar does not match, the file
    has no ``.params`` leaves, or they do not fit ``model_config``."""
    path = Path(path)
    t0 = time.monotonic()
    device = resolve_device(device)
    engine = engine_of(path)
    if engine != "vanilla":
        raise NotImplementedError(
            f"serving from {engine} checkpoints is not ported yet; the port serves from "
            "vanilla PYRCKPT2 files"
        )
    # a flipped byte inside a tensor frame decodes silently: when the save
    # left a sidecar, verify it before any leaf is decoded
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
    meta = read_ckpt_meta(path)
    entries = [lm for p, lm in zip(meta.get("paths") or [], meta["leaves"])
               if p.startswith(PARAMS_PREFIX)]
    if not entries:
        raise ServingRestoreError(
            f"checkpoint {path.name} carries no .params leaves — not a training-state "
            "checkpoint this engine can serve from"
        )
    with telemetry.span("serving_restore", engine=engine, path=str(path),
                        metric="serving_restore_s"):
        model = serving_model(model_config, device)
        try:
            load_subset_vanilla(path, param_leaves(model), PARAMS_PREFIX)
        except CheckpointStructureError as e:
            raise ServingRestoreError(str(e)) from e
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    nbytes = sum(_leaf_nbytes(lm) for lm in entries)
    info = {
        "engine": engine, "step": int(meta.get("step", 0)), "leaves": len(entries),
        "bytes": nbytes, "checksum": checksum, "seconds": time.monotonic() - t0,
    }
    telemetry.emit("weights_loaded", path=str(path), engine=engine, step=info["step"],
                   leaves=info["leaves"], bytes=nbytes, seconds=round(info["seconds"], 4))
    return model, info
