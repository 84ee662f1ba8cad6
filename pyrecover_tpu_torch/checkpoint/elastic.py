"""Topology-elastic restore (the JAX package's ``checkpoint/elastic.py``):
any checkpoint onto the live group, planned from metadata alone.

A job stopped at one data-parallel size must not crash-loop until the same
capacity returns: it resumes at whatever size it has. The manifest and the
``topology`` record each engine saves carry what this takes, without
reading tensor data:

  * `compute_reshard_plan`: for every leaf, the saved shard grid (the
    manifest's spec on the saved mesh) against the target grid (the live
    spec on the target mesh), the per-dimension mapping (keep / split /
    concat / regrid), the saved shards each target shard reads, and the
    bytes that move. Under data parallelism alone the port's parameters
    are replicated on every rank (DDP) and its live specs
    (`live_target_specs`) shard only the ZeRO-1 moments and the int8
    residual over the data axis; on an fsdp, tensor or expert mesh every
    parameter and moment carries its rule, so a resume onto another mesh
    regrids those too. Any change of topology moves every byte onto a new
    placement.
  * `preflight_elastic`: the gate before any restore I/O. SC11
    ``reshard-infeasible`` for a leaf the target grid cannot divide and for
    a sampler that cannot split its global batch over the target replicas;
    SC05 ``hbm-over-budget`` when the state's bytes per device exceed the
    budget: ``$PYRECOVER_HBM_BYTES`` when set, else 0.9 of the card's
    memory for a CUDA target, and no check on the CPU (as the JAX package
    skips SC05 where it knows no capacity).
  * `resume_gate`: host 0's verdict on one resume candidate (``GATE_*``).
  * `TopologyMismatchError`: what ``--elastic-resume off`` raises, naming
    both topologies.

The engines execute the plan: the vanilla and zerostall engines restore the
whole leaves and each rank keeps its slice; the sharded engine reads, for
each rank's slice, the saved pieces that overlap it. ``train._resume`` wraps that in a ``reshard`` span and
an ``elastic_resume`` event with the plan's accounting.
"""

import dataclasses
import json
import os
from pathlib import Path

import numpy as np

from pyrecover_tpu_torch.checkpoint.manifest import (
    make_finding,
    manifest_from_ckpt_meta,
    replicated_spec,
)


class TopologyMismatchError(RuntimeError):
    """The checkpoint was saved on another topology than the live one and
    elastic resume is off (or cannot proceed). Names both topologies."""

    def __init__(self, saved=None, target=None, path=None, detail="", message=None):
        self.saved_topology = saved
        self.target_topology = target
        self.path = str(path) if path is not None else None
        if message is None:
            where = f"checkpoint {Path(path).name}" if path is not None else "checkpoint"
            message = (f"{where} was saved on {describe_topology(saved)} but this run is on "
                       f"{describe_topology(target)}")
            if detail:
                message += f": {detail}"
            else:
                message += (" — rerun with --elastic-resume auto to reshard onto the live "
                            "mesh, or restore matching capacity")
        super().__init__(message)


def describe_topology(topo):
    """'2 devices (data2, 2 processes)'; tolerates None and partial records."""
    if not topo:
        return "an unrecorded topology (legacy checkpoint)"
    mesh = topo.get("mesh")
    nontrivial = "×".join(f"{k}{v}" for k, v in mesh.items() if int(v) > 1) if mesh else ""
    procs = topo.get("processes")
    parts = [nontrivial or "single-axis mesh" if mesh else "mesh unrecorded"]
    if procs:
        parts.append(f"{procs} process{'es' if procs != 1 else ''}")
    return f"{topo.get('devices', '?')} devices ({', '.join(parts)})"


def topologies_differ(saved, target):
    """True when the saved topology is known and differs from the live one
    (device count or the mesh's axes above 1). An unknown saved topology
    compares as the same: there is nothing to diff."""
    if not saved or not target:
        return False
    if int(saved.get("devices", 0)) != int(target.get("devices", 0)):
        return True
    sm, tm = saved.get("mesh"), target.get("mesh")
    if sm and tm:
        def nontrivial(m):
            return {k: int(v) for k, v in m.items() if int(v) != 1}

        return nontrivial(sm) != nontrivial(tm)
    return False


def read_saved_meta(path):
    """The metadata the gate needs, never tensor data: a vanilla file's
    header, a sharded directory's ``meta.json``, a zerostall manifest."""
    path = Path(path)
    if path.is_dir():
        from pyrecover_tpu_torch.checkpoint.sharded import META_NAME

        meta_file = path / META_NAME
        return json.loads(meta_file.read_text()) if meta_file.exists() else {}
    from pyrecover_tpu_torch.checkpoint.registry import ZEROSTALL_SUFFIX

    if path.name.endswith(ZEROSTALL_SUFFIX):
        return json.loads(path.read_text())
    from pyrecover_tpu_torch.checkpoint.vanilla import read_ckpt_meta

    return read_ckpt_meta(path)


def saved_residual_shape(path):
    """The shape of the checkpoint's ``.grad_residual`` leaf (the int8
    error-feedback residual, the state's last leaf), or None when it has
    none or its metadata does not read (the pre-check judges that)."""
    try:
        meta = read_saved_meta(path)
    except Exception:
        return None
    entries = meta.get("leaves") or []
    paths = meta.get("paths") or [e.get("path") for e in entries]  # a zerostall manifest's
    if not paths or paths[-1] != ".grad_residual":
        return None
    return [int(n) for n in entries[-1]["shape"]]


# ---- the reshard plan (metadata only) --------------------------------------


@dataclasses.dataclass
class LeafPlan:
    """Source-to-target shard mapping of one leaf."""

    path: str
    shape: tuple
    dtype: str
    nbytes: int
    saved_spec: object
    target_spec: object
    src_grid: tuple  # shard counts a dimension
    tgt_grid: tuple
    ops: tuple  # a dimension: "keep" / "split a→b" / "concat a→b" / "regrid a→b"
    reads_per_shard: int  # saved shards each target shard reads
    moved_bytes: int
    error: str = None

    @property
    def resharded(self):
        return self.error is None and self.src_grid != self.tgt_grid

    def as_dict(self):
        d = dataclasses.asdict(self)
        for key in ("shape", "src_grid", "tgt_grid", "ops"):
            d[key] = list(d[key])
        return d


@dataclasses.dataclass
class ReshardPlan:
    saved_topology: dict
    target_topology: dict
    leaves: list
    sampler: dict = dataclasses.field(default_factory=dict)

    @property
    def errors(self):
        return [lp for lp in self.leaves if lp.error is not None]

    @property
    def feasible(self):
        return not self.errors and not self.sampler.get("error")

    @property
    def resharded_leaves(self):
        return sum(1 for lp in self.leaves if lp.resharded)

    @property
    def bytes_moved(self):
        return sum(lp.moved_bytes for lp in self.leaves)

    @property
    def total_bytes(self):
        return sum(lp.nbytes for lp in self.leaves)

    def as_dict(self):
        return {
            "saved_topology": self.saved_topology, "target_topology": self.target_topology,
            "resharded_leaves": self.resharded_leaves, "bytes_moved": self.bytes_moved,
            "total_bytes": self.total_bytes, "feasible": self.feasible,
            "sampler": self.sampler, "leaves": [lp.as_dict() for lp in self.leaves],
        }


def _spec_dim_factors(spec_json, ndim, mesh_shape):
    """Shard counts a dimension that a JSON spec induces on ``mesh_shape``;
    an unknown spec is unsharded."""
    factors = [1] * ndim
    if not spec_json:
        return tuple(factors)
    for dim, entry in enumerate(spec_json[:ndim]):
        axes = [] if entry is None else [entry] if isinstance(entry, str) else list(entry)
        for a in axes:
            factors[dim] *= int(mesh_shape.get(a, 1))
    return tuple(factors)


def _dim_op(s, t):
    if s == t:
        return "keep"
    if t > s and t % s == 0:
        return f"split {s}→{t}"
    if s > t and s % t == 0:
        return f"concat {s}→{t}"
    return f"regrid {s}→{t}"


def _dim_reads(s, t):
    """The most source shards one target shard overlaps along a dimension."""
    if s <= 1:
        return 1
    return max(-(-((j + 1) * s) // t) - (j * s) // t for j in range(t))


def _itemsize(dtype):
    return 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize


def _entry_nbytes(entry):
    count = int(np.prod(entry["shape"], dtype=np.int64)) if entry["shape"] else 1
    return count * _itemsize(entry["dtype"])


def compute_reshard_plan(manifest, saved_topology, target_topology, *, target_specs=None):
    """The per-leaf reshard plan of a manifest. ``target_specs`` maps a leaf
    path to its target JSON spec; a leaf it does not name is replicated (the
    port's layout under data parallelism alone). An infeasible leaf carries ``error`` instead of
    raising, so the preflight reports all of them."""
    saved_mesh = (saved_topology or {}).get("mesh") or {}
    target_mesh = (target_topology or {}).get("mesh") or {}
    same_topology = not topologies_differ(saved_topology, target_topology)
    leaves = []
    for entry in manifest.get("leaves", []):
        shape = tuple(int(s) for s in entry["shape"])
        ndim = len(shape)
        nbytes = _entry_nbytes(entry)
        tgt_spec = (target_specs or {}).get(entry["path"], replicated_spec(ndim))
        src_grid = _spec_dim_factors(entry.get("spec"), ndim, saved_mesh)
        tgt_grid = _spec_dim_factors(tgt_spec, ndim, target_mesh)
        error = None
        for dim in range(ndim):
            if tgt_grid[dim] > 1 and shape[dim] % tgt_grid[dim] != 0:
                error = (f"dim {dim} of {shape} not divisible by the target grid's "
                         f"{tgt_grid[dim]} shards")
                break
        reads = 1
        for s, t in zip(src_grid, tgt_grid):
            reads *= _dim_reads(s, t)
        # bytes re-placed: none only when the grid and the topology are
        # unchanged; any change re-reads the leaf into its new placement
        moved = 0 if (same_topology and src_grid == tgt_grid) or error else nbytes
        leaves.append(LeafPlan(
            path=entry["path"], shape=shape, dtype=entry["dtype"], nbytes=nbytes,
            saved_spec=entry.get("spec"), target_spec=tgt_spec, src_grid=src_grid,
            tgt_grid=tgt_grid, ops=tuple(_dim_op(s, t) for s, t in zip(src_grid, tgt_grid)),
            reads_per_shard=reads, moved_bytes=moved, error=error,
        ))
    return ReshardPlan(saved_topology=saved_topology or {},
                       target_topology=target_topology or {}, leaves=leaves)


# ---- the preflight ---------------------------------------------------------

# the per-device budget in bytes; without it the budget is 0.9 of the
# card's memory for a CUDA target and SC05 is skipped on the CPU
HBM_BYTES_ENV = "PYRECOVER_HBM_BYTES"


def _sampler_rescale_check(sampler_state, target_topology):
    """Feasibility and accounting of the sampler's rescale: the plan's
    ``sampler`` dict, with ``error`` when infeasible."""
    mesh = (target_topology or {}).get("mesh") or {}
    batch_shards = int(mesh.get("data", 1)) * int(mesh.get("fsdp", 1))
    processes = int((target_topology or {}).get("processes") or 1)
    info = {
        "saved_replicas": int(sampler_state.get("replicas", 1) or 1),
        "target_replicas": batch_shards,
        "target_processes": processes,
    }
    gbs = sampler_state.get("global_batch_size")
    if gbs is None:
        return info  # a legacy sampler record: nothing to prove against
    gbs = int(gbs)
    for n, what in ((batch_shards, "batch-sharding replicas"), (processes, "host processes")):
        if n > 1 and gbs % n != 0:
            info["error"] = (f"global batch size {gbs} not divisible by {n} {what} on the "
                             "target mesh — the sampler cannot split batches evenly, samples "
                             "would be skipped or double-consumed")
            return info
    if batch_shards != info["saved_replicas"]:
        from pyrecover_tpu_torch.data.sampler import rescale_sampler_state

        try:
            # the merge/split round trip proves the global cursor is kept
            rescale_sampler_state({**sampler_state,
                                   "cursor": int(sampler_state.get("cursor", 0)),
                                   "global_batch_size": gbs}, batch_shards)
        except (ValueError, KeyError) as e:
            info["error"] = f"sampler rescale infeasible: {e}"
    return info


def live_target_specs(leaves):
    """``{leaf path: JSON spec}`` of the live state (JAX ``:360-372``): a
    leaf's own spec where it has one (the ZeRO-1 moments, data-sharded
    where the data width divides them, and the int8 residual, its rows on
    the data axis), else replicated."""
    return {leaf.path: list(leaf.spec) if leaf.spec is not None
            else replicated_spec(len(leaf.shape)) for leaf in leaves}


def hbm_budget(device=None, fraction=0.9):
    """The SC05 budget in bytes: ``$PYRECOVER_HBM_BYTES``, else ``fraction``
    of a CUDA device's memory, else None (no check)."""
    override = os.environ.get(HBM_BYTES_ENV)
    if override:
        return int(override)
    if device is not None and getattr(device, "type", str(device)) == "cuda":
        import torch

        return int(torch.cuda.get_device_properties(device).total_memory * fraction)
    return None


def preflight_elastic(manifest, saved_topology, target_topology, *, sampler_state=None,
                      device=None, hbm_budget_fraction=0.9, locus="checkpoint",
                      target_specs=None):
    """The gate before a restore. Returns ``(findings, plan)``; no findings
    means the restore may go ahead. SC11 for each leaf the target grid cannot
    divide and for a sampler that cannot rescale; SC05 when the state's
    bytes per target device (a lower bound: no activations) exceed the
    budget of `hbm_budget` for ``device``."""
    plan = compute_reshard_plan(manifest, saved_topology, target_topology,
                                target_specs=target_specs)
    findings = [make_finding("SC11", locus, f"{lp.path}: {lp.error} (spec {lp.target_spec})")
                for lp in plan.errors[:8]]
    if len(plan.errors) > 8:
        findings.append(make_finding(
            "SC11", locus, f"...and {len(plan.errors) - 8} more infeasible leaves"))
    if sampler_state is not None:
        plan.sampler = _sampler_rescale_check(sampler_state, target_topology)
        if plan.sampler.get("error"):
            findings.append(make_finding("SC11", locus, plan.sampler["error"]))
    budget = hbm_budget(device, hbm_budget_fraction)
    if budget is not None:
        per_device = sum(lp.nbytes // max(int(np.prod(lp.tgt_grid)), 1) for lp in plan.leaves)
        plan.sampler.setdefault("hbm_state_bytes", per_device)
        if per_device > budget:
            findings.append(make_finding(
                "SC05", locus,
                f"restored state alone needs {per_device / 2**30:.2f} GiB/device on the "
                f"target mesh, over the {budget / 2**30:.2f} GiB budget — this checkpoint "
                "cannot fit the shrunken capacity"))
    return findings, plan


# ---- the resume gate (host 0's side of train._resume) ----------------------

GATE_OK = "ok"  # same topology (or nothing to diff): a plain restore
GATE_ELASTIC = "elastic"  # the topology differs and the plan is feasible
GATE_INFEASIBLE = "infeasible"  # the preflight rejected it: fall back, no quarantine
GATE_MISMATCH = "mismatch"  # the topology differs and --elastic-resume is off


def resume_gate(mode, path, target_leaves, target_topology, *, device=None, locus=None):
    """Host 0's elastic gate for one resume candidate: ``(gate, reason,
    plan)``, ``gate`` one of the ``GATE_*``. Never raises on unreadable
    metadata: integrity is the pre-check's business."""
    try:
        meta = read_saved_meta(path)
    except Exception:
        return GATE_OK, "", None
    saved_topo = meta.get("topology")
    differs = topologies_differ(saved_topo, target_topology)
    if not differs and mode != "on":
        return GATE_OK, "", None
    if mode == "off":
        return GATE_MISMATCH, str(TopologyMismatchError(saved_topo, target_topology,
                                                        path=path)), None
    findings, plan = preflight_elastic(
        manifest_from_ckpt_meta(meta), saved_topo, target_topology,
        sampler_state=meta.get("sampler") or {}, device=device,
        locus=locus or Path(path).name, target_specs=live_target_specs(target_leaves))
    if findings:
        reason = "; ".join(f"{f.rule_id}: {f.message}" for f in findings[:3])
        if len(findings) > 3:
            reason += f" (+{len(findings) - 3} more)"
        return GATE_INFEASIBLE, reason, plan
    return (GATE_ELASTIC if differs else GATE_OK), "", plan


# ---- rendering -------------------------------------------------------------


def _human(n):
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if n < 1024:
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}PB"


def render_plan(plan, out, *, leaves=True):
    """Write a reshard plan as the JAX package's ``inspect_checkpoint
    --reshard-plan`` shows it."""
    w = out.write
    w(f"reshard plan: {describe_topology(plan.saved_topology)} -> "
      f"{describe_topology(plan.target_topology)}\n")
    if leaves:
        for lp in plan.leaves:
            if lp.error is not None:
                w(f"  {lp.path}: INFEASIBLE — {lp.error}\n")
                continue
            grid = f"{'×'.join(map(str, lp.src_grid))} -> {'×'.join(map(str, lp.tgt_grid))}"
            ops = ", ".join(o for o in lp.ops if o != "keep") or "keep"
            w(f"  {lp.path}: {lp.dtype} {lp.shape} grid {grid} [{ops}] reads "
              f"{lp.reads_per_shard} shard(s)/target, {_human(lp.moved_bytes)} moved\n")
    verdict = "feasible" if plan.feasible else (
        f"INFEASIBLE ({len(plan.errors)} leaves"
        + (", sampler" if plan.sampler.get("error") else "") + ")")
    w(f"total: {len(plan.leaves)} leaves, {plan.resharded_leaves} resharded, "
      f"{_human(plan.bytes_moved)} of {_human(plan.total_bytes)} moved — {verdict}\n")
    if plan.sampler.get("error"):
        w(f"  sampler: {plan.sampler['error']}\n")
    elif plan.sampler:
        w(f"  sampler: {plan.sampler.get('saved_replicas', '?')} -> "
          f"{plan.sampler.get('target_replicas', '?')} data-parallel replicas (global order "
          "preserved)\n")
