"""Checkpoint schema manifests and findings: the port's copies of what the
JAX package's ``analysis/shardcheck/manifest.py`` (``state_manifest``,
``manifest_from_ckpt_meta``) and ``checks.py``
(``make_finding`` and the two catalog entries the elastic preflight
raises) provide, reduced to what the port's `Leaf` lists
carry.

A manifest is a JSON record of a state's schema, without tensor data::

    {"schema": 1, "num_leaves": N,
     "leaves": [{"path": ".params['tok_embed']", "shape": [32768, 2048],
                 "dtype": "float32", "spec": [null, null]}, ...]}

``spec`` entries mirror PartitionSpec entries: ``null`` (a replicated
dimension), an axis name or a list of names; ``spec: null`` means unknown.
The port's parameters are replicated on every rank (DDP), so a leaf's spec
is a ``null`` a dimension, but for the ZeRO-1 moments and the int8
residual, which carry the data axis.
"""

import dataclasses

MANIFEST_SCHEMA_VERSION = 1

# check id -> (name, severity): the JAX package's catalog entries
CHECKS = {
    "SC05": ("hbm-over-budget", "error"),
    "SC11": ("reshard-infeasible", "error"),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One finding, with the JAX package's fields."""

    rule: str
    rule_id: str
    severity: str
    path: str
    line: int
    col: int
    message: str


def make_finding(check_id, locus, message):
    name, severity = CHECKS[check_id]
    return Finding(rule=name, rule_id=check_id, severity=severity, path=locus, line=0,
                   col=0, message=message)


def replicated_spec(ndim):
    """The JSON spec of a leaf replicated on every dimension (the JAX
    package's ``spec_to_json(P(None, ...))``)."""
    return [None] * int(ndim)


def state_manifest(leaves):
    """The manifest of a list of `Leaf`: each leaf's spec, replicated where
    it has none."""
    out = [{"path": leaf.path, "shape": [int(s) for s in leaf.shape], "dtype": leaf.dtype,
            "spec": list(leaf.spec) if leaf.spec is not None
            else replicated_spec(len(leaf.shape))} for leaf in leaves]
    return {"schema": MANIFEST_SCHEMA_VERSION, "num_leaves": len(out), "leaves": out}


def manifest_from_ckpt_meta(meta):
    """A checkpoint meta's manifest: the embedded one (zerostall and the JAX
    package's files), else one without specs from its ``paths`` and
    ``leaves`` (the port's vanilla and sharded metas)."""
    if "manifest" in meta:
        return meta["manifest"]
    paths = meta.get("paths") or [f"leaf{i}" for i in range(meta.get("num_leaves", 0))]
    leaves = [{"path": p, "shape": list(lm["shape"]), "dtype": lm["dtype"], "spec": None}
              for p, lm in zip(paths, meta.get("leaves", []))]
    return {"schema": 0, "num_leaves": len(leaves), "leaves": leaves}
